"""Fused factorized (2+1)D conv block: CUDA kernels and their plain version.

The port of ``cstp_tpu/ops/pallas/conv21d.py``: spatial (1,3,3) conv ->
BatchNorm with batch statistics -> ReLU -> temporal (3,1,1) conv, stride 1,
on NDHWC tensors, as two passes so the wide mid tensor never reaches device
memory in the forward pass. Each of the JAX op's two tilings has its pair of
kernels:

* ``tiling="clip"`` (``csrc/conv21d.cu``): ``run_stats`` (pass A,
  ``cstp_conv21d_stats``) gives the per BN group ``(G, M)`` mean and biased
  variance of the bf16-rounded spatial conv; ``run_fwd`` (pass B,
  ``cstp_conv21d_fwd``) recomputes the spatial conv, normalises, applies
  ReLU, rounds to bf16 and runs the temporal conv -> bf16 output. Both take
  the unpadded input and one K=9*Cin product per row tile, on one shared
  spatial mainloop, each with a launch plan computed here (``plan_stats``,
  ``plan_fwd``) and checked again in C.
* ``tiling="taps9"`` (the same library): ``run_stats_taps9`` and
  ``run_fwd_taps9`` launch the same two kernels on the input padded once
  (``pad_hw``), as the TPU kernels take it, with the plans of the unpadded
  shape; only the A gather's addressing differs, so on the same input they
  give bitwise the clip pair's results. Both pairs take Cin % 16.

The two tilings compute one function, so both pairs share one plain
version: ``reference_stats`` and ``reference_chain``.

``fused_st_conv`` is the ``torch.autograd.Function`` around them. Its
forward launches the chosen pair for CUDA tensors (in bf16, as the TPU
kernels cast) and runs the plain version for CPU tensors, in the input's
dtype. Its backward recomputes the plain chain with the statistics
recomputed inside, for either tiling, so gradients flow through the mean and
variance like a plain BatchNorm; the cotangents of the returned statistics
are dropped (they only feed the running-stat update).

``cross_rank`` (``--sync_bn 1`` under a process group): K2's per-group
statistics become the global batch's before K3 reads them, by small
all-reduces between the two launches (``global_stats``). The plain version
and the backward's recompute average the first and second moments over the
ranks (an autograd-aware all-reduce, as flax does over a sharded batch), so
every rank issues its collectives in the same order.

``spatial`` (``--shard_spatial``): ``x`` is this rank's H shard already
padded, ``(B, T, h + 2, W + 2, Cin)``: its neighbours' halo rows in H,
zeros at the frame's top and bottom and in W (``models/layers.py
SpatioTemporalConv``). On CUDA the taps9 pair (K4a/K4b) runs on it, and
the per-group moments of the shards are summed over the 'model' ranks
(and 'data' under ``cross_rank``), each weighted by its positions, between
the two launches; the plain version and the backward do the same on the
same padded shard, whose gradient then returns the halo rows' to their
owners.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from cstp_tpu_torch.ops import build
from cstp_tpu_torch.ops.bn import per_sample
from cstp_tpu_torch.parallel.mesh import (
    global_moments,
    is_distributed,
    stats_axis,
)

# launches per wrapper (one per call on CUDA tensors)
launches = {"stats": 0, "fwd": 0, "stats_taps9": 0, "fwd_taps9": 0}
TILINGS = ("clip", "taps9")


# ------------------------------------------------------------ plain version

def _spatial_conv(x, ws, dtype, padded: bool = False):
    """x (B, T, H, W, Cin), ws (kh, kw, Cin, M) -> (B, T, H, W, M) in dtype;
    ``padded``: x is (B, T, H + kh - 1, W + kw - 1, Cin), padded already."""
    w = ws.to(dtype).permute(3, 2, 0, 1).unsqueeze(2)           # (M,Cin,1,kh,kw)
    kh, kw = ws.shape[0], ws.shape[1]
    pad = (0, 0, 0) if padded else (0, (kh - 1) // 2, (kw - 1) // 2)
    y = F.conv3d(x.to(dtype).permute(0, 4, 1, 2, 3), w, padding=pad)
    return y.permute(0, 2, 3, 4, 1)


def reference_stats(x, ws, bn_groups: int, dtype=torch.bfloat16,
                    cross_rank: bool = False, spatial: bool = False,
                    padded: bool = False):
    """Per-group ``(G, M)`` mean / biased variance of the spatial conv,
    rounded to ``dtype``, by partial moments (``reference_stats``); with
    ``cross_rank`` over every rank's rows, with ``spatial`` (``x`` a padded
    H shard) over every 'model' rank's rows by their positions (the
    variance clipped at 0 in both). ``padded``: ``x`` is padded already,
    and the statistics are this rank's (K4a's on a shard)."""
    b = x.shape[0]
    g = bn_groups
    mid = _spatial_conv(x, ws, dtype, padded=spatial or padded).float()
    pmean = mid.mean(dim=(1, 2, 3))                             # (B, M)
    psq = mid.square().mean(dim=(1, 2, 3))
    m = pmean.reshape(g, b // g, -1).mean(dim=1)
    sq = psq.reshape(g, b // g, -1).mean(dim=1)
    axis = stats_axis(cross_rank, spatial)
    if axis:
        count = mid[0].numel() // mid.shape[-1] * (b // g)
        m, sq = global_moments(m, sq, axis=axis,
                               count=count if spatial else None)
        return m, torch.clamp(sq - m.square(), min=0.0)
    return m, sq - m.square()


def global_stats(gmean, gvar, axis: str = "data", count=None):
    """K2's or K4a's per-rank ``(G, M)`` mean and biased variance -> those
    over ``axis``'s ranks (each holding as many positions, or ``count``
    positions per group, weighted by them): the ranks' mean variance plus
    the variance of their means, in two small all-reduces. Going through
    ``var + mean^2`` instead loses the variance to cancellation where
    ``mean^2`` dwarfs it, which moved the bf16 update (cosine 0.982 to the
    step without a process group at world size 1 on an H100); this form is
    exact at world size 1."""
    m, v = global_moments(gmean, gvar, axis=axis, count=count)
    (between,) = global_moments((gmean - m).square(), axis=axis, count=count)
    return m, v + between


def reference_chain(x, ws, wt, scale, bias, gmean, gvar, bn_groups: int,
                    eps: float = 1e-5, dtype=torch.bfloat16,
                    padded: bool = False):
    """The unfused spatial -> BN(given group stats) -> ReLU -> temporal
    chain in ``dtype``; ``wt`` is (3, M, Cout); ``padded``: x is padded
    already in H and W."""
    b = x.shape[0]
    g = bn_groups
    mid = _spatial_conv(x, ws, dtype, padded)
    shape = (b, 1, 1, 1, -1)
    mean_b = per_sample(gmean, b, shape)
    rstd_b = torch.rsqrt(per_sample(gvar, b, shape) + eps)
    y = (mid.float() - mean_b) * rstd_b * scale + bias
    y = torch.relu(y).to(dtype)
    wt_o = wt.to(dtype).permute(2, 1, 0)[:, :, :, None, None]   # (Cout,M,3,1,1)
    out = F.conv3d(y.permute(0, 4, 1, 2, 3), wt_o, padding=(1, 0, 0))
    return out.permute(0, 2, 3, 4, 1)


def fused_st_conv_plain(x, ws, wt, scale, bias, bn_groups: int = 1,
                        eps: float = 1e-5, dtype=torch.bfloat16,
                        cross_rank: bool = False, spatial: bool = False):
    """Plain version of the two kernels: ``(out, gmean, gvar)``. With
    ``dtype=bfloat16`` it rounds where the kernels round (x, weights, the
    spatial-conv output, the post-ReLU mid, the output). ``spatial``: x is
    a padded H shard."""
    gmean, gvar = reference_stats(x, ws, bn_groups, dtype, cross_rank,
                                  spatial)
    out = reference_chain(x, ws, wt, scale, bias, gmean, gvar, bn_groups,
                          eps, dtype, padded=spatial)
    return out, gmean, gvar


# ------------------------------------------------------------ CUDA kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
_STATS_PLAN = ("P", "stages", "bn", "ni", "tpb", "blocks", "smem")
_STATS_SIG = ([_P] * 6 + [_I] * (7 + len(_STATS_PLAN)) + [_P], _I)
_FWD_PLAN = ("P", "stages", "ring_slots", "blocks", "cluster", "smem", "ni",
             "bn", "bno")
_FWD_SIG = ([_P] * 8 + [_I] * (8 + len(_FWD_PLAN)) + [_P], _I)
_OCC_SIG = ([_I, _I], _I)

# K3's launch plan (csrc/conv21d.cu checks it again): 256 threads, each warp
# a 32 x (8 * ni) accumulator tile of ni / 2 column pairs of 16, so a block
# tile of P in (128, 64, 32) rows has 256 / P warps across its columns; K
# steps of 64 rows. A cluster of C blocks shares a row tile: each holds 1/C
# of the mid channels in its ring and computes 1/C of the output channels.
SMEM_MAX = 232448
FWD_NI = (2, 4, 6, 10)          # the kernel's instantiations
FWD_P = (128, 64, 32)
FWD_CLUSTER = (1, 2, 4)
FWD_STAGES = (3, 4, 5, 6)
_KC = 64


def _align128(b):
    return -(-b // 128) * 128


def _fwd_smem(p, t, mc, ldb, stages):
    ring = _align128(2 * min(3, t) * p * (mc + 8))
    stage = _align128(_align128(2 * p * (_KC + 8)) + 2 * _KC * ldb)
    return ring + stages * stage


def _even_chunk(width, cap):
    """The width of ceil(width / cap) even chunks, a multiple of 16."""
    n = -(-width // cap)
    return -(-(width // 16) // n) * 16


def fwd_plans(n, t, h, w, cin, m, cout):
    """Every launch plan K3 takes for x (n, t, h, w, cin) -> mid m -> cout:
    for each row tile P (largest first) and cluster size (smallest first),
    the widest chunks of the block's mid and output slices whose ring of
    min(3, t) frames and stages fit the shared memory, at each stage count
    that fits. ``l2_bytes``: the bytes the blocks read from L2 per launch
    (each block's ws slice and A gather per mid frame and mid chunk, its wt
    slice per output frame and tap)."""
    plans = []
    for p in FWD_P:
        wn = 256 // p
        for c in FWD_CLUSTER:
            if m % (16 * c) or cout % (16 * c):
                continue
            for cap_ni in reversed(FWD_NI):
                bn = _even_chunk(m // c, 8 * cap_ni * wn)
                bno = _even_chunk(cout // c, 8 * cap_ni * wn)
                ldb = max(bn, bno) + 8
                stages = [s for s in FWD_STAGES
                          if _fwd_smem(p, t, m // c, ldb, s) <= SMEM_MAX]
                if not stages:
                    continue
                need = 2 * -(-max(bn, bno) // (16 * wn))
                blocks = -(-n * h * w // p)
                nch = -(-(m // c) // bn)
                taps = 1 if t == 1 else 3 * t - 2
                l2 = blocks * 2 * (t * (9 * cin * m + c * nch * p * 9 * cin)
                                   + taps * m * cout)
                plans += [dict(P=p, stages=s, ring_slots=min(3, t),
                               blocks=blocks, cluster=c,
                               smem=_fwd_smem(p, t, m // c, ldb, s),
                               ni=min(v for v in FWD_NI if v >= need), bn=bn,
                               bno=bno, l2_bytes=l2) for s in stages]
                break
    return plans


def plan_fwd(n, t, h, w, cin, m, cout):
    """K3's launch plan: of ``fwd_plans``, the largest row tile P and then
    the smallest cluster, among plans whose warp tiles are at least 32 x 48
    or whose chunks are the whole slices (else among all), with 4 stages
    where they fit, else 3. Each K step costs a fixed issue and barrier
    time, so rows per step count for more than blocks in the grid (PERF.md
    §6, ``python -m cstp_tpu_torch.perf.sweep_conv21d_fwd``). Raises
    ValueError for a shape no plan fits."""
    plans = [pl for pl in fwd_plans(n, t, h, w, cin, m, cout)
             if pl["stages"] <= 4]
    if not plans:
        raise ValueError(f"conv21d fwd: no plan fits {SMEM_MAX} bytes of "
                         f"shared memory for M={m}, Cout={cout}, T={t} (a "
                         "32-row ring with 3 stages does not)")
    wide = [pl for pl in plans if pl["ni"] >= 6 or (
        pl["bn"] == m // pl["cluster"] and pl["bno"] == cout // pl["cluster"])]
    first = (wide or plans)[0]
    return [pl for pl in plans
            if (pl["P"], pl["cluster"]) == (first["P"], first["cluster"])][-1]


def fwd_occupancy(plan):
    """Resident K3 blocks per SM for ``plan`` (needs the card)."""
    got = _lib().cstp_conv21d_fwd_occupancy(plan["ni"], plan["smem"])
    if got < 0:
        raise RuntimeError("cstp_conv21d_fwd_occupancy failed")
    return got


# K2's launch plan (csrc/conv21d.cu checks it again): K3's spatial mainloop
# (256 threads, P rows, K steps of 64, warp tiles of 32 x (8 * ni)) over
# the flat (frame, pixel) rows of one BN group and one mid chunk of bn
# channels per block; a block walks ``tpb`` row tiles. Shared memory is the
# stages alone, and they must leave room for two blocks per SM (the
# kernel's launch bound, which caps its registers at 128): plans with one
# block per SM measured slower at every site (PERF.md §6).
STATS_STAGES = (3, 4)
STATS_PER_SM = 2
SM_COUNT = 132                  # the H100 SXM's SMs
SMEM_SM = 233472                # one SM's shared memory; a block also takes 1 KB


def _stats_smem(p, bn, stages):
    return stages * _align128(_align128(2 * p * (_KC + 8)) + 2 * _KC * (bn + 8))


def _tiles_per_block(tiles, blocks_per_tile, resident):
    """Row tiles per block that make the fewest tile times per SM slot,
    ``ceil(blocks / resident) * tpb`` with ``blocks = blocks_per_tile *
    ceil(tiles / tpb)``: for each number of waves w, the fewest tiles per
    block that fit w waves; of equal spans, the fewest waves."""
    best = (float("inf"), 1)
    for w in range(1, -(-blocks_per_tile * tiles // resident) + 1):
        per_tile = w * resident // blocks_per_tile   # blocks per group-chunk
        if per_tile == 0:
            continue
        tpb = -(-tiles // per_tile)
        span = -(-blocks_per_tile * -(-tiles // tpb) // resident) * tpb
        if span < best[0]:
            best = (span, tpb)
    return best[1]


def _check_stats_shape(n, t, h, w, cin, m, groups):
    if min(n, t, h, w) <= 0 or groups <= 0 or n % groups:
        raise ValueError(f"conv21d stats: no plan fits {n} clips of "
                         f"{t}x{h}x{w} in {groups} BN groups")
    _check_dims(cin, m, 16)
    if n * t * h * w + 128 >= 2 ** 31:
        raise ValueError(f"conv21d stats: no plan fits {n * t * h * w} rows "
                         "(the kernel indexes rows in 32 bits)")


def stats_plans(n, t, h, w, cin, m, groups):
    """Every launch plan K2 takes for x (n, t, h, w, cin) -> mid m in
    ``groups`` BN groups: for each row tile P, each mid chunk width that
    some warp tile fits (widest first) and each stage count whose stages
    leave room for two blocks per SM, the tiles per block of
    ``_tiles_per_block``. ``blocks``: chunks x groups x blocks per group;
    ``partials``: the rows of the partial-sum scratch (blocks per chunk).
    Raises ValueError for a shape no plan fits."""
    _check_stats_shape(n, t, h, w, cin, m, groups)
    rows = n // groups * t * h * w
    plans = []
    for p in FWD_P:
        wn = 256 // p
        tiles = -(-rows // p)
        for bn in sorted({_even_chunk(m, 8 * ni * wn) for ni in FWD_NI},
                         reverse=True):
            need = 2 * -(-bn // (16 * wn))
            nch = -(-m // bn)
            for s in STATS_STAGES:
                smem = _stats_smem(p, bn, s)
                if STATS_PER_SM * (smem + 1024) > SMEM_SM:
                    continue
                tpb = _tiles_per_block(tiles, nch * groups,
                                       STATS_PER_SM * SM_COUNT)
                bpg = -(-tiles // tpb)
                plans.append(dict(
                    P=p, stages=s, bn=bn, ni=min(v for v in FWD_NI if v >= need),
                    tpb=tpb, tiles=nch * groups * tiles,
                    blocks=nch * groups * bpg, partials=groups * bpg,
                    smem=smem))
    return plans


def stats_cost(pl):
    """A plan's time in units of one K step of a 128 x 160 tile on an SM
    slot: waves x tiles per block x (a fixed cost per K step, taken equal
    to that step's mma time, + the mma time of its rows x the warps'
    columns, idle ones included)."""
    waves = -(-pl["blocks"] // (STATS_PER_SM * SM_COUNT))
    cols = 8 * pl["ni"] * 256 // pl["P"]
    return waves * pl["tpb"] * (1 + pl["P"] * cols / (128 * 160))


def plan_stats(n, t, h, w, cin, m, groups):
    """K2's launch plan: of ``stats_plans``, the one of least
    ``stats_cost``; on ties the larger row tile, then the wider chunk,
    then fewer stages. Raises ValueError for a shape no plan fits.
    Computed once per shape (the model calls it at every launch)."""
    return dict(_plan_stats(n, t, h, w, cin, m, groups))


@functools.lru_cache(maxsize=64)
def _plan_stats(n, t, h, w, cin, m, groups):
    return min(stats_plans(n, t, h, w, cin, m, groups),
               key=lambda pl: (stats_cost(pl), -pl["P"], -pl["bn"],
                               pl["stages"]))


def stats_occupancy(plan):
    """Resident K2 blocks per SM for ``plan`` (needs the card)."""
    got = _lib().cstp_conv21d_stats_occupancy(plan["ni"], plan["smem"])
    if got < 0:
        raise RuntimeError("cstp_conv21d_stats_occupancy failed")
    return got


def _lib():
    return build.load("conv21d", {"cstp_conv21d_stats": _STATS_SIG,
                                  "cstp_conv21d_stats_occupancy": _OCC_SIG,
                                  "cstp_conv21d_fwd": _FWD_SIG,
                                  "cstp_conv21d_fwd_occupancy": _OCC_SIG,
                                  "cstp_conv21d_taps9_stats": _STATS_SIG,
                                  "cstp_conv21d_taps9_fwd": _FWD_SIG})


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"conv21d: {name} on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"conv21d: {name} must be {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"conv21d: {name} must be contiguous and 16-byte "
                         "aligned")


def _check_dims(cin, m, cout):
    """Cin, M and Cout multiples of 16 (csrc/conv21d.cu shapes_ok)."""
    if cin % 16 or m % 16 or cout % 16:
        raise ValueError(f"conv21d kernels need Cin % 16 == 0, "
                         f"M % 16 == 0, Cout % 16 == 0; got {cin}, {m}, "
                         f"{cout}")


def _check_input(x, ws, ws_shape, bn_groups, pad, cout=16):
    """Checks shared by the four wrappers, before any launch: x (B, T,
    H + pad, W + pad, Cin) bf16 with whole BN groups, ws of ``ws_shape``.
    Returns the device and the unpadded (H, W)."""
    b, t, hp, wp, cin = x.shape
    _check_dims(cin, ws.shape[-1], cout)
    if bn_groups <= 0 or b % bn_groups:
        raise ValueError(f"batch {b} not divisible by {bn_groups} BN groups")
    if hp <= pad or wp <= pad:
        raise ValueError(f"conv21d: {hp}x{wp} frames with padding {pad} "
                         "hold no pixels")
    dev = x.device
    _check("x", x, torch.bfloat16, x.shape, dev)
    _check("ws", ws, torch.bfloat16, ws_shape, dev)
    return dev, (hp - pad, wp - pad)


def _require_cuda(dev):
    if dev.type != "cuda":
        raise ValueError(f"conv21d kernels take CUDA tensors, got {dev}")


def _pass_a(fn, x, ws, ws_shape, bn_groups, pad, plan):
    """Pass A on CUDA, launched with ``plan`` (``plan_stats``'s by
    default, for the unpadded shape): -> gmean, gvar (G, M) f32."""
    dev, hw = _check_input(x, ws, ws_shape, bn_groups, pad)
    b, t, cin, m = x.shape[0], x.shape[1], x.shape[-1], ws.shape[-1]
    if plan is None:
        plan = plan_stats(b, t, *hw, cin, m, bn_groups)
    _require_cuda(dev)
    psum = torch.empty((plan["partials"], m), dtype=torch.float32,
                       device=dev)
    psq = torch.empty_like(psum)
    gmean = torch.empty((bn_groups, m), dtype=torch.float32, device=dev)
    gvar = torch.empty_like(gmean)
    err = getattr(_lib(), fn)(
        x.data_ptr(), ws.data_ptr(), psum.data_ptr(), psq.data_ptr(),
        gmean.data_ptr(), gvar.data_ptr(), b, t, *hw, cin, m, bn_groups,
        *(plan[k] for k in _STATS_PLAN),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, fn)
    return gmean, gvar


def _pass_b(fn, x, ws, ws_shape, wt, gmean, gvar, scale, bias, bn_groups,
            eps, pad, plan):
    """Pass B on CUDA, launched with ``plan`` (``plan_fwd``'s by default,
    for the unpadded shape): -> (B, T, H, W, Cout) bf16."""
    m, cout = ws.shape[-1], wt.shape[-1]
    dev, hw = _check_input(x, ws, ws_shape, bn_groups, pad, cout)
    rstd = torch.rsqrt(gvar + eps)
    _check("wt", wt, torch.bfloat16, (3, m, cout), dev)
    _check("gmean", gmean, torch.float32, (bn_groups, m), dev)
    _check("rstd", rstd, torch.float32, (bn_groups, m), dev)
    _check("scale", scale, torch.float32, (m,), dev)
    _check("bias", bias, torch.float32, (m,), dev)
    b, t, cin = x.shape[0], x.shape[1], x.shape[-1]
    if plan is None:
        plan = plan_fwd(b, t, *hw, cin, m, cout)
    _require_cuda(dev)
    out = torch.empty((b, t, *hw, cout), dtype=torch.bfloat16, device=dev)
    err = getattr(_lib(), fn)(
        x.data_ptr(), ws.data_ptr(), wt.data_ptr(), gmean.data_ptr(),
        rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, t, *hw, cin, m, cout, bn_groups, *(plan[k] for k in _FWD_PLAN),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, fn)
    return out


def run_stats(x, ws2, bn_groups: int, plan=None):
    """Pass A, tiling "clip" (K2), launched with ``plan`` (one of
    ``stats_plans``; by default ``plan_stats``'s): x (B, T, H, W, Cin)
    bf16, ws2 (9*Cin, M) bf16 -> gmean, gvar (G, M) f32."""
    out = _pass_a("cstp_conv21d_stats", x, ws2,
                  (9 * x.shape[-1], ws2.shape[-1]), bn_groups, 0, plan)
    launches["stats"] += 1
    return out


def run_fwd(x, ws2, wt, gmean, gvar, scale, bias, bn_groups: int,
            eps: float = 1e-5, plan=None):
    """Pass B, tiling "clip" (K3), launched with ``plan`` (one of
    ``fwd_plans``; by default ``plan_fwd``'s): -> (B, T, H, W, Cout)
    bf16."""
    out = _pass_b("cstp_conv21d_fwd", x, ws2,
                  (9 * x.shape[-1], ws2.shape[-1]), wt, gmean, gvar, scale,
                  bias, bn_groups, eps, 0, plan)
    launches["fwd"] += 1
    return out


def run_stats_taps9(x_pad, ws, bn_groups: int, plan=None):
    """Pass A, tiling "taps9" (K4a: K2's kernel on the padded input),
    launched with ``plan`` (one of ``stats_plans`` of the unpadded shape;
    by default ``plan_stats``'s): x_pad (B, T, H+2, W+2, Cin) bf16, ws
    (3, 3, Cin, M) bf16 -> gmean, gvar (G, M) f32."""
    out = _pass_a("cstp_conv21d_taps9_stats", x_pad, ws,
                  (3, 3, x_pad.shape[-1], ws.shape[-1]), bn_groups, 2, plan)
    launches["stats_taps9"] += 1
    return out


def run_fwd_taps9(x_pad, ws, wt, gmean, gvar, scale, bias, bn_groups: int,
                  eps: float = 1e-5, plan=None):
    """Pass B, tiling "taps9" (K4b: K3's kernel on the padded input),
    launched with ``plan`` (one of ``fwd_plans`` of the unpadded shape; by
    default ``plan_fwd``'s): -> (B, T, H, W, Cout) bf16."""
    out = _pass_b("cstp_conv21d_taps9_fwd", x_pad, ws,
                  (3, 3, x_pad.shape[-1], ws.shape[-1]), wt, gmean, gvar,
                  scale, bias, bn_groups, eps, 2, plan)
    launches["fwd_taps9"] += 1
    return out


def pad_hw(x):
    """(B, T, H, W, C) -> (B, T, H+2, W+2, C), zero rows and columns around
    each frame: the padded input of the taps9 kernels (JAX ``_pad_hw``)."""
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def _check_tiling(tiling):
    if tiling not in TILINGS:
        raise ValueError(f"tiling must be one of {TILINGS}, got {tiling!r}")


def fused_st_conv_cuda(x, ws, wt, scale, bias, bn_groups: int = 1,
                       eps: float = 1e-5, tiling: str = "clip",
                       cross_rank: bool = False, spatial: bool = False):
    """The chosen tiling's two kernels on CUDA tensors, with the TPU
    kernels' bf16 casts; ``cross_rank``: the statistics all-reduced
    between the two launches; ``spatial``: x is a padded H shard, taken by
    the taps9 pair as it is, its statistics summed over the shards by
    their positions between the launches."""
    _check_tiling(tiling)
    if spatial and tiling != "taps9":
        raise ValueError("a padded H shard takes the taps9 kernels "
                         f"(K4a/K4b), not tiling {tiling!r}")
    kh, kw, cin, m = ws.shape
    if (kh, kw) != (3, 3) or wt.shape[0] != 3:
        raise ValueError(f"conv21d kernels take ws (3, 3, Cin, M) and wt "
                         f"(3, M, Cout); got {tuple(ws.shape)}, "
                         f"{tuple(wt.shape)}")
    xb = x.to(torch.bfloat16).contiguous()
    wsb = ws.to(torch.bfloat16).contiguous()
    wtb = wt.to(torch.bfloat16).contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    if tiling == "taps9":
        x_pad = xb if spatial else pad_hw(xb)
        gmean, gvar = run_stats_taps9(x_pad, wsb, bn_groups)
        axis = stats_axis(cross_rank, spatial)
        if axis:
            b, t, hp, wp, _ = x_pad.shape
            count = (b // bn_groups) * t * (hp - 2) * (wp - 2)
            gmean, gvar = global_stats(gmean, gvar, axis,
                                       count if spatial else None)
        out = run_fwd_taps9(x_pad, wsb, wtb, gmean, gvar, scale, bias,
                            bn_groups, eps)
    else:
        ws2 = wsb.reshape(9 * cin, m)
        gmean, gvar = run_stats(xb, ws2, bn_groups)
        if cross_rank:
            gmean, gvar = global_stats(gmean, gvar)
        out = run_fwd(xb, ws2, wtb, gmean, gvar, scale, bias, bn_groups, eps)
    return out, gmean, gvar


# ------------------------------------------------------------ autograd op

class FusedSTConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ws, wt, scale, bias, bn_groups, eps, tiling,
                cross_rank, spatial):
        if x.device.type == "cuda":
            out, gmean, gvar = fused_st_conv_cuda(x, ws, wt, scale, bias,
                                                  bn_groups, eps, tiling,
                                                  cross_rank, spatial)
            ctx.dtype = torch.bfloat16
        else:
            ctx.dtype = x.dtype
            out, gmean, gvar = fused_st_conv_plain(x, ws, wt, scale, bias,
                                                   bn_groups, eps, x.dtype,
                                                   cross_rank, spatial)
        ctx.save_for_backward(x, ws, wt, scale, bias)
        ctx.bn_groups, ctx.eps, ctx.cross_rank = bn_groups, eps, cross_rank
        ctx.spatial = spatial
        ctx.mark_non_differentiable(gmean, gvar)
        return out, gmean, gvar

    @staticmethod
    def backward(ctx, d_out, _d_gmean, _d_gvar):
        # gradients only for the inputs that need one (a frozen finetune
        # prefix leaves ws, wt, scale and bias without)
        need = ctx.needs_input_grad[:5]
        # saved_tensors read once: under non-reentrant checkpointing (remat)
        # a second read raises
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        with torch.enable_grad():
            x, ws, wt, scale, bias = inputs
            gm, gv = reference_stats(x, ws, ctx.bn_groups, ctx.dtype,
                                     ctx.cross_rank, ctx.spatial)
            out = reference_chain(x, ws, wt, scale, bias, gm, gv,
                                  ctx.bn_groups, ctx.eps, ctx.dtype,
                                  padded=ctx.spatial)
        wanted = [t for t, n in zip(inputs, need) if n]
        got = iter(torch.autograd.grad(out, wanted, d_out.to(out.dtype),
                                       allow_unused=True))
        grads = [next(got) if n else None for n in need]
        grads = [None if g is None else g.to(t.dtype)
                 for g, t in zip(grads, saved)]
        return (*grads, None, None, None, None, None)


def fused_st_conv(x, ws, wt, scale, bias, bn_groups: int = 1,
                  eps: float = 1e-5, tiling: str = "clip",
                  cross_rank: bool = False, spatial: bool = False):
    """Fused spatial(1,3,3) -> BN(train stats) -> ReLU -> temporal(3,1,1).
    ``x`` (B, T, H, W, Cin) unpadded; ``ws`` (3, 3, Cin, M); ``wt``
    (3, M, Cout); ``scale``/``bias`` (M,). ``tiling`` picks the kernel pair
    for CUDA tensors: "clip" (K2/K3) or "taps9" (K4a/K4b); anything else
    raises. ``cross_rank``: global-batch statistics under a process group
    (``--sync_bn 1``). ``spatial`` (``--shard_spatial``, tiling "taps9"):
    ``x`` is this rank's padded H shard, ``(B, T, h + 2, W + 2, Cin)``, and
    the statistics are over every shard's positions. Returns ``(out,
    gmean, gvar)`` with ``(G, M)`` group statistics."""
    _check_tiling(tiling)
    cross_rank = bool(cross_rank) and is_distributed()
    return FusedSTConv.apply(x, ws, wt, scale, bias, bn_groups, eps, tiling,
                             cross_rank, bool(spatial))
