"""Shared building blocks for the CSTP backbones, in PyTorch.

The port of ``cstp_tpu/models/layers.py``. Activations are NDHWC (channels
last) at every module boundary, as in the JAX package; convolutions run in
``dtype`` (bfloat16 by default) while BatchNorm statistics and all
parameters stay float32. Conv weights are stored in PyTorch's OIDHW layout
and dense weights as ``(out, in)``; ``models/bridge.py`` converts the JAX
package's DHWIO / ``(in, out)`` leaves.

Initialisation follows the JAX package (reference ``r21d_byol.py:301-329``):
glorot-uniform conv and dense kernels, glorot-uniform BatchNorm scales
(``U(-sqrt(6/C), sqrt(6/C))``), torch-default dense biases.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cstp_tpu_torch.ops.bn import BN_EPS, group_moments, per_sample
from cstp_tpu_torch.ops.conv21d import fused_st_conv
from cstp_tpu_torch.ops.quant import (
    FIXED_SCALE,
    QUANT_MODES,
    STATIC_FLOOR,
    STORE_DECAY,
    STORE_FLOOR,
    STORE_MODES,
    activation_absmax_scale,
    float_store_chain,
    int8_conv,
    int8_store_chain,
)
from cstp_tpu_torch.parallel.mesh import (
    SpatialShard,
    all_reduce_sum,
    copy_to_parallel,
    cut_slice,
    global_moments,
    halo_rows,
    reduce_to_replicated,
    scale_axis,
    stats_axis,
)

BN_MOMENTUM = 0.9   # flax convention: running = 0.9 * running + 0.1 * batch


# ---------------------------------------------------------------- init laws

def bn_glorot_scale_init(t: torch.Tensor, gen: Optional[torch.Generator]):
    """Reference ``_glorot_uniform`` on a 1-D tensor: bound sqrt(6 / C)."""
    bound = math.sqrt(6.0 / float(t.shape[-1]))
    return nn.init.uniform_(t, -bound, bound, generator=gen)


def torch_linear_bias_init(t: torch.Tensor, fan_in: int,
                           gen: Optional[torch.Generator]):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return nn.init.uniform_(t, -bound, bound, generator=gen)


def glorot_init(t: torch.Tensor, gen: Optional[torch.Generator]):
    """Glorot uniform; PyTorch's fans of an OIDHW / (out, in) weight equal
    flax's fans of the DHWIO / (in, out) kernel."""
    return nn.init.xavier_uniform_(t, generator=gen)


# ---------------------------------------------------------------- BatchNorm

class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax semantics: momentum 0.9,
    eps 1e-5, the *biased* batch variance in the running update, f32
    statistics and normalisation, output in the input's dtype.

    ``groups > 1`` splits the batch into contiguous groups along dim 0, each
    normalised with its own statistics (``_GroupedBN``: per-view statistics
    for the concatenated two-view batch); the running statistics take the
    mean of the group statistics. ``groups == 1`` is ``flax.linen.BatchNorm``
    (fast variance, clipped at 0). ``torch.nn.BatchNorm*`` would update the
    running variance with the unbiased estimate, hence this module.

    ``cross_rank`` (``--sync_bn 1``, set by ``parallel.set_cross_rank_bn``):
    under a process group each group's first and second moments are
    averaged over the ranks, so every group takes the global batch's
    statistics (what flax computes over a 'data'-sharded batch); without a
    group it changes nothing.

    ``spatial`` (``--shard_spatial``, set by ``models/sharded.py
    ShardedTower.shard_spatially`` on the tower's BatchNorms): each rank
    holds some rows of the frames, so the moments are sums over the
    'model' ranks (and over 'data' too under ``cross_rank``), each rank's
    weighted by its positions.
    """

    cross_rank = False
    spatial = False

    def __init__(self, channels: int, groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.groups = groups
        self.scale = nn.Parameter(bn_glorot_scale_init(
            torch.empty(channels), gen))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def batch_stats(self, xf: torch.Tensor):
        """Per-group ``(G, C)`` mean and biased variance of f32 ``xf``."""
        c = xf.shape[-1]
        if self.groups == 1:
            flat = xf.reshape(-1, c)
            mean, sq = self._global(flat.mean(0), flat.square().mean(0),
                                    flat.shape[0])
            var = torch.clamp(sq - mean.square(), min=0.0)
            return mean[None], var[None]
        b, g = xf.shape[0], self.groups
        if b % g:
            raise ValueError(f"batch {b} not divisible by {g} BN groups")
        gmean, gsq = self._global(*group_moments(xf, g),
                                  xf.numel() // (c * g))
        return gmean, gsq - gmean.square()

    def _global(self, mean, sq, count: int):
        """The moments over the ranks that hold the group's positions:
        'data' under ``cross_rank``, 'model' under ``spatial`` (weighted by
        ``count``, this rank's positions per group), both under both."""
        axis = stats_axis(self.cross_rank, self.spatial)
        if axis is None:
            return mean, sq
        return global_moments(mean, sq, axis=axis,
                              count=count if self.spatial else None)

    @torch.no_grad()
    def update_running(self, gmean: torch.Tensor, gvar: torch.Tensor):
        """running = 0.9 * running + 0.1 * mean over groups."""
        self.mean.copy_(BN_MOMENTUM * self.mean
                        + (1.0 - BN_MOMENTUM) * gmean.detach().mean(0))
        self.var.copy_(BN_MOMENTUM * self.var
                       + (1.0 - BN_MOMENTUM) * gvar.detach().mean(0))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out_dtype = x.dtype if x.is_floating_point() else torch.float32
        xf = x.float()
        if not train:
            y = (xf - self.mean) * torch.rsqrt(self.var + BN_EPS) * self.scale
            return (y + self.bias).to(out_dtype)
        gmean, gvar = self.batch_stats(xf)
        self.update_running(gmean, gvar)
        if self.groups == 1:
            y = (xf - gmean[0]) * (torch.rsqrt(gvar[0] + BN_EPS) * self.scale)
            return (y + self.bias).to(out_dtype)
        b, g = xf.shape[0], self.groups
        shape = (b,) + (1,) * (xf.dim() - 2) + (xf.shape[-1],)
        y = (xf - per_sample(gmean, b, shape)) * torch.rsqrt(
            per_sample(gvar, b, shape) + BN_EPS)
        return (y * self.scale + self.bias).to(out_dtype)


@contextlib.contextmanager
def running_stats_kept(module: nn.Module):
    """Every buffer of ``module`` (the BatchNorm running statistics) back to
    its value on entry when the block exits, also on an exception. The
    recompute of a checkpointed region runs inside it: the region's forward
    already advanced the running statistics once, as the JAX package's
    functional remat does."""
    saved = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


# ---------------------------------------------------------------- convs

def _triple(v) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _pad_pairs(padding) -> Tuple[Tuple[int, int], ...]:
    """Per-axis ``(lo, hi)`` pads of ``padding``: an int, three ints
    (symmetric) or three ``(lo, hi)`` pairs, mixed freely."""
    return tuple((p, p) if isinstance(p, int) else (int(p[0]), int(p[1]))
                 for p in _triple(padding))


def _h_window(kernel, stride, pads):
    """Kernel, stride and padding in H (an ``h_window``): the padding an
    int where it is symmetric, else its TF-SAME ``(lo, hi)`` pair."""
    lo, hi = pads[1]
    return kernel[1], stride[1], lo if lo == hi else (lo, hi)


def _ndhwc_pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """``x`` (N, T, H, W, C) padded by ``pads`` ((lo, hi) for T, H, W)."""
    (tlo, thi), (hlo, hhi), (wlo, whi) = pads
    return F.pad(x, (0, 0, wlo, whi, hlo, hhi, tlo, thi), value=value)


class Conv3d(nn.Module):
    """3D conv on NDHWC, computed in ``dtype``. The NDHWC tensor is handed
    to ``F.conv3d`` as its ``channels_last_3d`` NCDHW view, so no copy is
    made. ``padding`` is symmetric per axis (an int each) or, for the
    TF-SAME backbones, a ``(lo, hi)`` pair per axis: an asymmetric pad is
    written into the NDHWC tensor first (so cuDNN still gets a
    ``channels_last_3d`` view) and the conv then pads nothing.
    ``use_bias`` adds a float32 bias, initialised to zeros, to the
    ``dtype`` output (the JAX package's ``out + bias.astype(dtype)``).

    ``quant`` (``--quant``; ``ops/quant.py``): '' runs the float conv;
    'int8' the int8 conv with a dynamic activation scale, 'int8_fixed'
    with the scale 0.05, 'int8_static' with ``max(act_scale, 1e-8)``;
    'int8_calib' runs the float conv and raises the site's ``act_scale`` to
    the input's ``absmax / 127 + 1e-12`` (no gradient). The last two keep
    ``act_scale`` as a float32 buffer (0 until calibrated), where the JAX
    package keeps a batch-stats leaf of the same name. The int8 conv takes
    the ``(lo, hi)`` pads itself.

    A 4-D ``(N, H, W, C)`` input (``--t_fold``: a clip batch's frames
    folded into N) takes a kernel, stride and padding of 1, 1 and 0 in T:
    the float conv runs as a 2-D conv and the int8 conv on ``T = 1``, with
    the weight's shape unchanged.

    A dynamic or observed activation scale is the absmax of the whole
    input, a maximum over the ranks that hold parts of it
    (``parallel.scale_axis``): 'data' in a step, and 'model' too where
    ``spatial`` (``--shard_spatial``, set by ``models/sharded.py
    ShardedTower.shard_spatially`` on the tower's convs) marks an H shard.
    It is taken over ``held``, the rows this rank holds, where the
    halo-extended input (whose rows a strided 1 x 1 conv's halo leaves
    some out of) is given.

    ``shard`` (``--shard_spatial``; set at each forward on an H site of
    C3D, the 3D-ResNets, S3D-G and I3D by their tower): ``(SpatialShard,
    stride)``, the H split and the total stride of the input rows. The
    conv then fetches the rows its H window reads (``parallel.halo_rows``,
    a TF-SAME ``(lo, hi)`` pad's too: ``lo`` rows above, the last rank's
    ``hi`` zero rows below the frame) and runs on them with ``h_halo`` and
    ``held`` as above."""

    spatial = False
    shard: Optional[Tuple[SpatialShard, int]] = None

    def __init__(self, in_ch: int, features: int, kernel, stride=(1, 1, 1),
                 padding=(0, 0, 0), dtype=torch.bfloat16,
                 gen: Optional[torch.Generator] = None,
                 use_bias: bool = False, quant: str = ""):
        super().__init__()
        if quant not in ("",) + QUANT_MODES:
            raise ValueError(f"Conv3d quant {quant!r} not in {QUANT_MODES}")
        self.kernel = _triple(kernel)
        self.stride = _triple(stride)
        self.pad_pairs = _pad_pairs(padding)
        self.dtype = dtype
        self.quant = quant
        self.weight = nn.Parameter(glorot_init(
            torch.empty(features, in_ch, *self.kernel), gen))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        if quant in ("int8_static", "int8_calib"):
            self.register_buffer("act_scale", torch.zeros(()))

    @property
    def h_window(self):
        return _h_window(self.kernel, self.stride, self.pad_pairs)

    def call_pads(self, h_halo: bool) -> Tuple[Tuple[int, int], ...]:
        """This call's ``(lo, hi)`` pads for T, H and W: ``padding`` or the
        TF-SAME pairs, H's none on a halo-extended input (which holds the
        rows H's pads give, either pair)."""
        pads = list(self.pad_pairs)
        if h_halo:
            pads[1] = (0, 0)
        return tuple(pads)

    def forward(self, x: torch.Tensor, h_halo: bool = False,
                held: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``h_halo``: ``x`` already holds the rows the H padding would
        give (``parallel.halo_rows``), so H is not padded again; ``held``:
        the rows this rank holds of the input before that halo."""
        x = x.to(self.dtype)
        if self.shard is not None and not h_halo:
            held, h_halo = x, True
            x = halo_rows(x, *self.shard, *self.h_window)
        folded = x.dim() == 4
        if folded and (self.kernel[0], self.stride[0],
                       self.pad_pairs[0]) != (1, 1, (0, 0)):
            raise ValueError(f"a T-folded input needs a (1, kh, kw) conv "
                             f"of T stride 1 and padding 0, not kernel "
                             f"{self.kernel}, stride {self.stride}")
        pads = self.call_pads(h_halo)
        if self.quant in ("int8", "int8_calib"):
            with torch.no_grad():
                observed = activation_absmax_scale(
                    x if held is None else held.to(self.dtype),
                    scale_axis(self.spatial))
        if self.quant == "int8_calib":
            with torch.no_grad():
                self.act_scale.copy_(torch.maximum(self.act_scale, observed))
        elif self.quant:
            if self.quant == "int8":
                sa = observed
            elif self.quant == "int8_fixed":
                sa = FIXED_SCALE
            else:
                sa = torch.clamp(self.act_scale, min=STATIC_FLOOR)
            y = int8_conv(x[:, None] if folded else x, self.weight,
                          self.stride, pads, self.dtype, act_scale=sa)
            if folded:
                y = y[:, 0]
            if self.bias is not None:
                y = y + self.bias.to(self.dtype)
            return y
        # symmetric pads go to the conv, others are written out first
        padding = tuple(lo for lo, _ in pads)
        if any(lo != hi for lo, hi in pads):
            x = _ndhwc_pad(x[:, None] if folded else x, pads)
            x, padding = (x[:, 0] if folded else x), (0, 0, 0)
        if folded:
            y = F.conv2d(x.permute(0, 3, 1, 2),
                         self.weight.to(self.dtype)[:, :, 0],
                         stride=self.stride[1:], padding=padding[1:]
                         ).permute(0, 2, 3, 1)
        else:
            y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                         self.weight.to(self.dtype), stride=self.stride,
                         padding=padding).permute(0, 2, 3, 4, 1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def max_pool_3d(x: torch.Tensor, kernel, stride,
                padding=(0, 0, 0)) -> torch.Tensor:
    """``torch.nn.MaxPool3d`` on NDHWC: symmetric padding that never wins
    (``-inf``), through the ``channels_last_3d`` NCDHW view."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), _triple(kernel),
                     _triple(stride), _triple(padding))
    return y.permute(0, 2, 3, 4, 1)


def _max_pool_pairs(x: torch.Tensor, kernel, stride, pads) -> torch.Tensor:
    """:func:`max_pool_3d` with ``(lo, hi)`` pads per axis: symmetric ones
    go to the pool, others are written out first as ``-inf``
    (``F.max_pool3d`` pads symmetrically only)."""
    if all(lo == hi for lo, hi in pads):
        return max_pool_3d(x, kernel, stride, tuple(lo for lo, _ in pads))
    return max_pool_3d(_ndhwc_pad(x, pads, float("-inf")), kernel, stride)


class MaxPool3d(nn.Module):
    """:func:`max_pool_3d` as an H site of ``--shard_spatial``; ``padding``
    as ``Conv3d``'s: symmetric per axis, or TF SAME's ``(lo, hi)`` pairs
    (:func:`same_pads`, I3D's pools), written out as ``-inf``. With
    ``shard`` set (as ``Conv3d.shard``) it fetches the rows its H window
    reads, ``-inf`` outside the frame as the pool pads, and pools them
    with no H padding: exactly this rank's rows of the whole frame's
    pool, a VALID pool's too (its last odd row read by no window), and a
    SAME pool's whose ``max(k - s, 0)`` pad floors at an odd height."""

    shard: Optional[Tuple[SpatialShard, int]] = None

    def __init__(self, kernel, stride, padding=0):
        super().__init__()
        self.kernel, self.stride = _triple(kernel), _triple(stride)
        self.pad_pairs = _pad_pairs(padding)

    @property
    def h_window(self):
        return _h_window(self.kernel, self.stride, self.pad_pairs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = list(self.pad_pairs)
        if self.shard is not None:
            x = halo_rows(x, *self.shard, *self.h_window, fill=float("-inf"))
            pads[1] = (0, 0)
        return _max_pool_pairs(x, self.kernel, self.stride, pads)


class Subsample(nn.Module):
    """``x[:, ::s, ::s, ::s]`` (``F.avg_pool3d`` of kernel 1, stride
    ``s``), an H site of window ``(1, s, 0)``: with ``shard`` set (as
    ``Conv3d.shard``) H starts at the local row ``(-a) mod s``, ``a`` the
    rank's first global row, so the rank keeps the global rows that are
    multiples of ``s``, the rows the rule of ``parallel.SpatialShard``
    gives it."""

    shard: Optional[Tuple[SpatialShard, int]] = None

    def __init__(self, stride: int):
        super().__init__()
        self.s = stride

    @property
    def h_window(self) -> Tuple[int, int, int]:
        return 1, self.s, 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, first = self.s, 0
        if self.shard is not None:
            shard, stride = self.shard
            first = -shard.rows(stride)[0] % s
        return x[:, ::s, first::s, ::s]


def same_pads(kernel, stride) -> Tuple[Tuple[int, int], ...]:
    """TF SAME pads (the JAX package's ``_same_pads``): ``max(k - s, 0)``
    per axis, the odd one at the end."""
    pads = []
    for k, s in zip(_triple(kernel), _triple(stride)):
        along = max(k - s, 0)
        pads.append((along // 2, along - along // 2))
    return tuple(pads)


def same_pool(kernel, stride) -> MaxPool3d:
    """A TF-SAME max pool on NDHWC (I3D's ``MaxPool3dTFPadding``): pads of
    :func:`same_pads`, ``-inf`` as in the JAX package."""
    return MaxPool3d(kernel, stride, same_pads(kernel, stride))


def max_pool_3d_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """:func:`same_pool` applied to ``x``: the JAX package's
    ``max_pool_3d_same`` as a function."""
    return same_pool(kernel, stride)(x)


def r21d_intermediate_channels(in_channels: int, out_channels: int,
                               kernel: Tuple[int, int, int],
                               round_to: int = 1) -> int:
    """Mid-channel count of the factorized (2+1)D conv (paper section 3.5,
    reference ``r21d_byol.py:74-76``). ``round_to`` > 1 (``--mid_round``)
    rounds it to the nearest multiple of ``round_to``, at least one, with
    Python's ``round`` as in the JAX package: a tie goes to the even
    multiple (576 at 128 is 4.5 multiples: 512, not 640). The parameter
    shapes change with it."""
    kt, kh, kw = kernel
    num = kt * kh * kw * in_channels * out_channels
    den = kh * kw * in_channels + kt * out_channels
    mid = int(math.floor(num / den))
    if round_to > 1:
        mid = max(round_to, round_to * int(round(mid / round_to)))
    return mid


def s2d_kernel(k: int) -> int:
    """The even kernel the s2d rewrite pads a ``k x k`` kernel to."""
    return (k + 2) // 2 * 2


def s2d_conv(x: torch.Tensor, weight: torch.Tensor, pad: int,
             dtype, h_pad: Optional[Tuple[int, int]] = None
             ) -> torch.Tensor:
    """A spatial (1, k, k) conv of stride (1, 2, 2) and padding (0, pad,
    pad) on NDHWC ``x``, by the exact space-to-depth rewrite (the JAX
    package's ``SpatialS2DConv``): the taps of ``weight`` (OIDHW, ``(M,
    C, 1, k, k)``) are padded with zeros to an even ``k2 x k2``
    (:func:`s2d_kernel`) and rearranged by parity into a ``(1, k2/2,
    k2/2)`` kernel over ``4C`` channels, the padded input's 2 x 2 blocks
    become channels, and a stride-1 conv runs on the half-resolution grid:
    the same products, summed in another order. ``h_pad`` replaces H's
    ``(pad, pad)`` (``(0, 0)`` on an H shard that holds its halo rows for
    kernel ``k2``: its first row is then an even row of the padded frame,
    so the 2 x 2 blocks pair rows as in the whole frame). The padded
    extent must be even."""
    b, t, h, w, c = x.shape
    m, k = weight.shape[0], weight.shape[-1]
    hlo, hhi = (pad, pad) if h_pad is None else h_pad
    hp, wp = h + hlo + hhi, w + 2 * pad
    if hp % 2 or wp % 2:
        raise ValueError(f"s2d conv: padded extent {hp}x{wp} is not even")
    k2 = s2d_kernel(k)
    wk = F.pad(weight.to(dtype)[:, :, 0], (0, k2 - k, 0, k2 - k))
    # (M, C, a, di, b, dj) -> (M, di, dj, C, a, b): channel (2 di + dj) C + c
    wk = wk.reshape(m, c, k2 // 2, 2, k2 // 2, 2).permute(0, 3, 5, 1, 2, 4)
    wk = wk.reshape(m, 4 * c, 1, k2 // 2, k2 // 2)
    xs = _ndhwc_pad(x.to(dtype), ((0, 0), (hlo, hhi), (pad, pad)))
    xs = xs.reshape(b, t, hp // 2, 2, wp // 2, 2, c).permute(0, 1, 2, 4, 3,
                                                             5, 6)
    xs = xs.reshape(b, t, hp // 2, wp // 2, 4 * c)
    y = F.conv3d(xs.permute(0, 4, 1, 2, 3), wk)
    return y.permute(0, 2, 3, 4, 1)


class SpatioTemporalConv(nn.Module):
    """Factorized (2+1)D conv: spatial (1,k,k) conv -> BN -> ReLU ->
    temporal (k,1,1) conv (reference ``r21d_byol.py:38-97``).

    ``fused``: in train mode, an eligible site (stride 1, temporal kernel 3
    with padding 1, "same" spatial padding) runs the whole chain through
    :func:`cstp_tpu_torch.ops.conv21d.fused_st_conv`, which launches the
    CUDA kernels for CUDA tensors and runs their plain version on the CPU.
    The parameters are the same either way. ``quant`` reaches both convs
    (``Conv3d``), except the storage chain's modes (``STORE_MODES``),
    which the block runs whole (``ops/quant.py``), with the float block's
    parameters and three float32 buffers ``act_scale_{in,mid,act}``, 0 at
    init (the JAX package's batch-stats leaves of the same names):

    * train with ``int8_store``: the int8 chain at the delayed scales
      ``max(scale, 1e-6)``, then ``scale = max(0.999 * scale, obs)`` from
      its exact observations; ``int8_store_fz``: the same with the scales
      frozen (no observations);
    * train with ``int8_store_calib`` (the pretrain step's bootstrap,
      :func:`store_calibration`) and eval: the float chain; in train the
      scales rise to the observations.

    The running statistics move as a BatchNorm's, 0.9 / 0.1, in train.

    ``shard`` (``--shard_spatial``; set by ``R2Plus1DNet`` at each
    forward, ``models/sharded.py``): ``(SpatialShard, stride)``, the H
    split and the total stride of this block's input rows. The spatial
    conv then runs on the rows ``parallel.halo_rows`` gives it, and a fused
    site on the padded shard (the halo rows in H, zeros at the frame's top
    and bottom and in W), with the taps9 kernels (K4a/K4b) on CUDA.

    The JAX package's three rewrites, in its order after the storage chain
    and the fused path: ``mid_round`` (``--mid_round``) rounds the mid width
    (:func:`r21d_intermediate_channels`); ``s2d`` (``--s2d_stem``, on a
    stride-(1, 2, 2) site with a square kernel) computes the spatial conv by
    :func:`s2d_conv`, always in float, as the JAX package's
    ``SpatialS2DConv`` has no ``--quant`` (so that conv keeps no
    ``act_scale``); ``t_fold`` (``--t_fold``) folds T into the batch for
    the spatial conv (a 2-D conv) and the mid BatchNorm and ReLU, and
    unfolds at the temporal conv: each BN group's rows are then its clips'
    frames, so the statistics are the unfolded ones. These two change no
    parameter. On an H shard the halo comes first, on the 5-D input: the
    s2d conv takes the rows of the even kernel ``k2`` (so its 2 x 2 blocks
    pair the whole frame's rows), the folded conv the halo-extended frames;
    the BatchNorm after either weighs this rank's own rows. The int8 convs
    (``Conv3d``) and the storage chain take the halo-extended input with H
    padded by none, and the chain sums its integer moments over 'model'.
    """

    shard: Optional[Tuple[SpatialShard, int]] = None

    def __init__(self, in_ch: int, features: int, kernel, stride=(1, 1, 1),
                 padding=(0, 0, 0), dtype=torch.bfloat16, bn_groups: int = 1,
                 fused: bool = False, gen: Optional[torch.Generator] = None,
                 quant: str = "", mid_round: int = 1, t_fold: bool = False,
                 s2d: bool = False):
        super().__init__()
        kt, kh, kw = self.kernel = _triple(kernel)
        st, sh, sw = self.stride = _triple(stride)
        pt, ph, pw = self.padding = _triple(padding)
        self.dtype = dtype
        self.fused = fused
        self.quant = quant
        self.t_fold = t_fold
        self.s2d = s2d and (sh, sw) == (2, 2) and kh == kw
        conv_quant = "" if quant in STORE_MODES else quant
        mid = r21d_intermediate_channels(in_ch, features, self.kernel,
                                         mid_round)
        self.spatial_conv = Conv3d(in_ch, mid, (1, kh, kw), (1, sh, sw),
                                   (0, ph, pw), dtype, gen,
                                   quant="" if self.s2d else conv_quant)
        self.bn = BatchNorm(mid, bn_groups, gen)
        self.temporal_conv = Conv3d(mid, features, (kt, 1, 1), (st, 1, 1),
                                    (pt, 0, 0), dtype, gen, quant=conv_quant)
        if quant in STORE_MODES:
            for k in ("in", "mid", "act"):
                self.register_buffer(f"act_scale_{k}", torch.zeros(()))

    @property
    def h_window(self) -> Tuple[int, int, int]:
        return self.kernel[1], self.stride[1], self.padding[1]

    def fused_eligible(self, train: bool) -> bool:
        kt, kh, kw = self.kernel
        _, ph, pw = self.padding
        return (self.fused and train and self.stride == (1, 1, 1)
                and (kt, self.padding[0]) == (3, 1)
                and (ph, pw) == (kh // 2, kw // 2))

    def _halo(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's input rows and the neighbours' rows the spatial
        conv reads (its H padding included; the s2d conv's even kernel)."""
        shard, stride = self.shard
        _, kh, _ = self.kernel
        return halo_rows(x, shard, stride, s2d_kernel(kh) if self.s2d else kh,
                         self.stride[1], self.padding[1])

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.quant in STORE_MODES:
            return self._store_forward(x, train)
        if self.fused_eligible(train):
            ws = self.spatial_conv.weight[:, :, 0].permute(2, 3, 1, 0)
            wt = self.temporal_conv.weight[:, :, :, 0, 0].permute(2, 1, 0)
            x = x.to(self.dtype)
            spatial = self.shard is not None
            if spatial:
                _, _, pw = self.padding
                x = F.pad(self._halo(x), (0, 0, pw, pw))
            out, gmean, gvar = fused_st_conv(
                x, ws, wt, self.bn.scale, self.bn.bias, self.bn.groups,
                BN_EPS, tiling="taps9" if spatial else "clip",
                cross_rank=self.bn.cross_rank, spatial=spatial)
            self.bn.update_running(gmean, gvar)
            return out
        b, t = x.shape[:2]
        sharded, held = self.shard is not None, None
        if sharded:
            held, x = x, self._halo(x.to(self.dtype))
        if self.s2d:
            x = s2d_conv(x, self.spatial_conv.weight, self.padding[1],
                         self.dtype, (0, 0) if sharded else None)
        elif self.t_fold:
            x = self.spatial_conv(x.reshape(b * t, *x.shape[2:]),
                                  h_halo=sharded, held=held)
        else:
            x = self.spatial_conv(x, h_halo=sharded, held=held)
        x = self.bn(x, train)
        x = torch.relu(x).to(self.dtype)
        if x.dim() == 4:
            x = x.reshape(b, t, *x.shape[1:])
        return self.temporal_conv(x)

    def _store_forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        st, sh, sw = self.stride
        pt, ph, pw = self.padding
        spatial, held = self.shard is not None, None
        if spatial:
            held, x, ph = x, self._halo(x), 0
        geometry = ((1, sh, sw), (0, ph, pw), (st, 1, 1), (pt, 0, 0))
        bn = self.bn
        scales = (self.act_scale_in, self.act_scale_mid, self.act_scale_act)
        ws, wt = self.spatial_conv.weight, self.temporal_conv.weight
        if self.quant == "int8_store_calib" or not train:
            out, gmean, gvar, obs = float_store_chain(
                x, ws, wt, bn.scale, bn.bias, bn.groups, *geometry, train,
                bn.mean, bn.var, self.dtype, cross_rank=bn.cross_rank,
                spatial=spatial, held=held)
            if train:
                with torch.no_grad():
                    for s, a in zip(scales, obs):
                        s.copy_(torch.maximum(s, a))
                bn.update_running(gmean, gvar)
            return out.to(self.dtype)
        observe = self.quant == "int8_store"
        out, gmean, gvar, *obs = int8_store_chain(
            x, ws, wt, bn.scale, bn.bias,
            *(torch.clamp(s, min=STORE_FLOOR) for s in scales), *geometry,
            bn.groups, observe, bn.cross_rank, spatial, held)
        if observe:
            with torch.no_grad():
                for s, a in zip(scales, obs):
                    s.copy_(torch.maximum(STORE_DECAY * s, a))
        bn.update_running(gmean, gvar)
        return out


@contextlib.contextmanager
def store_calibration(module: nn.Module):
    """Every storage-chain site of ``module`` (``int8_store`` /
    ``int8_store_fz``) switched to ``int8_store_calib`` inside the block,
    and back after it: the bootstrap forward of the pretrain step, on the
    same parameters and buffers. Yields the number of sites."""
    sites = [m for m in module.modules()
             if isinstance(m, SpatioTemporalConv) and m.quant in STORE_MODES]
    modes = [m.quant for m in sites]
    try:
        for m in sites:
            m.quant = "int8_store_calib"
        yield len(sites)
    finally:
        for m, q in zip(sites, modes):
            m.quant = q


# ---------------------------------------------------------------- heads

class Dense(nn.Module):
    """``flax.linen.Dense`` with a glorot-uniform kernel and a torch-default
    bias, computed in ``dtype``."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.bfloat16,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(glorot_init(torch.empty(out_dim, in_dim),
                                               gen))
        self.bias = nn.Parameter(torch_linear_bias_init(
            torch.empty(out_dim), in_dim, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class MLPHead(nn.Module):
    """Linear -> BN1d -> ReLU -> Linear (reference Projector / Predictor and
    the pretext heads, ``r21d_byol.py:232-291``).

    ``tp`` (set by :meth:`shard`; a 4096-wide head under a 'model' axis
    above 1, JAX's ``_model_spec``): ``(index, size)``, this rank holding
    ``hidden / size`` hidden units: fc1's columns and bias, the hidden
    BatchNorm's scale, bias and running statistics, and fc2's rows. The
    input enters by :func:`parallel.copy_to_parallel` and fc2's partial
    products (in float32) leave by :func:`parallel.reduce_to_replicated`,
    fc2's bias added once after them. A state dict of the whole head loads
    into a split one (each rank cuts its slice), so one-process
    checkpoints load on any mesh.
    """

    tp: Optional[Tuple[int, int]] = None

    def __init__(self, in_dim: int, hidden: int, out: int,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.hidden = hidden
        self.fc1 = Dense(in_dim, hidden, dtype, gen)
        self.bn = BatchNorm(hidden, bn_groups, gen)
        self.fc2 = Dense(hidden, out, dtype, gen)

    def split_tensors(self):
        """``(name, tensor, dim)`` of every tensor split under ``tp``."""
        return [("fc1.weight", self.fc1.weight, 0),
                ("fc1.bias", self.fc1.bias, 0),
                ("bn.scale", self.bn.scale, 0), ("bn.bias", self.bn.bias, 0),
                ("bn.mean", self.bn.mean, 0), ("bn.var", self.bn.var, 0),
                ("fc2.weight", self.fc2.weight, 1)]

    @torch.no_grad()
    def shard(self, index: int, size: int) -> None:
        """Keep slice ``index`` of ``size`` of the hidden units."""
        if self.tp is not None or self.hidden % size:
            raise ValueError(f"MLPHead: {self.hidden} hidden units over "
                             f"{size} 'model' ranks (split: {self.tp})")
        for name, t, dim in self.split_tensors():
            owner, leaf = name.split(".")
            part = cut_slice(t, dim, index, size).clone()
            module = getattr(self, owner)
            setattr(module, leaf, nn.Parameter(part) if isinstance(
                t, nn.Parameter) else part)
        self.tp = (index, size)
        self._register_load_state_dict_pre_hook(self._cut_whole)

    def _cut_whole(self, state_dict, prefix, *args):
        index, size = self.tp
        for name, t, dim in self.split_tensors():
            v = state_dict.get(prefix + name)
            if v is not None and v.shape[dim] == t.shape[dim] * size:
                state_dict[prefix + name] = cut_slice(v, dim, index, size)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.tp is None:
            x = self.bn(self.fc1(x), train)
            return self.fc2(torch.relu(x).to(self.dtype))
        x = self.bn(self.fc1(copy_to_parallel(x, "model")), train)
        y = F.linear(torch.relu(x).to(self.dtype),
                     self.fc2.weight.to(self.dtype))
        y = reduce_to_replicated(y.float(), "model")
        return (y + self.fc2.bias).to(self.dtype)


# The Inception-v1 plan that S3D-G and I3D share (reference s3dg.py:193-222,
# i3d_byol.py:223-426): block suffix -> out_planes [b0, b1a, b1b, b2a, b2b,
# b3b]; S3D-G names a block Mixed_<suffix>, I3D mixed_<suffix>
INCEPTION_PLAN = (
    ("3b", (64, 96, 128, 16, 32, 32)),
    ("3c", (128, 128, 192, 32, 96, 64)),
    ("4b", (192, 96, 208, 16, 48, 64)),
    ("4c", (160, 112, 224, 24, 64, 64)),
    ("4d", (128, 128, 256, 24, 64, 64)),
    ("4e", (112, 144, 288, 32, 64, 64)),
    ("4f", (256, 160, 320, 32, 128, 128)),
    ("5b", (256, 160, 320, 32, 128, 128)),
    ("5c", (384, 192, 384, 48, 128, 128)),
)


class SelfGating(nn.Module):
    """S3D-G feature gating: ``x * sigmoid(fc(mean of x over T, H, W))``,
    the mean, the float32 ``fc`` (glorot kernel, torch-default bias) and
    the product in float32, the result in ``x``'s dtype.

    ``spatial`` (``--shard_spatial``, set by ``models/sharded.py
    ShardedTower.shard_spatially``): ``x`` holds this rank's rows, so the
    mean is the sum over them and over 'model' divided by the positions
    summed over 'model' (T x the stage's global rows x W). The sum is
    :func:`parallel.all_reduce_sum`, whose backward sums too: the gate
    multiplies this rank's rows only, so each rank's cotangent of the
    mean is a part of the whole (an identity backward would leave dx
    wrong and the forward right)."""

    spatial = False

    def __init__(self, channels: int, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = Dense(channels, channels, torch.float32, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.spatial:
            n = xf.new_full((xf.shape[0], 1), float(math.prod(xf.shape[1:4])))
            sums = all_reduce_sum(torch.cat([xf.sum(dim=(1, 2, 3)), n], 1),
                                  "model")
            mean = sums[:, :-1] / sums[:, -1:]
        else:
            mean = xf.mean(dim=(1, 2, 3))
        w = torch.sigmoid(self.fc(mean))
        return (xf * w[:, None, None, None, :]).to(x.dtype)


class PretextHead(nn.Module):
    """Pretext classification head: 'mlp' = Linear-BN-ReLU-Linear (the r21d
    family) or 'linear' = one f32 Linear."""

    def __init__(self, style: str, in_dim: int, hidden: int, out: int,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.style = style
        if style == "mlp":
            self.mlp = MLPHead(in_dim, hidden, out, dtype, bn_groups, gen)
        elif style == "linear":
            self.fc = Dense(in_dim, out, torch.float32, gen)
        else:
            raise ValueError(f"unknown pretext head style {style!r}")

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.style == "mlp":
            return self.mlp(x, train)
        return self.fc(x.float())


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2)`` semantics (clamps the norm, not norm + eps)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)
