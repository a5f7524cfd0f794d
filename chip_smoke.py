#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cstp_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain only

Phases:
  1. device and build: the card's name and power limit, then every CUDA
     kernel of the port built from ``cstp_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card, with times
     and roofline bounds: both (2+1)D conv kernel pairs (K2/K3, tiling
     "clip", and K4a/K4b, tiling "taps9": the same kernels on the padded
     input) at the four sites of the pretrain step, K4a/K4b also at the
     conv-block benchmark's default shape, and the augment kernel (bf16
     and float32 output, 128x171 and native 256x340 frames -> 112, and
     256x340 -> 224 with its frame in device memory; its time with each
     optional stage switched off through its identity parameters); per
     site, K2's and K3's launch plans (row tile, stages, chunks, blocks,
     resident blocks per SM, shared bytes), their TFLOP/s and their time
     over the plain version's, and a check that two launches of K2 give
     bitwise the same statistics; then hashes of K2's, K3's, K4a's, K4b's
     and K5's outputs on seeded inputs: K4a/K4b's must equal K2/K3's, and
     K2/K3/K5's are printed beside those of commit 0cb95b4, before K4a/K4b
     moved onto K2/K3's kernels (``HASHES_0CB95B4``; a differing hash there
     is reported, not a failure, since another PyTorch may draw other
     inputs);
  3. the pretrain step itself (R(2+1)D depth 1, 16 x 112^2, bf16, per-view
     batch 16, fused conv blocks and fused augmentation): one warm-up and
     three timed steps, with the kernels' launch counts, then one step
     under torch.profiler (device busy share, device time by kernel);
  4. one step from the same weights, generator and batch through the
     kernel configuration, the plain bf16 configuration (``fused_conv=0``,
     ``pallas_augment="off"``) and the plain float32 one, which arbitrates
     how far bf16 rounding alone moves the update; then each one's step
     time;
  5. the conv-block benchmark entry (``cstp_tpu_torch.perf.bench_conv21d``)
     at its default shapes, once per tiling: the taps9 run's fused forward
     must launch K4a/K4b and not K2/K3, and the two tilings' outputs must
     agree on one seeded input;
  6. K2/K3 against the plain chain at the four sites for every shape the
     later phases give them: the finetune step's (one tower, one BN group
     of 64 clips; its times summed over the step's 5 + 5 launches), a
     grad_accum=2 microbatch's (16 clips in 2 BN groups of 8) and
     bench_step pretrain's (128 clips in 2 BN groups of 64);
  7. the finetune step (``train/finetune.py``: R(2+1)D depth 1, batch 64,
     101 classes, bf16, fused_conv=1, ft_all): one warm-up and three timed
     steps, exactly 5 + 5 K2/K3 launches a step and no augment launch; then
     one ft_fc step from the same state, which must leave the backbone's
     parameters bitwise as they were and move the head and the backbone's
     BN running statistics;
  8. the eval and test entry points on that model (eval step with a masked
     tail, window logits over one synthetic video's sliding windows,
     features, retrieval), each timed, none launching a kernel;
  9. one finetune step from the same weights and pre-augmented batch with
     fused_conv 1 and 0 in bf16 and 0 in float32 (the arbiter), held to
     phase 4's rule, then each one's step time;
  10. the pretrain step with grad_accum=2 at per-view batch 16: 20/20/1
     launches a step, finite losses;
  11. the step benchmark entry (``cstp_tpu_torch.perf.bench_step``) once
     per mode (pretrain, ft, eval) at bench.py's shape, kernels on, 2 timed
     steps, with each mode's launches per step checked;
  12. cli: the recipe through the port's four CLIs (``main(argv)`` of
     ``cstp_tpu_torch.cli.main_byol/main_ft/main_test/main_retrieval``) on
     CSTPack files of synthetic frames it writes into a temporary
     directory: pretrain at per-view 16 (2 epochs of 6 steps), a
     ``--task resume``, finetune with validation, test, retrieval, a
     pretrain epoch at per-view 64 and one from a frame directory of
     JPEGs; the kernels' launches per loop step, finite CSV rows, the
     checkpoints, the printed accuracy and non-decreasing R@k checked; the
     loop's step and data-wait ms printed beside phases 3 and 11;
  13. flags: the step flags at per-view batch 16, kernels on: K2/K3 at the
     per-view calls' shape (16 clips, one BN group); one step each of
     ``--concat_views 0`` (20/20/1 launches), ``--remat`` (15/15/1),
     ``--remat_policy bnrelu`` (15/15/1: the fused sites recompute),
     ``--remat`` with ``--concat_views 0`` (30/30/1) and ``--fused_conv 2``
     (5/5/1), each then timed over 2 steps, with its peak memory; the remat
     steps held against the step without remat by phase 4's rule with
     bitwise the same BN running statistics; the per-view calls, AdamW with
     ``--double_bias_lr`` and SGD with dampening and nesterov held against
     their plain bf16 steps by phase 4's rule; then ``bench_step --mode
     pretrain`` at per-view 64 with ``--remat`` (plain; must fit),
     ``--remat-policy bnrelu`` (plain), ``--remat`` with the kernels, and
     ``--fused-conv 2``: step ms, pairs/s, peak GiB (a run that runs out of
     memory, other than the first, is reported);
  14. families: the C3D and 3D-ResNet backbones at full width, 16 x 112^2,
     bf16: at per-view 16, one pretrain step each of c3d, r3d-18 with
     shortcut B and with shortcut A with K5 (``pallas_augment`` on,
     ``fused_conv`` 1, which these families ignore: 0/0/1 launches)
     against the plain bf16 step (0/0/0) by phase 4's rule, each timed
     over 2 steps with its peak memory; for c3d and r3d-18 a finetune and
     an eval step at batch 16 (no launch), and a pretrain state exported
     to a reference ``.pth`` (``python -m cstp_tpu_torch.models.torch_import
     --export``) that ``main_ft`` (2 steps) and ``main_retrieval`` load with
     bitwise its ``online_net`` tensors; then ``bench_step`` at per-view 64
     (pretrain with K5, and ft) for c3d and r3d-18: step ms, throughput,
     peak GiB (an out-of-memory is reported with the size asked);
  15. inception: the S3D-G and I3D families at full width, bf16: at
     per-view 16, one pretrain step each of s3d_byol (16 x 112^2 from
     128x171 frames) and i3d_byol (16 x 224^2 from 256x340 frames: K5's
     frame in device memory, two device launches in its one call) with K5
     (0/0/1 launches) against the plain bf16 step (0/0/0) by phase 4's
     rule, each timed over 2 steps with its peak memory and the forward
     GFLOP per clip of its convolutions, then one profiled K5 step each
     (K5's device time inside it); finetune and eval at batch 16 of
     s3d_classify (MLP head), s3d_byol and i3d_byol (linear head) at
     112^2 and i3d_byol with ``--i3d_conv_head 1`` at 224^2 (no launch);
     the ``.pth`` round trip of phase 14 for s3d_byol and i3d_byol; a
     kinetics-i3d TensorFlow checkpoint written here
     (``write_tf_checkpoint``, no TensorFlow) loaded by ``main_ft
     --tf_i3d_ckpt`` (2 steps) and ``main_byol --tf_i3d_ckpt`` (1 epoch of
     2 steps) into the right towers bitwise; ``bench_step`` at per-view 64
     (pretrain with K5, and ft) for s3d and i3d;
  16. slowfast_legacy: the SlowFast family (``--tau 8 --alpha 4``) and the
     legacy pace-era models at full width, 16 x 112^2 from 128x171 frames,
     bf16: at per-view 16, one pretrain step each of SlowFast depth 18 and
     50 (SlowFast-R50) with K5 (0/0/1) against the plain bf16 step (0/0/0)
     by phase 4's rule, each timed over 2 steps with its peak memory;
     finetune and eval of slowfast_fb-50 at batch 16 (no launch); the
     ``--legacy_pace 1`` finetune step of bare r21d at batch 64 with
     ``--fused_conv 1`` against its plain steps by phase 9's rule (5/5/0
     launches); one train-mode forward of each legacy model
     (``make_legacy_model``: r21d, r21d_byol with one backward, c3d, r3d,
     s3d_g with and without space to depth) in bf16 against float32 (no
     launch); ``bench_step --model slowfast --depth 50`` at per-view 64
     (pretrain with K5, and ft).
Then one JSON line describing the kernels (``launches`` null with
``--kernels-only``; the slice phase's launches plus those of phase 16's
K5 and ``--legacy_pace`` steps), the card's name and power limit, and a
last JSON line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time

import torch

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s

B_VIEW = 16             # per-view batch of the slice; the towers see 2b clips
T, S, H0, W0 = 16, 112, 128, 171
TOWERS = 2              # online and target tower: each site runs in both
# (site, T, H=W, Cin, M, Cout, calls per tower)
SITES = [
    ("conv2.block1.conv1/conv2", 16, 56, 64, 144, 64, 2),
    ("conv3.block1.conv2", 8, 28, 128, 288, 128, 1),
    ("conv4.block1.conv2", 4, 14, 256, 576, 256, 1),
    ("conv5.block1.conv2", 2, 7, 512, 1152, 512, 1),
]
G = 2                   # per-view BN groups in the towers
# native-size frames (data/extract_frames.py's 256 short side, 4:3)
NATIVE_HW = (256, 340)
# the conv-block benchmark's default shape: (name, N, T, H=W, Cin, M, Cout)
BENCH_SHAPE = ("bench_conv21d default (conv2 shape, 2 x 64 clips)", 128, 16,
               56, 64, 144, 64)
S_LARGE = 224           # I3D's sample size: K5's frame in device memory
# Output hashes of the kernels that must not move, at commit 0cb95b4 (before
# K4a/K4b ran on K2/K3's kernels), with PyTorch 2.11 + CUDA 12.8 on one H100
# 80GB HBM3: K3's output and K2's statistics per site
# (perf/sweep_conv21d_fwd.py --hash) and K5's output (augment_hashes).
HASHES_0CB95B4 = {
    "K3 conv2": "756f24fbb7ee4f37", "K2 conv2": "d926f0e937c18fa4",
    "K3 conv3": "f24fe584832912ab", "K2 conv3": "99ac0209fe934483",
    "K3 conv4": "456aeabdf0fede1d", "K2 conv4": "19a3c9068bd9b80a",
    "K3 conv5": "e7e65362a2d7b2dc", "K2 conv5": "a91067c5a36a34bb",
    "K5 bfloat16": "a9fcb9655a7c227a", "K5 float32": "2bc8c5c8d7c982f8",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(ops: float, nbytes: float, rate: float):
    t_ops, t_bytes = ops / rate, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_build():
    from cstp_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(logs)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s from cstp_tpu_torch/csrc")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _hold_pair(tiling, x, ws, wt, scale, bias, groups=G):
    """One tiling's kernel pair against the plain version on one input in
    ``groups`` BN groups. Returns per pass its max abs error, kernel ms,
    and the operations and bytes the pass must do: one spatial conv, plus
    the temporal conv in pass B, each input read once and each output
    written once."""
    from cstp_tpu_torch.ops import conv21d as C

    cin, m = ws.shape[2:]
    cout = wt.shape[2]
    if tiling == "clip":
        xk = x.contiguous()
        wsk = ws.to(torch.bfloat16).reshape(9 * cin, m).contiguous()
        stats, fwd = C.run_stats, C.run_fwd
    else:
        xk = C.pad_hw(x.contiguous())
        wsk = ws.to(torch.bfloat16).contiguous()
        stats, fwd = C.run_stats_taps9, C.run_fwd_taps9
    wtb = wt.to(torch.bfloat16).contiguous()
    gm, gv = stats(xk, wsk, groups)
    gm2, gv2 = stats(xk, wsk, groups)
    bitwise = torch.equal(gm, gm2) and torch.equal(gv, gv2)
    out = fwd(xk, wsk, wtb, gm, gv, scale, bias, groups)
    pm, pv = C.reference_stats(x, ws, groups)
    # pass B given the same statistics, so its check isolates pass B
    pout = C.reference_chain(x, ws, wt, scale, bias, gm, gv, groups)
    torch.cuda.synchronize()
    e_stats = max((gm - pm).abs().max().item(), (gv - pv).abs().max().item())
    e_fwd = (out.float() - pout.float()).abs().max().item()
    # tolerances: bf16 rounding of the spatial conv differs with the
    # summation order (one bf16 ulp on some mid values), which moves the
    # statistics by a small fraction of an ulp and the bf16 output by a
    # few ulps (as tests/test_conv21d.py allows)
    ok = (torch.allclose(gm, pm, rtol=1e-2, atol=1e-3)
          and torch.allclose(gv, pv, rtol=1e-2, atol=1e-3)
          and torch.allclose(out.float(), pout.float(), rtol=0.1, atol=0.05))
    npix = x.shape[0] * x.shape[1] * x.shape[2] * x.shape[3]
    ops_s = 2.0 * npix * 9 * cin * m
    bytes_s = xk.numel() * 2 + wsk.numel() * 2 + 2 * groups * m * 4
    ops_f = ops_s + 2.0 * npix * 3 * m * cout
    bytes_f = (xk.numel() * 2 + wsk.numel() * 2 + wtb.numel() * 2
               + 2 * groups * m * 4 + 2 * m * 4 + npix * cout * 2)
    ms_s = time_ms(lambda: stats(xk, wsk, groups))
    ms_f = time_ms(lambda: fwd(xk, wsk, wtb, gm, gv, scale, bias, groups))
    return ok, bitwise, {"stats": (ms_s, e_stats, ops_s, bytes_s),
                         "fwd": (ms_f, e_fwd, ops_f, bytes_f)}


def log_stats_plan(plan, stats, plain_ms, bitwise):
    """K2's launch plan at one site (resident blocks per SM from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor beside the plan's
    assumption), its achieved bf16 rate on the operations the pass must do,
    its time over the plain pass's, and whether two launches agreed
    bitwise."""
    from cstp_tpu_torch.ops import conv21d as C

    kms, _, ops, _ = stats
    tflops = ops / (kms * 1e-3) / 1e12
    log(f"[conv21d]   K2 plan: P {plan['P']} rows, {plan['stages']} stages, "
        f"mid chunk {plan['bn']}, warp tile 32x{8 * plan['ni']}, "
        f"{plan['tiles']} row tiles, {plan['tpb']} per block, "
        f"{plan['blocks']} blocks, {C.stats_occupancy(plan)} resident per SM "
        f"(plan {C.STATS_PER_SM}), {plan['smem']} B shared | "
        f"{tflops:.1f} TFLOP/s, {tflops * 1e12 / PEAK_BF16:.1%} of the bf16 "
        f"peak | K2 / plain stats {kms / plain_ms:.2f}x | two launches "
        f"bitwise equal: {bitwise}")


def log_fwd_plan(plan, fwd, plain_ms):
    """K3's launch plan at one site (resident blocks per SM from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor), its achieved bf16 rate
    on the operations the pass must do, and its time over the plain
    chain's. Its registers and spills are phase 1's ptxas lines."""
    from cstp_tpu_torch.ops import conv21d as C

    kms, _, ops, _ = fwd
    tflops = ops / (kms * 1e-3) / 1e12
    log(f"[conv21d]   K3 plan: P {plan['P']} rows, {plan['stages']} stages, "
        f"ring {plan['ring_slots']} frames, {plan['blocks']} row tiles x "
        f"cluster {plan['cluster']} = {plan['blocks'] * plan['cluster']} "
        f"blocks, {C.fwd_occupancy(plan)} resident per SM, "
        f"{plan['smem']} B shared, mid chunk {plan['bn']}, out chunk "
        f"{plan['bno']}, warp tile 32x{8 * plan['ni']}, L2 reads "
        f"{plan['l2_bytes'] / 1e9:.3f} GB | {tflops:.1f} TFLOP/s, "
        f"{tflops * 1e12 / PEAK_BF16:.1%} of the bf16 peak | K3 / plain chain "
        f"{kms / plain_ms:.2f}x")


def phase_conv21d(dev):
    """Both conv kernel pairs against the plain chain at the four sites,
    and K4a/K4b at the benchmark's default shape. K2/K3 (``stats``, ``fwd``)
    are summed over one pretrain step's launches; K4a/K4b (``stats_taps9``,
    ``fwd_taps9``) are one launch at the benchmark's shape, their main
    path."""
    from cstp_tpu_torch.ops import conv21d as C

    gen = torch.Generator(device=dev).manual_seed(0)
    res = {k: dict(ms=0.0, plain_ms=0.0, bound=0.0, ops_ms=0.0, bytes_ms=0.0,
                   err=0.0) for k in ("stats", "fwd", "stats_taps9",
                                      "fwd_taps9")}
    # (site, N, T, H=W, Cin, M, Cout, {tiling: weight in the record})
    shapes = [(site, 2 * B_VIEW, t, hw, cin, m, cout,
               {"clip": TOWERS * calls, "taps9": 0})
              for site, t, hw, cin, m, cout, calls in SITES]
    shapes.append((*BENCH_SHAPE, {"taps9": 1}))
    for site, n, t, hw, cin, m, cout, weights in shapes:
        def rnd(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device=dev) * std
        x = rnd(n, t, hw, hw, cin).to(torch.bfloat16)
        ws = rnd(3, 3, cin, m, std=(9 * cin) ** -0.5)
        wt = rnd(3, m, cout, std=(3 * m) ** -0.5)
        scale = 0.5 + torch.rand(m, generator=gen, device=dev)
        bias = rnd(m, std=0.1)
        gm, gv = C.reference_stats(x, ws, G)
        pms = {"stats": time_ms(lambda: C.reference_stats(x, ws, G)),
               "fwd": time_ms(lambda: C.reference_chain(x, ws, wt, scale, bias,
                                                        gm, gv, G))}
        log(f"[conv21d] {site} N={n} T={t} {hw}x{hw} Cin={cin} M={m} "
            f"Cout={cout}: plain stats {pms['stats']:.3f} ms, plain fwd "
            f"{pms['fwd']:.3f} ms")
        ms = {}
        for tiling, weight in weights.items():
            ok, bitwise, passes = _hold_pair(tiling, x, ws, wt, scale, bias)
            parts = []
            for p, (kms, err, ops, nb) in passes.items():
                b, by = bound_ms(ops, nb, PEAK_BF16)
                ms[tiling, p] = kms
                parts.append(f"{p} err {err:.3e} {kms:.3f} ms, bound {b:.3f} "
                             f"ms ({by})")
                r = res[p if tiling == "clip" else f"{p}_taps9"]
                r["ms"] += weight * kms
                r["plain_ms"] += weight * pms[p]
                r["bound"] += weight * b
                r["ops_ms"] += weight * ops / PEAK_BF16 * 1e3
                r["bytes_ms"] += weight * nb / PEAK_BYTES * 1e3
                r["err"] = max(r["err"], err)
            log(f"[conv21d]   {tiling:5s}: " + " | ".join(parts)
                + " | tol stats rtol 1e-2 atol 1e-3, fwd rtol 0.1 atol 0.05"
                " | library_ms null")
            if not ok:
                raise SystemExit(f"conv21d {tiling} kernels disagree with "
                                 f"their plain version at {site}")
            if tiling == "clip":
                log_stats_plan(C.plan_stats(n, t, hw, hw, cin, m, G),
                               passes["stats"], pms["stats"], bitwise)
                log_fwd_plan(C.plan_fwd(n, t, hw, hw, cin, m, cout),
                             passes["fwd"], pms["fwd"])
                if not bitwise:
                    raise SystemExit(f"two launches of K2 gave different "
                                     f"statistics at {site}")
        if "clip" in weights:
            log(f"[conv21d]   taps9 / clip time: stats "
                f"{ms['taps9', 'stats'] / ms['clip', 'stats']:.2f}x, fwd "
                f"{ms['taps9', 'fwd'] / ms['clip', 'fwd']:.2f}x")
        del x, gm, gv
        torch.cuda.empty_cache()
    for r in res.values():
        r["by"] = "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes"
    return res


def _aug_inputs(dev, gen, null: bool, n: int = 2 * B_VIEW, h0: int = H0,
                w0: int = W0):
    from cstp_tpu_torch.pretext.boxes import sample_pair_boxes

    frames = torch.randint(0, 256, (n, T, h0, w0, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    rot = torch.randint(0, 4, (n,), generator=gen, device=dev)
    box1, box2, _ = sample_pair_boxes(gen, rot[:n // 2], rot[n // 2:],
                                      float(w0), float(h0))
    box = torch.cat([box1, box2])
    if null:
        p = (torch.zeros(n, device=dev),
             torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev).repeat(n, 1),
             torch.eye(3, device=dev).repeat(n, T, 1, 1),
             torch.zeros(n, device=dev),
             torch.rand(n, generator=gen, device=dev) < 0.5)
    else:
        def u(lo, hi, *shape):
            return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
        ch = torch.randint(0, 3, (n, T), generator=gen, device=dev)
        gray = torch.nn.functional.one_hot(ch, 3).float()[:, :, None, :]
        p = (u(-10, 10, n),
             torch.stack([u(0.6, 1.4, n), u(0.6, 1.4, n), u(0.6, 1.4, n),
                          u(-0.1, 0.1, n)], 1),
             gray.expand(n, T, 3, 3).contiguous(),
             u(0.1, 2.0, n),
             torch.rand(n, generator=gen, device=dev) < 0.5)
    return frames, box, rot, p


def _aug_ops(box, p, n_out):
    """Operations the augment chain needs on this data (f32, not tensor
    cores): the separable resize's taps from the boxes, shears, blur,
    per-pixel jitter."""
    from cstp_tpu_torch.augment.ops import resample_weights

    wy = resample_weights(H0, S, box[:, 1], box[:, 3]) != 0   # (N, S, H0)
    wx = resample_weights(W0, S, box[:, 0], box[:, 2]) != 0   # (N, S, W0)
    ny, nx = wy.sum(2).float().sum(1), wx.sum(2).float().sum(1)
    rows, cols = wy.any(1).sum(1).float(), wx.any(1).sum(1).float()
    # per frame and channel, a multiply-add a tap in the cheaper order:
    # every source row in reach to S columns (nx taps), then every output
    # value over its ny row taps; or columns first, then rows
    resize = 2 * torch.minimum(rows * nx + S * ny, cols * ny + S * nx).sum()
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0], device=box.device)
    per_px = (resize * T * 3
              # rotated clips: three 2-tap shears, 4 operations a tap pair
              + (p[0] != 0).sum() * T * S * S * 3 * 3 * 4
              # blurred clips: two 15-tap passes, a multiply-add a tap
              + (p[3] > 0).sum() * T * S * S * 3 * 2 * 15 * 2
              # jittered clips: about 40 operations a pixel (no hue branch)
              + (p[1] != ident).any(1).sum() * T * S * S * 40)
    # every value: its row of the 3x3 gray mix (3 multiplies, 2 adds) and
    # the 'tf' normalisation (scale, shift, two-sided clamp: 5)
    return float(per_px) + n_out * (5 + 5)


def augment_stage_times(dev, h0: int = H0, w0: int = W0):
    """K5's time (bf16 output, 'tf') at 2 * B_VIEW clips of T x h0 x w0 ->
    S with the sampled parameters, then with each optional stage switched
    off through its identity parameters, which the kernel skips: angle 0
    (no shears), factors (1, 1, 1, 0) (no jitter), sigma 0 (no blur), and
    all three off with every rotk even, then odd (the rot90 index map).
    Returns {variant: ms}."""
    from cstp_tpu_torch.ops import augment as A

    gen = torch.Generator(device=dev).manual_seed(6)
    frames, box, rot, (angle, factors, graymix, sigma, flip) = _aug_inputs(
        dev, gen, False, h0=h0, w0=w0)
    n = frames.shape[0]
    zero = torch.zeros(n, device=dev)
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev).repeat(n, 1)
    variants = {
        "all stages": (rot, angle, factors, sigma),
        "no shears": (rot, zero, factors, sigma),
        "no jitter": (rot, angle, ident, sigma),
        "no blur": (rot, angle, factors, zero),
        "resize + gray + normalize, rotk even": (rot - rot % 2, zero, ident,
                                                 zero),
        "resize + gray + normalize, rotk odd": (rot | 1, zero, ident, zero),
    }
    times = {}
    for name, (r, a, f, sg) in variants.items():
        times[name] = time_ms(lambda: A.fused_augment_clips(
            frames, box, r, a, f, graymix, sg, flip, sample_size=S))
    log(f"[augment] stages, N={n} T={T} {h0}x{w0} -> {S} (ms): " + " | ".join(
        f"{k} {v:.3f}" for k, v in times.items()))
    return times


def _augment_check(name, inputs, s, dtype, tol):
    """Holds K5 against its plain float32 chain on ``inputs`` (frames, box,
    rotk, parameters) at sample size ``s`` and output ``dtype``, for both
    norms; exits on a mismatch. Returns the larger max abs error."""
    from cstp_tpu_torch.ops import augment as A

    fr, bx, rt, pp = inputs
    worst = 0.0
    for norm in ("tf", "imagenet"):
        got = A.fused_augment_clips(fr, bx, rt, *pp, sample_size=s,
                                    norm_method=norm, out_dtype=dtype)
        want = A.fused_augment_clips_plain(fr, bx, rt, *pp, sample_size=s,
                                           norm_method=norm,
                                           out_dtype=torch.float32)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        log(f"[augment] {name}, N={fr.shape[0]} {fr.shape[2]}x"
            f"{fr.shape[3]} -> {s}, norm={norm}: max abs err {err:.3e} "
            f"(tol {tol:g})")
        if not (err <= tol and got.dtype == dtype
                and got.shape == (fr.shape[0], T, s, s, 3)):
            raise SystemExit(f"augment kernel ({name}) disagrees with its "
                             "plain version")
        worst = max(worst, err)
        del got, want
    return worst


def phase_augment(dev):
    from cstp_tpu_torch.ops import augment as A

    gen = torch.Generator(device=dev).manual_seed(1)
    null = _aug_inputs(dev, gen, True)
    sampled = _aug_inputs(dev, gen, False)
    native = _aug_inputs(dev, gen, False, n=2, h0=NATIVE_HW[0],
                         w0=NATIVE_HW[1])
    # Tolerances against the plain float32 chain. bf16 2e-2 as
    # tests/test_pallas_augment.py: f32 summation order plus the output's
    # rounding (half an ulp <= 7.8e-3 below |v| = 4). float32 has no output
    # rounding, and the kernel rounds the resample's scale and sample
    # positions as the plain version does on the card: what is left is the
    # float32 summation order of the resample, blur and luma mean, about
    # 1e-5 on normalised values (some 30 roundings of values <= 255, each
    # within 2^-24 relative, over a scale of 127.5), kept here tenfold:
    # 1e-4. Native-size frames (256x340, resample rows of up to 17 taps)
    # hold each output dtype's tolerance, at S = 112 and at S = 224, where
    # the frame is in device memory. The bf16 cases at the main shape give
    # the kernels line's max_abs_err.
    cases = (("null=True", null, S, torch.bfloat16, 2e-2),
             ("null=False", sampled, S, torch.bfloat16, 2e-2),
             ("float32 out", sampled, S, torch.float32, 1e-4),
             ("native bf16 out", native, S, torch.bfloat16, 2e-2),
             ("native float32 out", native, S, torch.float32, 1e-4),
             ("native bf16 out, frame in device memory", native, S_LARGE,
              torch.bfloat16, 2e-2),
             ("native float32 out, frame in device memory", native, S_LARGE,
              torch.float32, 1e-4))
    err_max = 0.0
    for name, inputs, s, dtype, tol in cases:
        err = _augment_check(name, inputs, s, dtype, tol)
        if inputs is not native and dtype == torch.bfloat16:
            err_max = max(err_max, err)
    frames, box, rot, p = sampled
    ms = time_ms(lambda: A.fused_augment_clips(frames, box, rot, *p,
                                               sample_size=S))
    pms = time_ms(lambda: A.fused_augment_clips_plain(
        frames, box, rot, *p, sample_size=S), iters=3, warmup=1)
    n_out = frames.shape[0] * T * S * S * 3
    nbytes = frames.numel() + n_out * 2 + frames.shape[0] * (T * 9 + 12) * 4
    b, by = bound_ms(_aug_ops(box, p, n_out), nbytes, PEAK_F32)
    log(f"[augment] N={frames.shape[0]} T={T} {H0}x{W0} -> {S}: "
        f"{ms:.3f} ms, plain {pms:.3f} ms, bound {b:.4f} ms "
        f"({by}) | library_ms null")
    del null, sampled, native
    augment_stage_times(dev)
    augment_stage_times(dev, *NATIVE_HW)
    augment_large_time(dev)
    return err_max, dict(ms=ms, plain_ms=pms, bound=b, by=by)


def augment_large_time(dev):
    """K5 at 2 * B_VIEW clips of T native 256x340 frames -> S_LARGE, its
    frame in device memory: the i3d_byol pretrain step's shape, where one
    wrapper call makes more than one device launch. Held against its plain
    float32 chain in bf16 (2e-2) and float32 (1e-4) out, both norms, as
    phase_augment's cases; then its time (bf16, 'tf') beside the plain
    version's."""
    from cstp_tpu_torch.ops import augment as A

    gen = torch.Generator(device=dev).manual_seed(7)
    inputs = _aug_inputs(dev, gen, False, h0=NATIVE_HW[0], w0=NATIVE_HW[1])
    frames, box, rot, p = inputs
    n = frames.shape[0]
    chunk, per_launch = A.launch_plan(n, T, S_LARGE, NATIVE_HW[1])
    if per_launch >= n:
        raise SystemExit(f"launch_plan({n}, {T}, {S_LARGE}, {NATIVE_HW[1]}) "
                         f"puts all {n} clips in one launch: this case no "
                         "longer holds a second launch")
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        _augment_check(f"{str(dtype).split('.')[-1]} out, {per_launch} "
                       "clips per launch", inputs, S_LARGE, dtype, tol)
    torch.cuda.empty_cache()
    ms = time_ms(lambda: A.fused_augment_clips(frames, box, rot, *p,
                                               sample_size=S_LARGE))
    pms = time_ms(lambda: A.fused_augment_clips_plain(
        frames, box, rot, *p, sample_size=S_LARGE), iters=3, warmup=1)
    log(f"[augment] N={n} T={T} {NATIVE_HW[0]}x{NATIVE_HW[1]} -> {S_LARGE}, "
        f"frame in device memory ({per_launch} clips per launch, chunk "
        f"{chunk} rows, {A.smem_bytes(S_LARGE, NATIVE_HW[1], chunk, False)} B "
        f"shared): {ms:.3f} ms, plain {pms:.3f} ms")
    return ms, pms


def augment_hashes(dev):
    """{dtype: SHA-256 prefix of K5's output}: 2 * B_VIEW clips of T x 128 x
    171 -> S with sampled parameters (generator seed 8), bf16 and float32
    out, 'tf'."""
    import hashlib

    from cstp_tpu_torch.ops import augment as A

    gen = torch.Generator(device=dev).manual_seed(8)
    frames, box, rot, p = _aug_inputs(dev, gen, False)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        y = A.fused_augment_clips(frames, box, rot, *p, sample_size=S,
                                  out_dtype=dtype)
        if dtype == torch.bfloat16:
            y = y.view(torch.int16)
        out[str(dtype).split(".")[-1]] = hashlib.sha256(
            y.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def phase_hashes(dev):
    """K2/K3 and K4a/K4b output hashes at the four sites
    (``perf/sweep_conv21d_fwd.py --hash``) and K5's at the slice shape,
    each beside commit 0cb95b4's (``HASHES_0CB95B4``). Exits if K4a/K4b's
    differ from K2/K3's. Returns {name: (hash, hash at 0cb95b4)}."""
    from cstp_tpu_torch.perf import sweep_conv21d_fwd as sweep

    got = {}
    for tiling, (k_fwd, k_stats) in sweep.KERNELS.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        for site, (h_out, h_stats, _) in sweep.hash_outputs(gen,
                                                            tiling).items():
            got[f"{k_fwd} {site}"] = h_out
            got[f"{k_stats} {site}"] = h_stats
    for dtype, h in augment_hashes(dev).items():
        got[f"K5 {dtype}"] = h
    torch.cuda.empty_cache()
    res = {k: (h, HASHES_0CB95B4.get(k)) for k, h in got.items()}
    for k, (h, old) in res.items():
        if old is not None:
            log(f"[hash] {k}: {h}, at 0cb95b4 {old} "
                f"({'same' if h == old else 'DIFFERENT'})")
    for clip, taps9 in (("K3", "K4b"), ("K2", "K4a")):
        same = all(got[f"{clip} {s[0]}"] == got[f"{taps9} {s[0]}"]
                   for s in sweep.SITES)
        log(f"[hash] {taps9} at the four sites: " + ", ".join(
            got[f"{taps9} {s[0]}"] for s in sweep.SITES) + "; bitwise "
            f"{clip}'s: {same}")
        if not same:
            raise SystemExit(f"{taps9} is not bitwise {clip} on the same x")
    return res


def _slice_config(fused: bool, **over):
    from cstp_tpu_torch.config import Config

    kw = dict(model_name="r21d", model_depth=1, fused_conv=int(fused),
              pallas_augment="on" if fused else "off")
    kw.update(over)
    return Config(sample_duration=T, sample_size=S, batch_size=B_VIEW,
                  compute_dtype="bfloat16", task="loss_com", **kw).finalize()


def _slice_batch(dev, seed: int, n_pb: int = 5, hw=(H0, W0)):
    """uint8 frame pairs and pretext labels, as the data loader gives them
    (bench.py's synthetic batch: 16 x 128 x 171 frames, or ``hw``);
    playback labels below ``n_pb`` (the loader's are 0..3: C3D's, r3d's
    and I3D's heads have 4 classes, R(2+1)D's and S3D's 5)."""
    H, W = hw
    gen = torch.Generator(device=dev).manual_seed(seed)

    def labels(k):
        return torch.randint(0, k, (B_VIEW,), generator=gen, device=dev)

    frames = [torch.randint(0, 256, (B_VIEW, T, H, W, 3), generator=gen,
                            device=dev, dtype=torch.uint8) for _ in range(2)]
    return dict(frames1=frames[0], frames2=frames[1], rot1=labels(4),
                rot2=labels(4), tem=labels(5), pb=labels(n_pb))


def _launch_counts():
    from cstp_tpu_torch.ops import launch_counts

    return launch_counts()


def _reset_launch_counts():
    from cstp_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def phase_slice(dev, card: str, steps: int = 3, profile: bool = True):
    """The pretrain step through its entry points, kernels on; then one
    step under the profiler (``profile``)."""
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    cfg = _slice_config(fused=True)
    model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
    step = make_pretrain_step(model, tx, cfg)
    batch = _slice_batch(dev, seed=2)
    gen = torch.Generator(device=dev).manual_seed(3)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, m = step(state, gen, batch, cfg.learning_rate)     # warm-up
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, m = step(state, gen, batch, cfg.learning_rate)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    counts = _launch_counts()
    losses = torch.stack(losses).float().cpu()
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in model.named_parameters()
                if n.startswith("online_net."))
    log(f"[slice] r21d depth 1, {T}x{S}^2 bf16, per-view batch {B_VIEW}, "
        f"fused_conv=1 pallas_augment=on: {steps} steps, {dt * 1e3:.1f} ms/step,"
        f" {B_VIEW / dt:.1f} clip pairs/s ({card}); losses "
        f"{[round(v, 4) for v in losses.tolist()]}; max |online param change|"
        f" {moved:.3e}; launches {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    want = {"conv21d_stats": 10 * steps, "conv21d_fwd": 10 * steps,
            "conv21d_taps9_stats": 0, "conv21d_taps9_fwd": 0,
            "augment": steps}
    if counts != want:
        raise SystemExit(f"launch counts {counts}, expected {want}")
    if not bool(torch.isfinite(losses).all()) or moved <= 0.0:
        raise SystemExit("the pretrain step gave non-finite losses or left "
                         "the online parameters unchanged")
    if profile:
        profile_step(lambda: step(state, gen, batch, cfg.learning_rate))
    return dict(counts=counts, step_ms=dt * 1e3, pairs_per_s=B_VIEW / dt)


def profile_step(run, top: int = 12):
    """One more step under torch.profiler: the device's busy share of the
    step's wall time (union of kernel intervals) and device time by kernel.
    Profiling slows the host side, so the wall time here is not the step
    time above. Returns the wall, busy and per-kernel device ms (None when
    the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log("[profile] torch.profiler recorded no device time: not measured")
        return
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    log(f"[profile] one step: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({busy / wall_us:.1%}), {len(kernels)} device "
        f"events; device time by kernel:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[profile]   {us / 1e3:9.2f} ms  {name[:110]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                ms_by_kernel={k: v / 1e3 for k, v in by_name.items()})


def _slice_config_plain_f32(**over):
    from cstp_tpu_torch.config import Config

    kw = dict(model_name="r21d", model_depth=1)
    kw.update(over)
    return Config(sample_duration=T, sample_size=S, batch_size=B_VIEW,
                  compute_dtype="float32", fused_conv=0, pallas_augment="off",
                  task="loss_com", **kw).finalize()


def _one_step_run(dev, cfg, batch, timed_steps: int = 2):
    """One step of ``cfg`` from seed-0 weights and a generator seeded 5 on
    ``batch``: its metrics, the update of the trainable parameters (float64,
    flat), the BN running statistics after it, the launches it made and
    the peak of allocated memory over it; then ``timed_steps`` steps on,
    their mean ms."""
    from cstp_tpu_torch.train import optim
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
    p0 = {n: p.detach().clone() for n, p in optim.trainable(model).items()}
    step = make_pretrain_step(model, tx, cfg)
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    state, m = step(state, gen, batch, cfg.learning_rate)
    torch.cuda.synchronize()
    counts = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    update = torch.cat([(p.detach() - p0[n]).flatten().double()
                        for n, p in optim.trainable(model).items()])
    stats = _snapshot(model, buffers=True)
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        state, _ = step(state, gen, batch, cfg.learning_rate)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed_steps * 1e3
    del model, state, tx, step, p0
    torch.cuda.empty_cache()
    return dict(metrics={k: float(v) for k, v in m.items()}, update=update,
                stats=stats, counts=counts, ms=ms, peak_gib=peak_gib)


def _cos(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a["update"], b["update"], dim=0))


def _agree(run, ref, f32):
    """Phase 4's rule for ``run`` against ``ref`` (a bf16 step of the same
    weights, generator and batch), with the float32 step ``f32`` as
    arbiter: ``(loss_err, acc_err, cos_run, cos_ref, ok)``.

    Tolerances. Losses: both bf16 paths round the same values in another
    summation order, so loss terms agree to a few bf16 ulps (2e-2 relative)
    and an accuracy may flip by two of 16 predictions. The update: the
    gradient of this network is ill conditioned (BatchNorm backward of
    pooled features cancels to a small residual), so bf16 rounding alone
    turns its direction; ``run`` must stay as close to the float32 update
    as ``ref`` does (cosine within 0.05 of it)."""
    mk, mp = run["metrics"], ref["metrics"]
    loss_err = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-6)
                   for k in mk if k.startswith("loss"))
    acc_err = max(abs(mk[k] - mp[k]) for k in mk if k.startswith("acc"))
    cos_run, cos_ref = _cos(run, f32), _cos(ref, f32)
    ok = loss_err <= 2e-2 and acc_err <= 0.125 and cos_run >= cos_ref - 0.05
    return loss_err, acc_err, cos_run, cos_ref, ok


def phase_parity(dev, timed_steps: int = 2, over=None, tag: str = "parity"):
    """One step from the same weights, generator seed and batch through
    three configurations: the kernels (bf16, fused_conv=1,
    pallas_augment=on), the plain bf16 configuration (fused_conv=0,
    pallas_augment=off) and the plain configuration in float32, which
    arbitrates (``_agree``). Then the step time of each. ``over``: config
    flags set in all three (phase 13's per-view calls and optimizers)."""
    over = over or {}
    batch = _slice_batch(dev, seed=4)
    runs = {name: _one_step_run(dev, cfg, batch, timed_steps)
            for name, cfg in (("kernel", _slice_config(True, **over)),
                              ("plain", _slice_config(False, **over)),
                              ("f32", _slice_config_plain_f32(**over)))}
    mk, mp, mf = (runs[n]["metrics"] for n in ("kernel", "plain", "f32"))
    loss_err, acc_err, cos_k, cos_p, ok = _agree(
        runs["kernel"], runs["plain"], runs["f32"])
    log(f"[{tag}] kernel vs plain bf16 step: loss {mk['loss']:.5f} vs "
        f"{mp['loss']:.5f} (float32 {mf['loss']:.5f}); max rel loss-term err "
        f"{loss_err:.3e} (tol 2e-2); max accuracy diff {acc_err:.4f} "
        f"(tol 0.125); update cosine to the float32 update: kernel "
        f"{cos_k:.5f}, plain {cos_p:.5f} (tol kernel >= plain - 0.05); "
        f"kernel vs plain {_cos(runs['kernel'], runs['plain']):.5f}")
    log(f"[{tag}] step ms ({timed_steps} steps after the first): kernel "
        f"{runs['kernel']['ms']:.1f}, plain bf16 {runs['plain']['ms']:.1f}, "
        f"plain float32 {runs['f32']['ms']:.1f}")
    if not ok:
        raise SystemExit(f"[{tag}] the kernel step and the plain step "
                         "disagree")
    return dict(loss_err=loss_err, acc_err=acc_err, cos_k=cos_k,
                cos_p=cos_p, step_ms={n: r["ms"] for n, r in runs.items()})


def phase_bench(dev):
    """The conv-block benchmark entry at its default shapes, once per
    tiling, each run with the launch counts set to 0 before it and read
    after it. The taps9 run's fused forward must launch K4a/K4b and not
    K2/K3 (its fused gradient takes the default tiling, "clip"); the two
    tilings' outputs must agree on one seeded input."""
    from cstp_tpu_torch.ops import conv21d as C
    from cstp_tpu_torch.perf import bench_conv21d as bench

    runs = {}
    for tiling in ("taps9", "clip"):
        _reset_launch_counts()
        r = bench.main(["--tiling", tiling, "--mode", "both"])
        runs[tiling] = (r, _launch_counts())
        torch.cuda.empty_cache()
    pair = {"taps9": {"stats_taps9", "fwd_taps9"}, "clip": {"stats", "fwd"}}
    for tiling, (r, counts) in runs.items():
        fwd = r["launches"]["fused_fwd"]
        log(f"[bench] tiling={tiling}: " + ", ".join(
            f"{v} {r[v]:.3f} ms" for v in bench.VARIANTS)
            + f"; fused forward launches {fwd}; whole run {counts}")
        if {k for k, v in fwd.items() if v} != pair[tiling]:
            raise SystemExit(f"the {tiling} bench run's fused forward "
                             f"launched {fwd}, expected only {pair[tiling]}")
    _, n, t, hw, cin, m, cout = BENCH_SHAPE
    x, ws, wt, scale, bias = bench.make_inputs(n, t, hw, cin, m, cout, dev)
    outs = {tl: C.fused_st_conv(x, ws, wt, scale, bias, G, 1e-5, tl)[0]
            for tl in C.TILINGS}
    a, b = outs["taps9"].float(), outs["clip"].float()
    err = (a - b).abs().max().item()
    log(f"[bench] taps9 vs clip fused forward on the bench input: max abs "
        f"diff {err:.3e} (tol rtol 0.1 atol 0.05)")
    if not torch.allclose(a, b, rtol=0.1, atol=0.05):
        raise SystemExit("the taps9 and clip tilings disagree")
    del x, outs, a, b
    torch.cuda.empty_cache()
    return runs["taps9"][1]

# ------------------------------------------------------------ finetune/test

B_FT = 64               # finetune batch: one BN group of 64 clips
N_FT_CLASSES = 101      # UCF101
FT_LAUNCHES = 5         # fused sites of one tower: conv2 x 2, conv3..conv5


def _ft_config(fused: int = 1, dtype: str = "bfloat16", **over):
    from cstp_tpu_torch.config import Config

    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B_FT, compute_dtype=dtype,
              fused_conv=fused, task="ft_all",
              n_finetune_classes=N_FT_CLASSES)
    kw.update(over)
    return Config(**kw).finalize()


def _ft_batch(dev, seed: int, hw=(H0, W0)):
    n = B_FT
    gen = torch.Generator(device=dev).manual_seed(seed)
    return dict(frames=torch.randint(0, 256, (n, T, *hw, 3), generator=gen,
                                     device=dev, dtype=torch.uint8),
                labels=torch.randint(0, N_FT_CLASSES, (n,), generator=gen,
                                     device=dev))


BENCH_STEP_BS = 64      # bench_step's default per-chip batch (bench.py's)
# K2/K3's inputs on the paths this file drives after phase 2, as (path,
# clips N at a site, BN groups): the finetune step (and bench_step --mode
# ft), one group of B_FT; a grad_accum=2 pretrain microbatch, B_VIEW / 2
# clips per view in each of 2 groups; bench_step --mode pretrain, per-view
# batch 64 in 2 groups
PATH_SHAPES = [("finetune", B_FT, 1),
               ("grad_accum=2 microbatch", B_VIEW, G),
               ("bench_step pretrain", 2 * BENCH_STEP_BS, G)]


def phase_conv21d_paths(dev, shapes=PATH_SHAPES):
    """K2/K3 against the plain chain at the four sites for every shape of
    ``shapes`` (path, clips, BN groups), with phase 2's tolerances and K2's
    bitwise repeat. The finetune shape's times (kernel and plain) are
    summed over the finetune step's launches."""
    from cstp_tpu_torch.ops import conv21d as C

    gen = torch.Generator(device=dev).manual_seed(9)
    tot = {p: dict(ms=0.0, plain_ms=0.0, bound=0.0) for p in ("stats", "fwd")}
    for path, n, groups in shapes:
        for site, t, hw, cin, m, cout, calls in SITES:
            def rnd(*shape, std=1.0):
                return torch.randn(shape, generator=gen, device=dev) * std
            x = rnd(n, t, hw, hw, cin).to(torch.bfloat16)
            ws = rnd(3, 3, cin, m, std=(9 * cin) ** -0.5)
            wt = rnd(3, m, cout, std=(3 * m) ** -0.5)
            scale = 0.5 + torch.rand(m, generator=gen, device=dev)
            bias = rnd(m, std=0.1)
            ok, bitwise, passes = _hold_pair("clip", x, ws, wt, scale, bias,
                                             groups)
            pms = {}
            if path == "finetune":
                gm, gv = C.reference_stats(x, ws, 1)
                pms = {"stats": time_ms(lambda: C.reference_stats(x, ws, 1)),
                       "fwd": time_ms(lambda: C.reference_chain(
                           x, ws, wt, scale, bias, gm, gv, 1))}
                del gm, gv
            parts = []
            for p, (kms, err, ops, nb) in passes.items():
                b, _ = bound_ms(ops, nb, PEAK_BF16)
                part = f"{p} err {err:.3e} {kms:.3f} ms (bound {b:.3f}"
                if pms:
                    tot[p]["ms"] += calls * kms
                    tot[p]["plain_ms"] += calls * pms[p]
                    tot[p]["bound"] += calls * b
                    part += f", plain {pms[p]:.3f}"
                parts.append(part + ")")
            log(f"[path-conv21d] {path}: {site} N={n} T={t} {hw}x{hw} "
                f"{groups} BN group(s): " + " | ".join(parts)
                + f" | K2 bitwise on repeat: {bitwise}")
            if not (ok and bitwise):
                raise SystemExit(f"K2/K3 disagree with their plain version "
                                 f"at {site}, {n} clips in {groups} BN "
                                 f"group(s) ({path})")
            del x
            torch.cuda.empty_cache()
    k2, k3 = tot["stats"], tot["fwd"]
    if all(path != "finetune" for path, _, _ in shapes):
        return tot
    log(f"[path-conv21d] per finetune step ({FT_LAUNCHES} launches each):"
        f" K2 {k2['ms']:.3f} ms (plain {k2['plain_ms']:.3f}, bound "
        f"{k2['bound']:.3f}), K3 {k3['ms']:.3f} ms (plain "
        f"{k3['plain_ms']:.3f}, bound {k3['bound']:.3f})")
    return tot


def _snapshot(model, buffers: bool = False):
    named = model.named_buffers() if buffers else model.named_parameters()
    return {n: t.detach().clone() for n, t in named}


def phase_finetune(dev, card: str, steps: int = 3):
    """The finetune step through its entry points, kernels on: R(2+1)D
    depth 1, 16 x 112^2, bf16, batch B_FT, 101 classes, fused_conv=1,
    task ft_all; one warm-up, ``steps`` timed steps, 5 + 5 K2/K3 launches
    per step and no augment launch. Then one ft_fc step from the same
    state: the backbone's parameters stay bitwise, the head and the
    backbone's BN running statistics move. Returns the model and state."""
    from cstp_tpu_torch.train import finetune as ft
    from cstp_tpu_torch.train import optim
    from cstp_tpu_torch.train.pretrain import TrainState

    cfg = _ft_config()
    model, state, tx = ft.create_finetune_state(cfg, N_FT_CLASSES, seed=0,
                                                device=dev)
    step = ft.make_finetune_step(model, tx, cfg)
    batch = _ft_batch(dev, seed=10)
    gen = torch.Generator(device=dev).manual_seed(11)
    before = _snapshot(model)
    state, m = step(state, gen, batch, cfg.learning_rate)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, m = step(state, gen, batch, cfg.learning_rate)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    counts = _launch_counts()
    losses = torch.stack(losses).float().cpu()
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in model.named_parameters())
    log(f"[finetune] r21d depth 1, {T}x{S}^2 bf16, batch {B_FT}, "
        f"{N_FT_CLASSES} classes, fused_conv=1, ft_all: {steps} steps, "
        f"{dt * 1e3:.1f} ms/step, {B_FT / dt:.1f} clips/s ({card}); losses "
        f"{[round(v, 4) for v in losses.tolist()]}; max |param change| "
        f"{moved:.3e}; launches {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    want = {"conv21d_stats": FT_LAUNCHES * steps,
            "conv21d_fwd": FT_LAUNCHES * steps, "conv21d_taps9_stats": 0,
            "conv21d_taps9_fwd": 0, "augment": 0}
    if counts != want:
        raise SystemExit(f"finetune launch counts {counts}, expected {want}")
    if not bool(torch.isfinite(losses).all()) or moved <= 0.0:
        raise SystemExit("the finetune step gave non-finite losses or left "
                         "the parameters unchanged")

    cfg_fc = _ft_config(task="ft_fc")
    tx_fc = ft.finetune_optimizer(cfg_fc, model)
    state_fc = TrainState(state.step, model,
                          tx_fc.init(optim.trainable(model)))
    step_fc = ft.make_finetune_step(model, tx_fc, cfg_fc)
    params0, stats0 = _snapshot(model), _snapshot(model, buffers=True)
    _reset_launch_counts()
    state_fc, m = step_fc(state_fc, gen, batch, cfg.learning_rate)
    torch.cuda.synchronize()
    counts = _launch_counts()
    params1, stats1 = _snapshot(model), _snapshot(model, buffers=True)
    backbone_same = all(torch.equal(params1[n], params0[n]) for n in params0
                        if n.startswith("online_net."))
    head_moved = all(not torch.equal(params1[n], params0[n]) for n in params0
                     if n.startswith("classify."))
    stats_moved = all(not torch.equal(stats1[n], stats0[n]) for n in stats0
                      if n.startswith("online_net."))
    log(f"[finetune] one ft_fc step from the same state: loss "
        f"{float(m['loss']):.4f}; backbone parameters bitwise unchanged: "
        f"{backbone_same}; every classify parameter moved: {head_moved}; "
        f"every backbone BN statistic moved: {stats_moved}; launches {counts}")
    if not (backbone_same and head_moved and stats_moved
            and math.isfinite(float(m["loss"]))
            and counts["conv21d_stats"] == FT_LAUNCHES
            and counts["conv21d_fwd"] == FT_LAUNCHES):
        raise SystemExit("the ft_fc step trained the frozen backbone, left "
                         "the head or the BN statistics still, or launched "
                         "other kernels than the forward's")
    return dict(step_ms=dt * 1e3, clips_per_s=B_FT / dt, model=model,
                state=state_fc)


def phase_finetune_parity(dev, timed_steps: int = 2, over=None,
                          tag: str = "ft-parity"):
    """One finetune step from the same weights and the same pre-augmented
    batch through fused_conv=1 (bf16), fused_conv=0 (bf16) and fused_conv=0
    in float32, which arbitrates; PERF.md section 2's rule. Then each one's
    step time on the same batch. ``over``: config flags set in all three
    (phase 16's ``--legacy_pace``). Returns each run's launches in its
    first step, its step ms and its peak GiB."""
    from cstp_tpu_torch.augment.pipeline import finetune_train_augment_batch
    from cstp_tpu_torch.train import finetune as ft

    over = over or {}
    raw = _ft_batch(dev, seed=12)
    clips = finetune_train_augment_batch(
        torch.Generator(device=dev).manual_seed(13), raw["frames"],
        sample_size=S)
    batch = dict(clips=clips, labels=raw["labels"])
    del raw
    runs = {}
    for name, cfg in (("kernel", _ft_config(1, **over)),
                      ("plain", _ft_config(0, **over)),
                      ("f32", _ft_config(0, "float32", **over))):
        model, state, tx = ft.create_finetune_state(cfg, N_FT_CLASSES, seed=0,
                                                    device=dev)
        p0 = _snapshot(model)
        step = ft.make_preaugmented_finetune_step(model, tx, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launch_counts()
        state, m = step(state, batch, cfg.learning_rate)
        torch.cuda.synchronize()
        counts = _launch_counts()
        update = torch.cat([(p.detach() - p0[n]).flatten().double()
                            for n, p in model.named_parameters()])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            state, _ = step(state, batch, cfg.learning_rate)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / timed_steps * 1e3
        runs[name] = ({k: float(v) for k, v in m.items()}, update, ms,
                      counts, torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        del model, state, tx, step, p0
        torch.cuda.empty_cache()
    mk, mp, mf = (runs[n][0] for n in ("kernel", "plain", "f32"))

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(
            runs[a][1], runs[b][1], dim=0))

    cos_k, cos_p = cos("kernel", "f32"), cos("plain", "f32")
    loss_err = abs(mk["loss"] - mp["loss"]) / max(abs(mp["loss"]), 1e-6)
    acc_err = abs(mk["acc"] - mp["acc"])
    # the tolerances of phase 4 (PERF.md section 2): loss within 2e-2
    # relative, accuracy within 0.125, the kernel update's cosine to the
    # float32 update within 0.05 of the plain bf16 update's
    log(f"[{tag}] kernel vs plain bf16 finetune step: loss "
        f"{mk['loss']:.5f} vs {mp['loss']:.5f} (float32 {mf['loss']:.5f}); "
        f"rel loss err {loss_err:.3e} (tol 2e-2); accuracy diff "
        f"{acc_err:.4f} (tol 0.125); update cosine to the float32 update: "
        f"kernel {cos_k:.5f}, plain {cos_p:.5f} (tol kernel >= plain - 0.05);"
        f" kernel vs plain {cos('kernel', 'plain'):.5f}")
    log(f"[{tag}] finetune step ms ({timed_steps} steps after the first, "
        f"pre-augmented batch {B_FT}): kernel {runs['kernel'][2]:.1f} "
        f"({B_FT / runs['kernel'][2] * 1e3:.1f} clips/s, peak "
        f"{runs['kernel'][4]:.2f} GiB), plain bf16 {runs['plain'][2]:.1f} "
        f"(peak {runs['plain'][4]:.2f} GiB), plain float32 "
        f"{runs['f32'][2]:.1f}; first-step launches: kernel "
        f"{runs['kernel'][3]}, plain {runs['plain'][3]}")
    if not (loss_err <= 2e-2 and acc_err <= 0.125 and cos_k >= cos_p - 0.05):
        raise SystemExit(f"[{tag}] the kernel finetune step and the plain "
                         "one disagree")
    return dict(loss_err=loss_err, cos_k=cos_k, cos_p=cos_p,
                step_ms={n: r[2] for n, r in runs.items()},
                counts={n: r[3] for n, r in runs.items()},
                peak_gib={n: r[4] for n, r in runs.items()})


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_eval(dev, model, state, n_frames: int = 300, pb_rate: int = 4):
    """The eval and test entry points on the finetuned model, none of which
    may launch a kernel: ``make_eval_step`` on a batch of B_FT with a tail
    of masked rows; ``make_logits_step`` over the sliding windows of one
    synthetic video of ``n_frames`` frames (unpadded: eager PyTorch has no
    compiled program for ``pad_windows_to_bucket`` to serve); the features
    step on the same windows and on a batch of B_FT clips, and
    ``retrieval_recalls`` of half of those against the other half. Each is
    timed (host clock, synchronised, one call after one warm-up)."""
    from cstp_tpu_torch.train import finetune as ft

    cfg = _ft_config()
    eval_step = ft.make_eval_step(model, cfg)
    logits_step = ft.make_logits_step(model, cfg)
    feats_step = ft.make_features_step(model, cfg)
    batch = _ft_batch(dev, seed=14)
    n_real = B_FT * 7 // 8
    batch["mask"] = (torch.arange(B_FT, device=dev) < n_real).float()
    gen = torch.Generator(device=dev).manual_seed(15)
    video = torch.randint(0, 256, (n_frames, H0, W0, 3), generator=gen,
                          device=dev, dtype=torch.uint8)
    idx = ft.sliding_window_indices(n_frames, T, pb_rate)
    n_win = idx.shape[0]
    windows = video[torch.from_numpy(idx).to(dev).long()]
    eval_step(state, batch)                                   # warm-up
    logits_step(state, windows)
    feats_step(state, windows)
    _reset_launch_counts()
    out, ms_eval = _timed(lambda: eval_step(state, batch))
    logits, ms_logits = _timed(lambda: logits_step(state, windows))
    wfeat, ms_wfeat = _timed(lambda: feats_step(state, windows))
    feats, ms_feat = _timed(lambda: feats_step(state, batch["frames"]))
    labels = batch["labels"].cpu().numpy() % 8
    f = feats.cpu().numpy()
    half = B_FT // 2
    recalls, ms_ret = _timed(lambda: ft.retrieval_recalls(
        f[:half], labels[:half], f[half:], labels[half:], device=dev))
    counts = _launch_counts()
    video_pred = int(logits.mean(0).argmax())
    norms = torch.linalg.vector_norm(torch.cat([wfeat, feats]), dim=-1)
    log(f"[eval] eval step, batch {B_FT} ({n_real} unmasked): {ms_eval:.1f} "
        f"ms, loss {float(out['loss']):.4f}, acc {float(out['acc']):.4f}, "
        f"count {float(out['count']):.0f}")
    log(f"[eval] test: {n_frames}-frame video, pb_rate {pb_rate}: {n_win} "
        f"windows (unpadded), logits step {ms_logits:.1f} "
        f"ms, video class {video_pred}; features step {ms_wfeat:.1f} ms "
        f"({n_win} windows), {ms_feat:.1f} ms ({B_FT} clips); retrieval "
        f"{half} x {half}: {ms_ret:.1f} ms, {recalls}; launches {counts}")
    ok = (all(v == 0 for v in counts.values())
          and out["logits"].shape == (B_FT, N_FT_CLASSES)
          and float(out["count"]) == n_real
          and bool(torch.isfinite(out["logits"]).all())
          and logits.shape == (n_win, N_FT_CLASSES)
          and bool(torch.isfinite(logits).all())
          and wfeat.shape == (n_win, 512) and feats.shape == (B_FT, 512)
          and bool(((norms - 1).abs() < 1e-3).all())
          and all(0.0 <= v <= 1.0 for v in recalls.values()))
    if not ok:
        raise SystemExit("the eval/test phase launched a kernel or gave "
                         "output of the wrong shape or non-finite values")
    return dict(eval_ms=ms_eval, logits_ms=ms_logits, features_ms=ms_feat,
                retrieval_ms=ms_ret)


def phase_grad_accum(dev, card: str, steps: int = 2):
    """The pretrain step with grad_accum=2 at per-view batch B_VIEW (two
    microbatches of B_VIEW / 2), kernels on: 20/20/1 launches per step and
    finite losses."""
    import dataclasses

    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    cfg = dataclasses.replace(_slice_config(fused=True), grad_accum=2)
    cfg.finalize()
    model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
    step = make_pretrain_step(model, tx, cfg)
    batch = _slice_batch(dev, seed=16)
    gen = torch.Generator(device=dev).manual_seed(17)
    state, m = step(state, gen, batch, cfg.learning_rate)     # warm-up
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, m = step(state, gen, batch, cfg.learning_rate)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    counts = _launch_counts()
    losses = torch.stack(losses).float().cpu()
    log(f"[grad-accum] pretrain step, per-view batch {B_VIEW}, grad_accum 2 "
        f"(microbatches of {B_VIEW // 2}), kernels on: {dt * 1e3:.1f} "
        f"ms/step ({card}); losses {[round(v, 4) for v in losses.tolist()]};"
        f" launches {counts}")
    want = {"conv21d_stats": 20 * steps, "conv21d_fwd": 20 * steps,
            "conv21d_taps9_stats": 0, "conv21d_taps9_fwd": 0,
            "augment": steps}
    if counts != want or not bool(torch.isfinite(losses).all()):
        raise SystemExit(f"grad-accum launch counts {counts} (expected "
                         f"{want}) or non-finite losses")
    del model, state, tx, step
    torch.cuda.empty_cache()
    return dict(step_ms=dt * 1e3)


# mode -> (bench_step flags, expected launches per step)
BENCH_STEP_RUNS = {
    "pretrain": (["--fused-conv", "1", "--pallas-augment", "on"],
                 {"conv21d_stats": 10, "conv21d_fwd": 10, "augment": 1}),
    "ft": (["--fused-conv", "1"],
           {"conv21d_stats": FT_LAUNCHES, "conv21d_fwd": FT_LAUNCHES}),
    "eval": (["--fused-conv", "1"], {}),
}


def phase_bench_step(dev):
    """The step benchmark entry (``cstp_tpu_torch.perf.bench_step``) once
    per mode at bench.py's default shape (per-chip batch 64), kernels on,
    2 timed steps after 1 warm-up; each run's launches per step must be the
    mode's."""
    from cstp_tpu_torch.perf import bench_step

    out = {}
    for mode, (flags, want) in BENCH_STEP_RUNS.items():
        r = bench_step.main(["--mode", mode, "--steps", "2", "--warmup", "1",
                             *flags])
        torch.cuda.empty_cache()
        got = {k: v for k, v in r["launches_per_step"].items() if v}
        log(f"[bench-step] {mode}: {r['step_ms']:.1f} ms/step, peak "
            f"{r['peak_mem_gib']:.1f} GiB, launches per step {got}")
        if got != want or not math.isfinite(r["loss"]):
            raise SystemExit(f"bench_step --mode {mode} launched {got} per "
                             f"step (expected {want}) or lost its loss")
        out[mode] = r
    return out


# the cli phase: CSTPack files of raw 128x171 frames from the port's
# SyntheticVideoDataset (seed 0), 64 frames a video
CLI_FRAMES = 64
CLI_STEPS = 6           # pretrain steps per epoch
CLI_TRAIN = CLI_STEPS * BENCH_STEP_BS   # enough videos for per-view 64
CLI_EVAL = 32           # val and test videos
CLI_FT_STEPS = 4
CLI_JPEG_STEPS = 3      # the frame-dir JPEG epoch, per-view B_VIEW


def _cli_data(root: str):
    """Train, val and test CSTPack files (``build_dataset`` finds val and
    test by replacing "train" in the train file's path) and a frame
    directory of JPEGs with its split list; returns their paths."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from cstp_tpu_torch.data.packed import PackedWriter
    from cstp_tpu_torch.data.synthetic import SyntheticVideoDataset

    ds = SyntheticVideoDataset(n_videos=CLI_TRAIN + 2 * CLI_EVAL,
                               n_classes=N_FT_CLASSES, ingest_hw=(H0, W0),
                               seed=0)

    def frames(i):
        return ds.read_frames(i, range(CLI_FRAMES))

    paths = {k: os.path.join(root, f"{k}.cstp")
             for k in ("train", "val", "test")}
    spans = {"train": range(CLI_TRAIN),
             "val": range(CLI_TRAIN, CLI_TRAIN + CLI_EVAL),
             "test": range(CLI_TRAIN + CLI_EVAL, CLI_TRAIN + 2 * CLI_EVAL)}
    with ThreadPoolExecutor(8) as pool:
        for split, ids in spans.items():
            w = PackedWriter(paths[split])
            for lo in range(0, len(ids), 32):
                chunk = ids[lo:lo + 32]
                for i, f in zip(chunk, pool.map(frames, chunk)):
                    w.add_video_raw(f"v{i:04d}", ds.video_meta(i)[1], f)
            w.close()

        jpeg_dir, ann = os.path.join(root, "frames"), os.path.join(root, "ann")
        n_jpeg = CLI_JPEG_STEPS * B_VIEW
        os.makedirs(ann)

        def write_jpegs(i):
            d = os.path.join(jpeg_dir, f"v{i:04d}")
            os.makedirs(d)
            for k, f in enumerate(frames(i)):
                Image.fromarray(f).save(os.path.join(d, "%05d.jpg" % (k + 1)),
                                        quality=90)

        list(pool.map(write_jpegs, range(n_jpeg)))
    with open(os.path.join(ann, "trainlist01_nframe.txt"), "w") as f:
        for i in range(n_jpeg):
            f.write(f"v{i:04d}.avi {ds.video_meta(i)[1]} {CLI_FRAMES}\n")
    return paths["train"], jpeg_dir, ann


def _cli_run(main, argv, want_per_step=None, steps=0):
    """One CLI ``main(argv)`` with its printed lines echoed; checks the
    kernels' launches over the run against ``want_per_step`` x ``steps``.
    Returns ``(result, printed text)``."""
    import contextlib
    import io

    torch.cuda.synchronize()
    _reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    torch.cuda.synchronize()
    counts = _launch_counts()
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[cli]   {line}")
    if want_per_step is not None:
        want = {k: want_per_step.get(k, 0) * steps for k in counts}
        if counts != want:
            raise SystemExit(f"cli launches {counts}, expected {want}")
    return out, text


def _loop_times(out, batch: int):
    """The loop's own clock (StepTimer), over the steps after the first of
    each epoch: step ms, data-wait ms and pairs/s; and the epoch wall time
    (up to the epoch's metrics on the host) per step."""
    step = [s for t in out["timing"] for s in t["step_s"][1:]]
    wait = [s for t in out["timing"] for s in t["wait_s"][1:]]
    n = sum(t["steps"] for t in out["timing"])
    wall = sum(t["epoch_s"] for t in out["timing"]) / n
    step_ms = 1e3 * sum(step) / len(step)
    wait_ms = 1e3 * sum(wait) / len(wait)
    return dict(step_ms=step_ms, wait_ms=wait_ms, wall_ms=wall * 1e3,
                pairs_per_s=batch / (step_ms / 1e3), steps=n)


def _trace_busy(trace_dir: str):
    """``(wall ms, device busy ms, device events)`` of the one trace under
    ``trace_dir`` (``--profile_dir``): the span of all its events, and the
    union of its kernel and memory-copy intervals."""
    import glob
    import os

    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev_ev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not dev_ev:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in dev_ev:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    return span / 1e3, busy / 1e3, len(dev_ev)


def _loader_alone(train: str, dev):
    """The pretrain loader without a step, per-view B_VIEW and
    BENCH_STEP_BS: host ms per batch, and ms per batch landed on the card
    through ``prefetch_to_device``, over CLI_STEPS - 1 batches after the
    first."""
    from cstp_tpu_torch.data.loader import PretrainLoader, prefetch_to_device
    from cstp_tpu_torch.data.packed import PackedDataset

    ds = PackedDataset(train)
    out = {}
    for bs in (B_VIEW, BENCH_STEP_BS):
        res = []
        for land in (False, True):
            it = PretrainLoader(ds, bs, T, seed=1, num_workers=6).epoch(1)
            if land:
                it = prefetch_to_device(it, dev)
            next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CLI_STEPS - 1):
                next(it)
            torch.cuda.synchronize()
            res.append((time.perf_counter() - t0) * 1e3 / (CLI_STEPS - 1))
            it.close()
        out[bs] = tuple(res)
    ds.close()
    return out


def _check_rows(path):
    import csv

    rows = list(csv.reader(open(path), delimiter="\t"))
    bad = [r for r in rows[1:] if not all(math.isfinite(float(c))
                                          for c in r)]
    if len(rows) < 2 or bad:
        raise SystemExit(f"{path}: no rows or non-finite rows {bad}")
    return len(rows) - 1


def phase_cli(dev, card: str, slice_ms: float, bench_ms: float):
    """The recipe through the port's four CLIs (``main(argv)``, in
    process), on CSTPack files it writes: pretrain (per-view B_VIEW, 2
    epochs of CLI_STEPS), ``--task resume`` from save_1, finetune
    (``ft_all``, batch B_FT) from save_2 with validation, test on its
    ``save_1_max``, retrieval from save_2, a pretrain epoch at per-view
    BENCH_STEP_BS (bench.py's) and one from a frame directory of JPEGs.
    R(2+1)D depth 1 at full width, 16x112^2, bf16, ``--fused_conv 1``.
    Launches per loop step must be phase 3's (10/10/1) and the finetune
    step's (5/5/0); CSV rows finite, checkpoints present, an accuracy
    printed, R@k non-decreasing. Prints the loop's step and data-wait ms
    beside phase 3's step and phase 11's bench step."""
    import os
    import re
    import tempfile

    from cstp_tpu_torch.cli import main_byol, main_ft, main_retrieval
    from cstp_tpu_torch.cli import main_test

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cstp_cli_") as root:
        t0 = time.perf_counter()
        train, jpeg_dir, ann = _cli_data(root)
        log(f"[cli] data: {CLI_TRAIN} + {CLI_EVAL} + {CLI_EVAL} videos x "
            f"{CLI_FRAMES} raw {H0}x{W0} frames in CSTPack "
            f"({os.path.getsize(train) / 1e9:.2f} GB train file), "
            f"{CLI_JPEG_STEPS * B_VIEW} JPEG frame dirs, written in "
            f"{time.perf_counter() - t0:.1f} s")
        res = os.path.join(root, "results")
        common = ["--model_name", "r21d_byol", "--model_depth", "1",
                  "--sample_duration", str(T), "--sample_size", str(S),
                  "--compute_dtype", "bfloat16", "--fused_conv", "1",
                  "--log_every", "0", "--n_workers", "6",
                  "--dataset", "UCF101", "--n_classes", str(N_FT_CLASSES),
                  "--n_finetune_classes", str(N_FT_CLASSES),
                  "--result_path", res]
        packed = common + ["--data_backend", "packed", "--lmdb_path", train]
        pre = ["--task", "loss_com", "--pallas_augment", "on",
               "--learning_rate", "0.03"]
        per_pre = {"conv21d_stats": 10, "conv21d_fwd": 10, "augment": 1}
        per_ft = {"conv21d_stats": FT_LAUNCHES, "conv21d_fwd": FT_LAUNCHES}
        run_dir = os.path.join(res, "UCF101", "loss_com")
        times = {}

        out, _ = _cli_run(main_byol.main, packed + pre + [
            "--batch_size", str(B_VIEW), "--n_epochs", "2",
            "--steps_per_epoch", str(CLI_STEPS), "--ckpt_every_epochs", "1"],
            per_pre, 2 * CLI_STEPS)
        times["pretrain"] = _loop_times(out, B_VIEW)
        losses = [h["loss"] for h in out["history"]]
        del out
        torch.cuda.empty_cache()

        out, _ = _cli_run(main_byol.main, packed + pre + [
            "--batch_size", str(B_VIEW), "--n_epochs", "2",
            "--steps_per_epoch", "2", "--ckpt_every_epochs", "1",
            "--task", "resume", "--resume_md_path",
            os.path.join(run_dir, "save_1")], per_pre, 4)
        if out["state"].step != CLI_STEPS + 4:
            raise SystemExit(f"resume from save_1 ran from step "
                             f"{out['state'].step - 4}, not {CLI_STEPS}")
        del out
        torch.cuda.empty_cache()
        n_rows = _check_rows(os.path.join(
            run_dir, f"UCF101_train_clip{T}modelr21d_byol1.log"))

        save_2 = os.path.join(run_dir, "save_2")
        out, text = _cli_run(main_ft.main, packed + [
            "--task", "ft_all", "--pretrained_path", save_2,
            "--batch_size", str(B_FT), "--n_epochs", "1",
            "--steps_per_epoch", str(CLI_FT_STEPS), "--learning_rate",
            "0.02"], per_ft, CLI_FT_STEPS)
        times["finetune"] = _loop_times(out, B_FT)
        del out
        torch.cuda.empty_cache()
        ft_dir = os.path.join(res, "UCF101", "ft_all")
        for f in (f"train_UCF101_clip{T}modelr21d_byol1.log",
                  f"val_UCF101_clip{T}modelr21d_byol1.log"):
            _check_rows(os.path.join(ft_dir, f))
        if not os.path.isdir(os.path.join(ft_dir, "save_1_max")):
            raise SystemExit("the finetune run kept no save_1_max")

        t0 = time.perf_counter()
        out, text = _cli_run(main_test.main, packed + [
            "--task", "test", "--t_ft_task", "ft_all"], {}, 1)
        times["test_s"] = time.perf_counter() - t0
        acc = re.search(r"^Video accuracy =  ([\d.]+)$", text, re.M)
        if not acc or not 0.0 <= float(acc[1]) <= 1.0:
            raise SystemExit("main_test printed no video accuracy")

        t0 = time.perf_counter()
        out, text = _cli_run(main_retrieval.main, packed + [
            "--task", "retrieval", "--pretrained_path", save_2,
            "--retrieval_clips", "2"], {}, 1)
        times["retrieval_s"] = time.perf_counter() - t0
        recalls = [out[f"R@{k}"] for k in (1, 5, 10, 20, 50)]
        if recalls != sorted(recalls) or out["n_gallery"] != CLI_TRAIN:
            raise SystemExit(f"retrieval R@k {recalls} decrease, or "
                             f"gallery {out['n_gallery']} != {CLI_TRAIN}")

        out, _ = _cli_run(main_byol.main, packed + pre + [
            "--batch_size", str(BENCH_STEP_BS), "--n_epochs", "1",
            "--steps_per_epoch", str(CLI_STEPS), "--ckpt_every_epochs",
            "100", "--result_path", os.path.join(root, "results64")],
            per_pre, CLI_STEPS)
        times["pretrain64"] = _loop_times(out, BENCH_STEP_BS)
        losses64 = [h["loss"] for h in out["history"]]
        del out
        torch.cuda.empty_cache()

        # the same loop with each host batch echoed CLI_STEPS times: one
        # batch read and copied an epoch, so any difference from the run
        # above is the loader's host work
        out, _ = _cli_run(main_byol.main, packed + pre + [
            "--batch_size", str(B_VIEW), "--n_epochs", "1",
            "--steps_per_epoch", str(CLI_STEPS), "--data_echo",
            str(CLI_STEPS), "--ckpt_every_epochs", "100", "--result_path",
            os.path.join(root, "results_echo")], per_pre, CLI_STEPS)
        times["echo"] = _loop_times(out, B_VIEW)
        del out
        torch.cuda.empty_cache()
        # the loop under its own --profile_dir: the card's busy share of
        # steps 3-5, beside phase 3's profiled step
        trace_dir = os.path.join(root, "trace")
        _cli_run(main_byol.main, packed + pre + [
            "--batch_size", str(B_VIEW), "--n_epochs", "1",
            "--steps_per_epoch", str(CLI_STEPS), "--profile_dir", trace_dir,
            "--profile_steps", "3", "--ckpt_every_epochs", "100",
            "--result_path", os.path.join(root, "results_trace")],
            per_pre, CLI_STEPS)
        times["traced"] = _trace_busy(trace_dir)
        torch.cuda.empty_cache()
        # phase 3's bare step again, after the loops: the host's drift
        # between phase 3 and here, against the loops' excess
        times["bare_after"] = phase_slice(dev, card, profile=False)["step_ms"]
        torch.cuda.empty_cache()
        times["loader"] = _loader_alone(train, dev)

        jpeg = common + ["--data_backend", "framedir", "--frame_dir",
                         jpeg_dir, "--annotation_path", ann]
        out, _ = _cli_run(main_byol.main, jpeg + pre + [
            "--batch_size", str(B_VIEW), "--n_epochs", "1",
            "--steps_per_epoch", str(CLI_JPEG_STEPS), "--ckpt_every_epochs",
            "100", "--result_path", os.path.join(root, "results_jpeg")],
            per_pre, CLI_JPEG_STEPS)
        times["jpeg"] = _loop_times(out, B_VIEW)
        losses_jpeg = [h["loss"] for h in out["history"]]
        del out
        torch.cuda.empty_cache()

    if not all(math.isfinite(v) for v in losses + losses64 + losses_jpeg):
        raise SystemExit("a cli pretrain run gave a non-finite loss")
    for name, batch, ref, ref_name in (
            ("pretrain", B_VIEW, slice_ms, "phase 3's bare step"),
            ("pretrain64", BENCH_STEP_BS, bench_ms,
             "phase 11's bench_step pretrain"),
            ("jpeg", B_VIEW, slice_ms, "phase 3's bare step"),
            ("echo", B_VIEW, slice_ms, "phase 3's bare step"),
            ("finetune", B_FT, None, None)):
        t = times[name]
        beside = (f"; {ref_name} {ref:.1f} ms, loop / bare "
                  f"{t['step_ms'] / ref:.3f}" if ref else "")
        log(f"[cli] {name} (batch {batch}, {t['steps']} steps): loop step "
            f"{t['step_ms']:.1f} ms, data wait {t['wait_ms']:.2f} ms per "
            f"step (StepTimer, steps after the first), epoch wall "
            f"{t['wall_ms']:.1f} ms per step, {t['pairs_per_s']:.1f} "
            f"{'clips' if name == 'finetune' else 'pairs'}/s{beside} "
            f"({card})")
    if times["traced"] is None:
        log("[cli] the loop's trace holds no device events: not measured")
    else:
        wall, busy, n_ev = times["traced"]
        log(f"[cli] the loop under --profile_dir (per-view {B_VIEW}, packed, "
            f"steps 3-5 traced): {wall / 3:.1f} ms wall per step, device "
            f"busy {busy / 3:.1f} ms per step ({busy / wall:.1%}), {n_ev} "
            f"device events (profiling slows the host; compare with "
            f"phase 3's \"[profile] one step\" line)")
    log(f"[cli] phase 3's bare step again after the loops: "
        f"{times['bare_after']:.1f} ms (phase 3: {slice_ms:.1f} ms); echo "
        f"loop / this bare step {times['echo']['step_ms'] / times['bare_after']:.3f}")
    for bs, (host_ms, landed_ms) in times["loader"].items():
        log(f"[cli] loader alone, per-view {bs}: {host_ms:.1f} ms per host "
            f"batch ({2 * bs * T} frames of {H0}x{W0}, 6 threads), "
            f"{landed_ms:.1f} ms per batch landed on the card through "
            f"prefetch_to_device ({card})")
    log(f"[cli] pretrain CSV {n_rows} finite rows (2 epochs + 2 resumed); "
        f"test {times['test_s']:.1f} s for {CLI_EVAL} videos, accuracy "
        f"{float(acc[1]):.4f}; retrieval {times['retrieval_s']:.1f} s, R@k "
        f"{recalls}; phase {time.perf_counter() - t_phase:.1f} s")
    return times


# ------------------------------------------------------------ step flags

def _per_step(c2, c3, c5):
    return {"conv21d_stats": c2, "conv21d_fwd": c3, "conv21d_taps9_stats": 0,
            "conv21d_taps9_fwd": 0, "augment": c5}


# phase 13's runs at per-view B_VIEW: name -> (config flags over the kernel
# slice's, K2/K3/K5 launches per step). A fused site recomputes under
# remat (also under "bnrelu": its output is not an op the policy can name),
# in the online tower only, which runs with autograd: 5 sites per tower
# call.
FLAG_RUNS = {
    "per-view calls (concat_views 0)": (dict(concat_views=0),
                                        _per_step(20, 20, 1)),
    "remat": (dict(remat=True), _per_step(15, 15, 1)),
    "remat_policy bnrelu": (dict(remat_policy="bnrelu"),
                            _per_step(15, 15, 1)),
    "remat, concat_views 0": (dict(remat=True, concat_views=0),
                              _per_step(30, 30, 1)),
    "fused_conv 2 (target tower only)": (dict(fused_conv=2),
                                         _per_step(5, 5, 1)),
}
# bench_step at bench.py's per-view 64: (flags, launches per step, whether
# it must fit the card); a run that need not fit may run out of memory
FLAG_BENCH_RUNS = [
    (["--fused-conv", "0", "--remat"], {}, True),
    (["--fused-conv", "0", "--remat-policy", "bnrelu"], {}, False),
    (["--fused-conv", "1", "--pallas-augment", "on", "--remat"],
     {"conv21d_stats": 15, "conv21d_fwd": 15, "augment": 1}, False),
    (["--fused-conv", "2", "--pallas-augment", "on"],
     {"conv21d_stats": 5, "conv21d_fwd": 5, "augment": 1}, False),
]


def phase_flags(dev, card: str, slice_ms: float):
    """The step flags at R(2+1)D depth 1, 16 x 112^2, bf16. At per-view
    B_VIEW, kernels on: K2/K3 against the plain chain at the per-view
    calls' shape (N = B_VIEW, one BN group); one step of each FLAG_RUNS
    configuration from the same weights, generator and batch, its launches
    checked, then 2 timed steps; the remat steps held against the step
    without remat by phase 4's rule (a float32 plain step arbitrates) with
    bitwise the same BN running statistics; the per-view calls, AdamW with
    --double_bias_lr, and SGD with dampening 0.1 and nesterov each held
    against their plain bf16 step by phase 4's rule. Then bench_step
    --mode pretrain at per-view 64 (1 warm-up, 2 timed steps) under
    FLAG_BENCH_RUNS: step ms, pairs/s, peak GiB and launches per step."""
    from cstp_tpu_torch.perf import bench_step

    t_phase = time.perf_counter()
    phase_conv21d_paths(dev, [("concat_views=0 tower call", B_VIEW, 1)])
    batch = _slice_batch(dev, seed=4)
    base = _one_step_run(dev, _slice_config(True), batch)
    f32 = _one_step_run(dev, _slice_config_plain_f32(), batch)
    if base["counts"] != _per_step(10, 10, 1):
        raise SystemExit(f"[flags] base step launched {base['counts']}")
    runs = {}
    for name, (over, want) in FLAG_RUNS.items():
        r = runs[name] = _one_step_run(dev, _slice_config(True, **over),
                                       batch)
        loss, loss0 = r["metrics"]["loss"], base["metrics"]["loss"]
        log(f"[flags] {name}, per-view {B_VIEW}, kernels on: loss "
            f"{loss:.5f} (no flag {loss0:.5f}); {r['ms']:.1f} ms/step, "
            f"{B_VIEW / r['ms'] * 1e3:.1f} pairs/s, peak "
            f"{r['peak_gib']:.2f} GiB (no flag {base['peak_gib']:.2f}) "
            f"(2 steps; phase 3's concat_views 1 step {slice_ms:.1f},"
            f" this phase's {base['ms']:.1f}; {card}); launches "
            f"{r['counts']}")
        if r["counts"] != want or not math.isfinite(r["metrics"]["loss"]):
            raise SystemExit(f"[flags] {name}: launches {r['counts']} "
                             f"(expected {want}) or a non-finite loss")
    for name in ("remat", "remat_policy bnrelu"):
        r = runs[name]
        loss_err, acc_err, cos_r, cos_b, ok = _agree(r, base, f32)
        same = all(torch.equal(r["stats"][n], v)
                   for n, v in base["stats"].items())
        log(f"[flags] {name} vs the step without it: max rel loss-term err "
            f"{loss_err:.3e} (tol 2e-2), max accuracy diff {acc_err:.4f} "
            f"(tol 0.125), update cosine to float32 {cos_r:.5f} vs "
            f"{cos_b:.5f} (tol >= - 0.05), to the no-remat update "
            f"{_cos(r, base):.5f}; BN running statistics bitwise equal: "
            f"{same}")
        if not (ok and same):
            raise SystemExit(f"[flags] the {name} step disagrees with the "
                             "step without it")
    del runs, base, f32, batch
    torch.cuda.empty_cache()
    for over, tag in ((dict(concat_views=0), "flags per-view parity"),
                      (dict(optimizer="adamw", double_bias_lr=True),
                       "flags adamw double_bias_lr parity"),
                      (dict(dampening=0.1, nesterov=True),
                       "flags sgd dampening nesterov parity")):
        phase_parity(dev, over=over, tag=tag)
    for flags, want, must_fit in FLAG_BENCH_RUNS:
        try:
            r = bench_step.main(["--mode", "pretrain", "--steps", "2",
                                 "--warmup", "1", *flags])
        except torch.cuda.OutOfMemoryError as e:
            if must_fit:
                raise
            log(f"[flags] bench_step pretrain {' '.join(flags)}: out of "
                f"memory at per-view {BENCH_STEP_BS}: "
                f"{str(e).splitlines()[0]}")
            r = None
        gc.collect()
        torch.cuda.empty_cache()
        if r is None:
            continue
        got = {k: v for k, v in r["launches_per_step"].items() if v}
        log(f"[flags] bench_step pretrain {' '.join(flags)}, per-view "
            f"{BENCH_STEP_BS}: {r['step_ms']:.1f} ms/step, "
            f"{r['pairs_per_s']:.1f} pairs/s, peak {r['peak_mem_gib']:.2f} "
            f"GiB, launches per step {got}")
        if got != want or not math.isfinite(r["loss"]):
            raise SystemExit(f"bench_step {flags} launched {got} per step "
                             f"(expected {want}) or lost its loss")
    log(f"[flags] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ families

# phase 14's pretrain runs: tag -> config flags
FAMILY_RUNS = {
    "c3d": dict(model_name="c3d_byol"),
    "r3d-18 B": dict(model_name="r3d_byol", model_depth=18,
                     resnet_shortcut="B"),
    "r3d-18 A": dict(model_name="r3d_byol", model_depth=18,
                     resnet_shortcut="A"),
}
FAMILY_FT = ("c3d", "r3d-18 B")     # the finetune, eval and importer runs
FAMILY_BATCH = 16                   # the finetune and eval batch
# bench_step at bench.py's per-view 64: (mode, --model, --depth, flags,
# launches per step); C3D's pretrain step needs --grad-accum 2 to fit
FAMILY_BENCH_RUNS = [
    ("pretrain", "c3d", "1", ["--pallas-augment", "on"], {"augment": 1}),
    ("pretrain", "c3d", "1", ["--pallas-augment", "on", "--grad-accum", "2"],
     {"augment": 1}),
    ("pretrain", "r3d", "18", ["--pallas-augment", "on"], {"augment": 1}),
    ("ft", "c3d", "1", [], {}),
    ("ft", "r3d", "18", [], {}),
]


def _family_pretrain(dev, card: str, phase: str, tag: str, kw, batch,
                     slice_ms: float):
    """One pretrain step (config flags ``kw`` over the slice's) from the
    same weights, generator and ``batch`` with K5 (``pallas_augment`` on,
    and ``fused_conv`` 1, which only R(2+1)D reads; launches 0/0/1), the
    plain bf16 step (K5's plain version; 0/0/0) and the plain float32 step,
    held by phase 4's rule, each then timed over 2 steps with its peak
    memory. Returns the K5 run's launches in its first step."""
    runs = {k: _one_step_run(dev, cfg, batch) for k, cfg in (
        ("kernel", _slice_config(True, **kw)),
        ("plain", _slice_config(False, **kw)),
        ("f32", _slice_config_plain_f32(**kw)))}
    k, p, f = (runs[n] for n in ("kernel", "plain", "f32"))
    loss_err, acc_err, cos_k, cos_p, ok = _agree(k, p, f)
    log(f"[{phase}] {tag} pretrain, per-view {B_VIEW}, {T}x{S}^2: "
        f"K5 step {k['ms']:.1f} ms ({B_VIEW / k['ms'] * 1e3:.1f} pairs/s,"
        f" peak {k['peak_gib']:.2f} GiB), plain bf16 {p['ms']:.1f} ms, "
        f"plain float32 {f['ms']:.1f} ms (2 steps after one; phase 3's "
        f"r21d step {slice_ms:.1f} ms; {card}); loss "
        f"{k['metrics']['loss']:.5f} vs plain {p['metrics']['loss']:.5f}, "
        f"max rel loss-term err {loss_err:.3e} (tol 2e-2), max accuracy diff "
        f"{acc_err:.4f} (tol 0.125), update cosine to float32: K5 "
        f"{cos_k:.5f}, plain {cos_p:.5f} (tol K5 >= plain - 0.05); launches "
        f"{k['counts']}, plain {p['counts']}")
    if k["counts"] != _per_step(0, 0, 1) or any(p["counts"].values()):
        raise SystemExit(f"[{phase}] {tag}: launches {k['counts']} "
                         f"(expected 0/0/1), plain {p['counts']}")
    if not ok:
        raise SystemExit(f"[{phase}] {tag}: the K5 step and the plain "
                         "step disagree")
    counts = k["counts"]
    del runs, k, p, f
    torch.cuda.empty_cache()
    return counts


def _family_finetune(dev, card: str, tag: str, kw, steps: int = 2,
                     hw=(H0, W0)):
    """One warm-up and ``steps`` timed ft_all steps, then one warm-up and
    ``steps`` timed eval steps, at batch FAMILY_BATCH (config flags ``kw``,
    frames of ``hw``): no kernel launched (K2/K3 are R(2+1)D's, K5 the
    pretrain augment), finite losses, the parameters moved."""
    from cstp_tpu_torch.train import finetune as ft

    cfg = _ft_config(fused=1, batch_size=FAMILY_BATCH, **kw)
    model, state, tx = ft.create_finetune_state(cfg, N_FT_CLASSES, seed=0,
                                                device=dev)
    step = ft.make_finetune_step(model, tx, cfg)
    eval_step = ft.make_eval_step(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(12)
    batch = {k: v[:FAMILY_BATCH] for k, v in _ft_batch(dev, 13, hw).items()}
    before = _snapshot(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    state, m = step(state, gen, batch, cfg.learning_rate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [m["loss"]]
    for _ in range(steps):
        state, m = step(state, gen, batch, cfg.learning_rate)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ft_ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    e = eval_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        e = eval_step(state, batch)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) / steps * 1e3
    counts = _launch_counts()
    losses = torch.stack(losses + [e["loss"]]).float().cpu()
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in model.named_parameters())
    log(f"[{tag}] finetune ({cfg.model_name}"
        f"{', i3d_conv_head' if cfg.i3d_conv_head else ''}), batch "
        f"{FAMILY_BATCH}, {T}x{cfg.sample_size}^2 bf16, "
        f"ft_all: {ft_ms:.1f} ms/step, {FAMILY_BATCH / ft_ms * 1e3:.1f} "
        f"clips/s, peak {peak:.2f} GiB; eval step {eval_ms:.1f} ms "
        f"({steps} steps each after one; {card}); losses (train, eval) "
        f"{[round(v, 4) for v in losses.tolist()]}; max |param change| "
        f"{moved:.3e}; launches {counts}")
    if any(counts.values()) or not bool(torch.isfinite(losses).all()) \
            or moved <= 0.0:
        raise SystemExit(f"[{tag}] finetune/eval launched "
                         f"{counts}, gave non-finite losses or left the "
                         "parameters unchanged")
    del model, state, tx
    torch.cuda.empty_cache()


def _family_importer(dev, root: str, tag: str, kw):
    """A pretrain state (config flags ``kw``) (one kernel step from seed 0) saved as a port
    checkpoint and exported with ``python -m
    cstp_tpu_torch.models.torch_import --export``; then ``main_ft
    --pretrained_path <file>.pth`` for 2 steps on synthetic videos, whose
    model right after the load must hold the state's ``online_net.*``
    tensors bitwise, and ``main_retrieval`` from the same file."""
    import os

    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.cli import main_ft, main_retrieval
    from cstp_tpu_torch.models import torch_import
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    name = kw["model_name"]
    cfg = _slice_config(True, **kw)
    model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    state, _ = make_pretrain_step(model, tx, cfg)(
        state, gen, _slice_batch(dev, seed=15, n_pb=4), cfg.learning_rate)
    # the backbone's tensors; the projector (S3D's) is pretrain-only
    online = {n: t.detach().cpu().clone()
              for n, t in model.state_dict().items()
              if n.startswith("online_net.")
              and not n.startswith("online_net.project.")}
    ckpt = os.path.join(root, f"{name}_save_1")
    pth = ckpt + ".pth"
    ckpt_lib.save_checkpoint(ckpt, ckpt_lib.state_tree(state),
                             meta={"arch": cfg.arch, "epoch": 1})
    del model, state, tx
    torch.cuda.empty_cache()
    subprocess.run([sys.executable, "-m", "cstp_tpu_torch.models.torch_import",
                    "--export", ckpt, pth, "--arch", name], check=True)
    loaded, load_into = [], torch_import.load_into

    def recording_load_into(m, tree):
        load_into(m, tree)
        loaded.append({n: t.detach().cpu().clone()
                       for n, t in m.state_dict().items()})

    common = [a for k, v in kw.items() for a in (f"--{k}", str(v))] + [
              "--pretrained_path", pth,
              "--sample_duration", str(T), "--sample_size", str(S),
              "--compute_dtype", "bfloat16", "--data_backend", "synthetic",
              "--synthetic_len", str(2 * FAMILY_BATCH),
              "--batch_size", str(FAMILY_BATCH), "--n_classes",
              str(N_FT_CLASSES), "--n_finetune_classes", str(N_FT_CLASSES),
              "--log_every", "0", "--n_workers", "4",
              "--result_path", os.path.join(root, "results")]
    torch_import.load_into = recording_load_into
    try:
        out, _ = _cli_run(main_ft.main, common + [
            "--task", "ft_all", "--n_epochs", "1", "--steps_per_epoch", "2"],
            {}, 1)
        ret, _ = _cli_run(main_retrieval.main, common + [
            "--task", "retrieval", "--retrieval_clips", "2"], {}, 1)
    finally:
        torch_import.load_into = load_into
    same = len(loaded) == 2 and all(
        all(torch.equal(sd[n], v) for n, v in online.items()) for sd in loaded)
    losses = [h["train_loss"] for h in out["history"]]
    recalls = [ret[k] for k in ("R@1", "R@5", "R@10", "R@20", "R@50")]
    log(f"[{tag}] importer: exported {len(online)} online_net "
        f"tensors to {os.path.basename(pth)} "
        f"({os.path.getsize(pth) / 2**20:.1f} MiB); main_ft and main_retrieval loaded them bitwise: {same}; "
        f"finetune losses {losses}; R@k {recalls}")
    if not same or not all(math.isfinite(v) for v in losses) \
            or recalls != sorted(recalls):
        raise SystemExit(f"[{tag}] the .pth did not load bitwise, "
                         "or the finetune or retrieval run failed its checks")


def phase_families(dev, card: str, slice_ms: float):
    """The C3D and 3D-ResNet families at full width, 16 x 112^2, bf16. At
    per-view B_VIEW, for each FAMILY_RUNS entry: one pretrain step from the
    same weights, generator and batch with K5 (``pallas_augment`` on, and
    ``fused_conv`` 1, which these families ignore; launches 0/0/1), the
    plain bf16 step (K5's plain version; 0/0/0) and the plain float32 step,
    held by phase 4's rule, each then timed over 2 steps with its peak
    memory. For c3d and r3d-18: a finetune and an eval step at batch
    FAMILY_BATCH (no launch), and the reference-.pth round trip through
    ``torch_import --export``, ``main_ft`` and ``main_retrieval``. Then
    bench_step at per-view 64 (FAMILY_BENCH_RUNS): step ms, throughput and
    peak GiB; an out-of-memory is reported with the size asked."""
    import tempfile

    from cstp_tpu_torch.perf import bench_step

    t_phase = time.perf_counter()
    batch = _slice_batch(dev, seed=4, n_pb=4)
    for tag, kw in FAMILY_RUNS.items():
        _family_pretrain(dev, card, "families", tag, kw, batch, slice_ms)
    for tag in FAMILY_FT:
        _family_finetune(dev, card, tag, FAMILY_RUNS[tag])
    with tempfile.TemporaryDirectory(prefix="cstp_families_") as root:
        for tag in FAMILY_FT:
            _family_importer(dev, root, tag, FAMILY_RUNS[tag])
    _family_bench(FAMILY_BENCH_RUNS)
    log(f"[families] phase {time.perf_counter() - t_phase:.1f} s")


def _family_bench(runs):
    """bench_step at per-view BENCH_STEP_BS, 2 steps after 1, for each
    ``(mode, --model, --depth, flags, launches per step)`` of ``runs``:
    step ms, throughput, peak GiB and launches per step, checked; an
    out-of-memory is reported with the size asked."""
    from cstp_tpu_torch.perf import bench_step

    for mode, model, depth, flags, want in runs:
        args = ["--mode", mode, "--model", model, "--depth", depth,
                "--steps", "2", "--warmup", "1", *flags]
        try:
            r = bench_step.main(args)
        except torch.cuda.OutOfMemoryError as e:
            log(f"[bench_step] {' '.join(args)}: out of memory at "
                f"per-view {BENCH_STEP_BS}: {str(e).splitlines()[0]}")
            r = None
        gc.collect()
        torch.cuda.empty_cache()
        if r is None:
            continue
        got = {k: v for k, v in r["launches_per_step"].items() if v}
        rate = "pairs_per_s" if mode == "pretrain" else "clips_per_s"
        log(f"[bench_step] {' '.join(args)}, per-chip "
            f"{BENCH_STEP_BS}: {r['step_ms']:.1f} ms/step, {r[rate]:.1f} "
            f"{rate.replace('_per_s', '')}/s, peak "
            f"{r['peak_mem_gib']:.2f} GiB, launches per step {got}")
        if got != want or not math.isfinite(r["loss"]):
            raise SystemExit(f"bench_step {args} launched {got} per step "
                             f"(expected {want}) or lost its loss")


# ------------------------------------------------------------ inception

# phase 15's families: tag -> config flags
INCEPTION_RUNS = {"s3d": dict(model_name="s3d_byol"),
                  "i3d": dict(model_name="i3d_byol")}
# the pretrain runs at per-view B_VIEW: tag -> (sample size, source frames)
INCEPTION_PRETRAIN = {"s3d": (S, (H0, W0)), "i3d": (S_LARGE, NATIVE_HW)}
# the finetune and eval runs at batch FAMILY_BATCH: (tag, config flags,
# source frames); the conv head takes 224^2 only
INCEPTION_FT = [("s3d", dict(model_name="s3d_classify"), (H0, W0)),
                ("s3d", INCEPTION_RUNS["s3d"], (H0, W0)),
                ("i3d", INCEPTION_RUNS["i3d"], (H0, W0)),
                ("i3d", dict(model_name="i3d_byol", i3d_conv_head=1,
                             sample_size=S_LARGE), NATIVE_HW)]
INCEPTION_BENCH_RUNS = [
    ("pretrain", "s3d", "1", ["--pallas-augment", "on"], {"augment": 1}),
    ("pretrain", "i3d", "1", ["--pallas-augment", "on"], {"augment": 1}),
    ("ft", "s3d", "1", [], {}),
    ("ft", "i3d", "1", [], {}),
]


def conv_gflop_per_clip(model, t: int, s: int, dev) -> float:
    """Forward GFLOP of one t x s^2 clip in ``model``'s convolutions (2 x
    multiply-adds, from each ``Conv3d``'s output and weight shapes; the
    dense heads are left out), by one eval-mode forward of a zero clip."""
    from cstp_tpu_torch.models.layers import Conv3d

    macs = []

    def hook(m, _, out):
        macs.append(out[0].numel() * m.weight[0].numel())

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, Conv3d)]
    try:
        with torch.no_grad():
            model(torch.zeros(1, t, s, s, 3, device=dev), False)
    finally:
        for h in hooks:
            h.remove()
    return 2 * sum(macs) / 1e9


def _inception_config(tag: str, kernel: bool, dtype: str = "bfloat16"):
    from cstp_tpu_torch.config import Config

    s, _ = INCEPTION_PRETRAIN[tag]
    return Config(sample_duration=T, sample_size=s, batch_size=B_VIEW,
                  compute_dtype=dtype, task="loss_com",
                  fused_conv=int(kernel),
                  pallas_augment="on" if kernel else "off",
                  **INCEPTION_RUNS[tag]).finalize()


def _inception_profile(dev, tag: str, batch):
    """One warm-up and one profiled K5 step of ``tag``: its device busy
    share and K5's device time inside the step."""
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    cfg = _inception_config(tag, True)
    model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
    step = make_pretrain_step(model, tx, cfg)
    gen = torch.Generator(device=dev).manual_seed(6)
    step(state, gen, batch, cfg.learning_rate)
    prof = profile_step(lambda: step(state, gen, batch, cfg.learning_rate),
                        top=8)
    if prof is not None:
        k5 = {k: v for k, v in prof["ms_by_kernel"].items()
              if "augment" in k}
        log(f"[inception] {tag} profiled step: K5 device time "
            f"{sum(k5.values()):.3f} ms in {len(k5)} kernel name(s) "
            f"{sorted(k5)}")
    del model, state, tx, step
    torch.cuda.empty_cache()


def _holds_sonnet(backbone, tensors) -> bool:
    """Whether every unit of ``backbone`` holds its kinetics-i3d checkpoint
    tensors bitwise (DHWIO kernels as OIDHW, Sonnet's BN without gamma)."""
    from cstp_tpu_torch.models.i3d_tf_import import sonnet_name_map

    for scope, path in sonnet_name_map("rgb").items():
        unit = backbone.get_submodule(".".join(path))
        w = torch.from_numpy(tensors[f"{scope}/conv_3d/w"]).permute(
            4, 3, 0, 1, 2)
        pairs = [(unit.conv.weight, w),
                 (unit.bn.scale, torch.ones(unit.bn.scale.shape))]
        pairs += [(t, torch.from_numpy(tensors[f"{scope}/batch_norm/{leaf}"]
                                       ).reshape(-1))
                  for t, leaf in ((unit.bn.bias, "beta"),
                                  (unit.bn.mean, "moving_mean"),
                                  (unit.bn.var, "moving_variance"))]
        if not all(torch.equal(a.detach().cpu(), b) for a, b in pairs):
            return False
    return True


def _inception_tf_ckpt(dev, root: str):
    """A kinetics-i3d V2 checkpoint under the Sonnet names, of seeded
    tensors at I3D's full widths, written by ``write_tf_checkpoint``; then
    ``main_ft --tf_i3d_ckpt`` (2 steps) and ``main_byol --tf_i3d_ckpt``
    (1 epoch of 2 steps, K5 on), whose towers right after the load must
    hold the checkpoint bitwise: the finetune model's backbone, then both
    pretrain towers."""
    import os

    import numpy as np

    from cstp_tpu_torch.cli import main_byol, main_ft
    from cstp_tpu_torch.models import make_backbone
    from cstp_tpu_torch.models.i3d_tf_import import sonnet_name_map
    from cstp_tpu_torch.train import loops

    shapes = make_backbone("i3d_byol", dtype=torch.float32)
    rng = np.random.default_rng(16)
    tensors = {}
    for scope, path in sonnet_name_map("rgb").items():
        w = shapes.get_submodule(".".join(path)).conv.weight
        k = tuple(w.permute(2, 3, 4, 1, 0).shape)
        c = k[-1]
        tensors[f"{scope}/conv_3d/w"] = (rng.normal(size=k)
                                         / math.sqrt(math.prod(k[:4]))
                                         ).astype(np.float32)
        tensors[f"{scope}/batch_norm/beta"] = (
            0.1 * rng.normal(size=c)).astype(np.float32)
        tensors[f"{scope}/batch_norm/moving_mean"] = (
            0.1 * rng.normal(size=(1, 1, 1, 1, c))).astype(np.float32)
        tensors[f"{scope}/batch_norm/moving_variance"] = rng.uniform(
            0.5, 1.5, (1, 1, 1, 1, c)).astype(np.float32)
    prefix = os.path.join(root, "rgb_imagenet", "model.ckpt")
    os.makedirs(os.path.dirname(prefix))
    t0 = time.perf_counter()
    write_tf_checkpoint(prefix, tensors)
    write_s = time.perf_counter() - t0
    held, load = [], loops.load_tf_i3d

    def recording_load(backbone, path, *a, **k):
        n = load(backbone, path, *a, **k)
        held.append(_holds_sonnet(backbone, tensors))
        return n

    common = ["--model_name", "i3d_byol", "--tf_i3d_ckpt", prefix,
              "--sample_duration", str(T), "--sample_size", str(S),
              "--compute_dtype", "bfloat16", "--data_backend", "synthetic",
              "--synthetic_len", str(2 * FAMILY_BATCH),
              "--batch_size", str(FAMILY_BATCH), "--n_classes",
              str(N_FT_CLASSES), "--n_finetune_classes", str(N_FT_CLASSES),
              "--log_every", "0", "--n_workers", "4", "--n_epochs", "1",
              "--steps_per_epoch", "2",
              "--result_path", os.path.join(root, "tf_results")]
    loops.load_tf_i3d = recording_load
    try:
        ft, _ = _cli_run(main_ft.main, common + ["--task", "ft_all"], {}, 2)
        pre, _ = _cli_run(main_byol.main, common + [
            "--task", "loss_com", "--pallas_augment", "on"],
            {"augment": 1}, 2)
    finally:
        loops.load_tf_i3d = load
    losses = [h["train_loss"] for h in ft["history"]] + [
        h["loss"] for h in pre["history"]]
    size = sum(os.path.getsize(os.path.join(os.path.dirname(prefix), f))
               for f in os.listdir(os.path.dirname(prefix)))
    log(f"[inception] --tf_i3d_ckpt: {len(tensors)} tensors, "
        f"{size / 2**20:.1f} MiB written in {write_s:.2f} s; loads holding "
        f"the checkpoint bitwise (main_ft's online_net, main_byol's online "
        f"and target towers): {held}; losses {losses}")
    if held != [True] * 3 or not all(math.isfinite(v) for v in losses):
        raise SystemExit("[inception] the --tf_i3d_ckpt loads did not hold "
                         "the checkpoint bitwise, or a loss is not finite")


def phase_inception(dev, card: str, slice_ms: float):
    """The S3D-G and I3D families at full width, bf16. At per-view B_VIEW:
    one pretrain step of s3d_byol (16 x 112^2 from 128x171 frames) and of
    i3d_byol (16 x 224^2 from 256x340: K5's frame in device memory, two
    device launches in its one call) from the same weights, generator
    and batch with K5 (``pallas_augment`` on, ``fused_conv`` 1, which these
    families ignore: 0/0/1), the plain bf16 step (0/0/0) and the plain
    float32 step, held by phase 4's rule, each timed over 2 steps with its
    peak memory, and one profiled K5 step each. Then finetune and eval at
    batch FAMILY_BATCH (INCEPTION_FT; no launch); the reference-.pth round
    trip for s3d_byol and i3d_byol; the ``--tf_i3d_ckpt`` loads; and
    bench_step at per-view 64 (INCEPTION_BENCH_RUNS)."""
    import tempfile

    from cstp_tpu_torch.models import make_backbone

    t_phase = time.perf_counter()
    for tag, (s, hw) in INCEPTION_PRETRAIN.items():
        gflop = conv_gflop_per_clip(
            make_backbone(INCEPTION_RUNS[tag]["model_name"],
                          dtype=torch.bfloat16
                          ).to(dev), T, s, dev)
        batch = _slice_batch(dev, seed=4, n_pb=4, hw=hw)
        runs = {k: _one_step_run(dev, cfg, batch) for k, cfg in (
            ("kernel", _inception_config(tag, True)),
            ("plain", _inception_config(tag, False)),
            ("f32", _inception_config(tag, False, "float32")))}
        k, p, f = (runs[n] for n in ("kernel", "plain", "f32"))
        loss_err, acc_err, cos_k, cos_p, ok = _agree(k, p, f)
        log(f"[inception] {tag} pretrain, per-view {B_VIEW}, {T}x{s}^2 from "
            f"{hw[0]}x{hw[1]} ({gflop:.2f} forward GFLOP per clip in its "
            f"convolutions): K5 step {k['ms']:.1f} ms "
            f"({B_VIEW / k['ms'] * 1e3:.1f} pairs/s, peak "
            f"{k['peak_gib']:.2f} GiB), plain bf16 {p['ms']:.1f} ms "
            f"(peak {p['peak_gib']:.2f} GiB), plain float32 {f['ms']:.1f} ms "
            f"(2 steps after one; phase 3's r21d step {slice_ms:.1f} ms; "
            f"{card}); loss {k['metrics']['loss']:.5f} vs plain "
            f"{p['metrics']['loss']:.5f}, max rel loss-term err "
            f"{loss_err:.3e} (tol 2e-2), max accuracy diff {acc_err:.4f} "
            f"(tol 0.125), update cosine to float32: K5 {cos_k:.5f}, plain "
            f"{cos_p:.5f} (tol K5 >= plain - 0.05); launches {k['counts']}, "
            f"plain {p['counts']}, float32 {f['counts']}")
        if k["counts"] != _per_step(0, 0, 1) or any(p["counts"].values()) \
                or any(f["counts"].values()):
            raise SystemExit(f"[inception] {tag}: launches {k['counts']} "
                             f"(expected 0/0/1), plain {p['counts']}")
        if not ok:
            raise SystemExit(f"[inception] {tag}: the K5 step and the plain "
                             "step disagree")
        del runs, k, p, f
        torch.cuda.empty_cache()
        _inception_profile(dev, tag, batch)
    for tag, kw, hw in INCEPTION_FT:
        _family_finetune(dev, card, tag, kw, hw=hw)
    with tempfile.TemporaryDirectory(prefix="cstp_inception_") as root:
        for tag, kw in INCEPTION_RUNS.items():
            _family_importer(dev, root, tag, kw)
        _inception_tf_ckpt(dev, root)
    _family_bench(INCEPTION_BENCH_RUNS)
    log(f"[inception] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ slowfast, legacy

# phase 16's SlowFast pretrain runs at per-view B_VIEW: tag -> config flags
# (--tau 8 --alpha 4: the slow pathway takes every 4th of the 16 frames)
SLOWFAST_RUNS = {
    "slowfast-18": dict(model_name="slowfast", model_depth=18, tau=8,
                        alpha=4),
    "slowfast-50": dict(model_name="slowfast", model_depth=50, tau=8,
                        alpha=4),
}
SLOWFAST_FT = dict(model_name="slowfast_fb", model_depth=50, tau=8, alpha=4)
SLOWFAST_BENCH_RUNS = [
    ("pretrain", "slowfast", "50", ["--pallas-augment", "on"], {"augment": 1}),
    ("ft", "slowfast", "50", [], {}),
]
# --legacy_pace: bare r21d's 'pace_project' finetune head; its online
# tower's 5 fused sites launch K2 and K3 once each per step
LEGACY_PACE = dict(model_name="r21d", legacy_pace=1)
# the legacy models: (reference file name, kwargs); one train-mode forward
# each of LEGACY_BATCH clips of T x S^2, bf16 against float32. In train
# mode at random weights these deep networks amplify rounding: rounding
# only the input to bf16 moves the float32 outputs by 0.08% (r3d) to 13%
# (s3d_g) of their norm, and bf16 compute moves them 2.5-3.9 times as far
# (on a CPU at this size). So each output's |bf16 - f32| / |f32| must stay
# within LEGACY_SPREAD times that input spread, at most LEGACY_CAP, plus
# LEGACY_TOL: for s3d_g (about 0.34 on the CPU) only a gross fault fails
LEGACY_MODELS = [("r21d", {}), ("r21d_byol", {}), ("c3d", {}), ("r3d", {}),
                 ("s3d_g", {}), ("s3d_g", dict(space_to_depth=False))]
LEGACY_BATCH = 8
LEGACY_SPREAD, LEGACY_CAP, LEGACY_TOL = 10.0, 0.75, 1e-2


def _legacy_forward(dev, name: str, kw, dtype, x):
    """One train-mode forward of the legacy model ``name`` (seed-0
    weights, compute ``dtype``) on ``x``: its float32 outputs, its ms, and
    for ``r21d_byol`` one backward of the loss, checked: finite gradients
    on the online tower and the ``prodictor``, none on the target tower."""
    from cstp_tpu_torch.models import make_legacy_model

    model = make_legacy_model(name, dtype=dtype,
                              gen=torch.Generator().manual_seed(0),
                              **kw).to(dev)
    args = (x, x.flip(0)) if name in ("r21d_byol", "c3d") else (x,)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(*args, True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    grads = None
    if name == "r21d_byol":
        out.backward()
        g = {n: p.grad for n, p in model.named_parameters()}
        grads = dict(
            online=sum(1 for n, v in g.items() if v is not None
                       and n.startswith(("online_net.", "prodictor."))),
            finite=all(bool(torch.isfinite(v).all()) for v in g.values()
                       if v is not None),
            target=sum(1 for n, v in g.items()
                       if v is not None and n.startswith("target_net.")))
    outs = [o.detach().float() for o in (out if isinstance(out, tuple)
                                         else (out,))]
    del model
    torch.cuda.empty_cache()
    return outs, ms, grads


def phase_slowfast_legacy(dev, card: str, slice_ms: float):
    """The SlowFast family and the legacy pace-era models at full width,
    16 x 112^2 from 128x171 frames, bf16. SlowFast (``--tau 8 --alpha
    4``): at per-view B_VIEW, one pretrain step each of depth 18 and 50
    with K5 (0/0/1) against the plain bf16 step (0/0/0) and the plain
    float32 step by phase 4's rule, timed over 2 steps with peak memory;
    finetune and eval of slowfast_fb-50 at batch FAMILY_BATCH (no
    launch). ``--legacy_pace 1`` (bare r21d): the finetune step at B_FT
    with fused_conv 1 against the plain steps by phase 9's rule, 5/5/0
    launches in its first step. The legacy models (LEGACY_MODELS): one
    train-mode forward each in bf16 held against float32 within
    LEGACY_TOL, no launch; ``r21d_byol`` also one backward. Then
    bench_step --model slowfast --depth 50 (SLOWFAST_BENCH_RUNS). Returns
    the launches of the runs on the main path (the K5 steps and the
    legacy_pace kernel step), for the kernels line."""
    t_phase = time.perf_counter()
    counts = {k: 0 for k in _per_step(0, 0, 0)}
    batch = _slice_batch(dev, seed=4, n_pb=4)
    for tag, kw in SLOWFAST_RUNS.items():
        for k, v in _family_pretrain(dev, card, "slowfast", tag, kw, batch,
                                     slice_ms).items():
            counts[k] += v
    del batch
    _family_finetune(dev, card, "slowfast-50", SLOWFAST_FT)
    pace = phase_finetune_parity(dev, over=LEGACY_PACE, tag="legacy-pace")
    want = _per_step(FT_LAUNCHES, FT_LAUNCHES, 0)
    if pace["counts"]["kernel"] != want or any(
            v for n in ("plain", "f32") for v in pace["counts"][n].values()):
        raise SystemExit(f"[legacy-pace] launches {pace['counts']}, "
                         f"expected {want} on the kernel step, none else")
    for k, v in pace["counts"]["kernel"].items():
        counts[k] += v

    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.rand((LEGACY_BATCH, T, S, S, 3), generator=gen,
                   device=dev) * 2 - 1
    for name, kw in LEGACY_MODELS:
        tag = name + "".join(f" {k}={v}" for k, v in kw.items())
        _reset_launch_counts()
        lo, lo_ms, lo_g = _legacy_forward(dev, name, kw, torch.bfloat16, x)
        hi, hi_ms, _ = _legacy_forward(dev, name, kw, torch.float32, x)
        rd, _, _ = _legacy_forward(dev, name, kw, torch.float32,
                                   x.bfloat16().float())
        launched = _launch_counts()

        def rel(a, b):
            return float((a - b).norm() / b.norm().clamp_min(1e-30))

        errs = [rel(a, b) for a, b in zip(lo, hi)]
        spreads = [rel(c, b) for c, b in zip(rd, hi)]
        tols = [min(LEGACY_SPREAD * sp, LEGACY_CAP) + LEGACY_TOL
                for sp in spreads]
        finite = all(bool(torch.isfinite(a).all()) for a in lo)
        log(f"[legacy] {tag}: train-mode forward of {LEGACY_BATCH} clips "
            f"{T}x{S}^2, outputs {[tuple(a.shape) for a in lo]}; bf16 "
            f"{lo_ms:.1f} ms, float32 {hi_ms:.1f} ms (first call; {card}); "
            f"|bf16 - f32| / |f32| {[f'{e:.3e}' for e in errs]}, float32 "
            f"input-rounding spread {[f'{e:.3e}' for e in spreads]} (tol "
            f"{[f'{t:.3e}' for t in tols]}); launches {launched}"
            + (f"; backward: online/prodictor gradients {lo_g['online']}, "
               f"target gradients {lo_g['target']}, finite {lo_g['finite']}"
               if lo_g else ""))
        if not finite or any(e > t for e, t in zip(errs, tols)) \
                or any(launched.values()):
            raise SystemExit(f"[legacy] {tag}: bf16 and float32 disagree, "
                             "an output is not finite, or a kernel ran")
        if lo_g and not (lo_g["online"] and lo_g["finite"]
                         and lo_g["target"] == 0):
            raise SystemExit(f"[legacy] {tag}: the backward reached the "
                             "target tower, missed the online one or is "
                             "not finite")
    del x
    _family_bench(SLOWFAST_BENCH_RUNS)
    log(f"[slowfast-legacy] phase {time.perf_counter() - t_phase:.1f} s; "
        f"main-path launches {counts}")
    return counts


# ------------------------------------------------------------ tf checkpoint

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, value) -> bytes:
    """One protobuf field: an int as a varint, bytes length-delimited."""
    if isinstance(value, int):
        return _varint(num << 3) + _varint(value)
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def sstable_bytes(items) -> bytes:
    """An uncompressed SSTable of ``items`` ((key, value) bytes pairs,
    sorted by key): one data block with a restart at every entry, an empty
    meta-index block, an index block and the 48-byte footer. The inverse of
    ``cstp_tpu_torch/models/tf_checkpoint.py read_table``."""
    import struct

    from cstp_tpu_torch.models.tf_checkpoint import (
        TABLE_MAGIC,
        crc32c,
        mask_crc,
    )

    def block(entries):
        body, restarts = bytearray(), []
        for k, v in entries:
            restarts.append(len(body))
            body += _varint(0) + _varint(len(k)) + _varint(len(v)) + k + v
        restarts = restarts or [0]
        return bytes(body) + struct.pack(f"<{len(restarts) + 1}I",
                                         *restarts, len(restarts))

    out = bytearray()

    def put(contents):
        handle = _varint(len(out)) + _varint(len(contents))
        out.extend(contents + b"\0" + struct.pack(
            "<I", mask_crc(crc32c(contents + b"\0"))))
        return handle

    data = put(block(items))
    meta = put(block([]))
    index = put(block([(items[-1][0], data)]))
    footer = (meta + index).ljust(40, b"\0")
    return bytes(out) + footer + struct.pack("<II", TABLE_MAGIC & 0xFFFFFFFF,
                                             TABLE_MAGIC >> 32)


def bundle_entry(a, offset: int) -> bytes:
    """A ``BundleEntryProto`` of the float32 array ``a`` at ``offset`` of
    shard 0."""
    import numpy as np

    from cstp_tpu_torch.models.tf_checkpoint import crc32c, mask_crc

    raw = np.ascontiguousarray(a, "<f4").tobytes()
    shape = b"".join(_field(2, _field(1, int(d))) for d in np.shape(a))
    crc = _varint(6 << 3 | 5) + mask_crc(crc32c(raw)).to_bytes(4, "little")
    return (_field(1, 1) + _field(2, shape) + _field(4, offset)
            + _field(5, len(raw)) + crc)


def write_tf_checkpoint(prefix: str, tensors) -> None:
    """A TensorFlow V2 checkpoint (``<prefix>.index`` and one data shard)
    of the float32 arrays ``tensors`` ({name: array}), without TensorFlow:
    what ``tf.compat.v1.train.Saver`` writes for float32 variables."""
    import numpy as np

    data, items = bytearray(), []
    for name in sorted(tensors):
        items.append((name.encode(), bundle_entry(tensors[name], len(data))))
        data += np.ascontiguousarray(tensors[name], "<f4").tobytes()
    header = _field(1, 1) + _field(3, _field(1, 1))   # 1 shard, producer 1
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(data)
    with open(prefix + ".index", "wb") as f:
        f.write(sstable_bytes([(b"", header)] + items))


def kernels_line(conv, aug_err, aug_t, counts):
    """The ``{"kernels": [...]}`` record. K2/K3 times and bounds are per
    pretrain step (its 10 launches at the four sites) and K5's its one
    launch, with launches from the slice phase plus phase 16's main-path
    runs (K5 in the two SlowFast pretrain steps, K2/K3 in the
    ``--legacy_pace`` finetune step); K4a/K4b are one launch at the
    benchmark's default shape, with launches from its taps9 run.
    ``counts`` is None when no step ran."""
    pallas = "cstp_tpu/ops/pallas"
    rows = [
        ("conv21d_stats", "cstp_tpu_torch/csrc/conv21d.cu",
         f"{pallas}/conv21d.py:347", conv["stats"]),
        ("conv21d_fwd", "cstp_tpu_torch/csrc/conv21d.cu",
         f"{pallas}/conv21d.py:432", conv["fwd"]),
        ("conv21d_taps9_stats", "cstp_tpu_torch/csrc/conv21d.cu",
         f"{pallas}/conv21d.py:145", conv["stats_taps9"]),
        ("conv21d_taps9_fwd", "cstp_tpu_torch/csrc/conv21d.cu",
         f"{pallas}/conv21d.py:238", conv["fwd_taps9"]),
        ("augment", "cstp_tpu_torch/csrc/augment.cu",
         f"{pallas}/augment.py:244", dict(aug_t, err=aug_err)),
    ]
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": None if counts is None else counts[name],
         "max_abs_err": r["err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound"],
         "bound_by": r["by"], "library_ms": None}
        for name, src, rep, r in rows]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel-vs-plain phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 2
    try:
        import cstp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import cstp_tpu_torch ({e}); run from the "
              "root of the repository", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[device] TF32 off for cuDNN convolutions and matmuls (comparisons "
        "in full f32)")
    phase_build()
    conv = phase_conv21d(dev)
    aug_err, aug_t = phase_augment(dev)
    phase_hashes(dev)
    counts = None
    if not args.kernels_only:
        sl = phase_slice(dev, card)
        counts = dict(sl["counts"])
        phase_parity(dev)
        bench_counts = phase_bench(dev)
        for k in ("conv21d_taps9_stats", "conv21d_taps9_fwd"):
            counts[k] = bench_counts[k]
        phase_conv21d_paths(dev)
        ft = phase_finetune(dev, card)
        phase_eval(dev, ft["model"], ft["state"])
        del ft
        torch.cuda.empty_cache()
        phase_finetune_parity(dev)
        phase_grad_accum(dev, card)
        bench = phase_bench_step(dev)
        phase_cli(dev, card, sl["step_ms"], bench["pretrain"]["step_ms"])
        phase_flags(dev, card, sl["step_ms"])
        phase_families(dev, card, sl["step_ms"])
        phase_inception(dev, card, sl["step_ms"])
        for k, v in phase_slowfast_legacy(dev, card, sl["step_ms"]).items():
            counts[k] += v
    print(json.dumps(kernels_line(conv, aug_err, aug_t, counts)), flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
