#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cstp_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain only

Phases:
  1. device and build: the card's name and power limit, then every CUDA
     kernel of the port built from ``cstp_tpu_torch/csrc``, and its host
     CSTPack reader (``csrc/cstpack_reader.cc``, ``g++``: the command, the
     seconds and whether ``jpeglib.h`` was found);
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
     loop's step and data-wait ms printed beside phases 3 and 11; the
     CSTPack runs read through the reader ``build_dataset`` takes (the C++
     ``NativePackedDataset``), and the pretrain loader alone over the
     Python and the C++ reader at per-view 16 and 64 (host and landed ms
     per batch);
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
     (pretrain with K5, and ft);
  17. ingest: videos to pretraining through the port's tools alone: 4
     videos written with cv2 (2 classes, 80 frames, 320x240),
     ``extract_frames --res 128 --list-file`` (ffmpeg, or cv2 where there is
     none), ``pack frames`` as JPEG and with ``--raw-hw 128 171``, ``pack
     make-lmdb``, ``pack lmdb`` (byte-identical to the JPEG shard) and
     ``pack info``; the C++ reader held against the Python one (raw frames
     bitwise, JPEG mean |diff| < 2.0, or the JPEG shard refused where the
     reader was built without libjpeg); one ``main_byol`` epoch of 3 steps
     at per-view 16 from the JPEG shard and from the LMDB, 10/10/1 launches
     a step, finite CSV rows, the loop step and data wait beside phase 3.
  18. data parallel (``cstp_tpu_torch/parallel``): (a) phase 4's kernel
     step with ``--ntxent_weight 0.5`` from its weights, generator and
     batch inside a world-1 NCCL group (BN moments all-reduced between K2
     and K3, gradient and metric all-reduces, the gathered NT-Xent)
     against the same step without a group: loss terms within 1e-3
     relative, update cosine >= 0.999, 10/10/1 launches, its step ms over
     3 steps beside phase 3's; (b) two rank processes on the one card over
     gloo (this script with ``--dp-rank``), per-view 8 each, against one
     process on the per-view 16 batch: the kernel step by phase 4's rule
     (10/10/1 launches on each rank) and the plain float32 step to cosine
     0.999; (c) ``torchrun --nproc_per_node 1 -m
     cstp_tpu_torch.cli.main_byol`` (``python -m torch.distributed.run``)
     for one epoch of 3 steps with ``--ntxent_weight 0.5`` on the first 48
     videos of phase 12's CSTPack data, finite CSV rows.
  19. quant_serve (``ops/quant.py``, ``serve/``; R(2+1)D depth 1, 16 x
     112^2 from 128x171 frames, bf16, batch 64 unless named): (a) K6
     (``csrc/int8_conv.cu``) against its float64 plain version at every
     distinct conv shape of the int8_static eval forward (22 shapes, 24
     sites: the Cin-3 stem, the strided downsamples) and at an I3D TF-SAME
     stem (pads (2, 3)) and an I3D 1x1x1 site: int32 accumulators and bf16
     outputs bitwise at batch 4, their hashes, then at batch 64 K6's ms,
     its bound (int8 operations at 1,979 TOPS against the bytes at 3.35
     TB/s), the plain version's ms and cuDNN's bf16 conv3d of the same
     shape; at the 1x1x1 site ``torch._int_mm`` on the same s8 matrices
     (equal int32 result, its ms); (b) ``serve.quantize`` on a float
     finetune checkpoint written here, over 16 of phase 12's videos
     (CSTPack), then ``main_test --quant int8_static`` on 8 test videos
     (24 K6 launches a video), the int8 backbone output map's cosine to
     the float model's, each channel centred (>= Q_BACKBONE_COS, and a
     control with every act_scale at 0.05 below it), and the float
     checkpoint refused by
     ``check_int8_calibrated``; (c) ``serve.export`` of both checkpoints,
     both artifacts loaded in one fresh process (this script with
     ``--serve-check``) that predicts 3 and 8 windows and one video,
     against the live logits step; (d) ``bench_step --mode eval`` and
     ``--mode serve``, float and ``--quant int8_static``, at 64, and one
     eval step of each under torch.profiler; (e) the
     ``--quant int8`` pretrain step at per-view 16 (K5 on) against the
     same step with the plain int8 conv in K6's place (loss terms equal,
     update cosine >= 0.9999; 1 K5 and 48 K6 launches), then
     ``--quant_scope target`` (24 K6).
  20. store_chain (the s8 storage chain, ``--quant int8_store`` /
     ``int8_store_fz``; R(2+1)D depth 1, 16 x 112^2 from 128x171 frames,
     bf16): (a) K6 with its storage epilogue and K7
     (``csrc/int8_store.cu``) at the 12 chain sites of a tower at
     per-view 16 (32 clips a tower call), each against its plain version
     (bitwise: s8 mid, int64 sums, absmax; s8 output, maximum), its ms,
     the plain version's and its bound; (b) the int8_store and
     int8_store_fz pretrain steps at per-view 16 with K5 (the first step
     bootstraps the scales) against the same steps with the chain's plain
     versions on the card (loss terms equal, update cosine >= 0.999, all
     72 scales positive, 24 + 24 K6, 24 K7 and 1 K5 launches a step), with
     their ms beside phase 3's and phase 19's int8 step, then one
     int8_store step under torch.profiler; (c)
     ``bench_step --mode pretrain --quant int8_store`` and
     ``int8_store_fz`` at per-view 64 with K5 (step ms, peak GiB) beside
     phase 13's plain ``--remat`` runs: each must fit, without remat, in
     less memory than the plain ``--remat`` step;
     (d) one ``main_byol --quant int8_store`` epoch of 3 steps at per-view
     16 on phase 12's CSTPack data.
  21. model_axis (the 'model' mesh axis; R(2+1)D depth 1, 16 x 112^2,
     bf16, global per-view batch 8, K5 and the fused sites on, two gloo
     ranks on the one card, the world-1 kernel step and the float32 plain
     step of the same weights and batch as references): (a) (1, 2)
     ``--shard_spatial``: 10 K4a + 10 K4b + 1 K5 launches a step on each
     rank, K4a/K4b held against their plain versions on every padded H
     shard the step gave them (28, 14, 7 and 4 / 3 of the frame's rows),
     with their times and bounds, and the step against world 1 by phase
     4's rule, its ms and each rank's peak GiB beside world 1's; (b) (2, 1)
     ``--shard_opt_state`` bitwise to (2, 1) without it (deterministic
     cuDNN), each rank's optimizer-state bytes; (c) (1, 2) tensor-parallel
     MLPs against world 1; (d) ``torchrun --nproc_per_node 2`` (gloo on
     the one card) ``main_byol`` for one epoch of 3 steps on (1, 2)
     ``--shard_spatial`` on CSTPack files it writes, then its checkpoint
     resumed at world size 1; (e)-(h) (1, 2) ``--shard_spatial`` with
     each R(2+1)D flag, (i)-(l) C3D and r3d-18 and (n)-(q) S3D-G and I3D
     on (1, 2), float and ``--quant int8`` (K6 on the halo-extended
     shards, every launch's input held bitwise), each against the world-1
     step of its own flags; (m) K6 at world 1 at C3D's and r3d-18's conv
     shapes; (r)/(s) S3D-G and I3D on (1, 2) in float32 with the plain
     augment against the world-1 float32 step (MA_F32_LIMITS).
  22. rewrites (the rewrite flags and the evaluation loops over ranks;
     R(2+1)D depth 1, 16 x 112^2, bf16, per-view 16): (a) K2/K3 against
     their plain versions at the ``--mid_round 128`` site shapes (mids
     128 / 256 / 512; conv5's 1152 is phase 2's), phase 2's tolerances,
     plans and repeat check, with their output hashes; (b) one step each
     of ``--mid_round 128 --fused_conv 1`` and ``--s2d_stem --fused_conv
     1`` (10/10/1 launches), ``--t_fold 1`` (0/0/1) and ``--t_fold 1
     --quant int8`` (K5 and 48 K6, the spatial convs' on the folded
     frames) from the same weights and batch against its plain bf16 step
     by phase 4's rule, each timed over 2 steps; (c) ``main_test`` and
     ``main_retrieval``, float and ``--quant int8_static`` (after
     ``serve.quantize``), at world size 1 and under ``torchrun
     --nproc_per_node 2`` (gloo on the one card) on CSTPack files it
     writes (5 test videos, 16 train videos): the reports byte for byte,
     no file written by rank 1, K6 launched on each rank for its own
     videos; ``main_test --quant int8_static`` of R(2+1)D, r3d-18 and I3D
     on (1, 2) ``--shard_spatial`` too (world 1's report), and an I3D
     ``--i3d_conv_head`` finetune step at 16 x 224^2 on (1, 2) against the
     world-1 step by phase 4's rule; (d) the s3d_byol ``--s2d_stem`` pretrain step with K5 against
     its plain step by phase 4's rule.
Then one JSON line describing the kernels (``launches`` null with
``--kernels-only``, which runs phase 19 (a) and 20 (a) too; the slice
phase's launches plus those of phase 16's K5 and ``--legacy_pace`` steps,
of phase 18's main-path steps, of phase 19's int8 test run and pretrain
steps, of phase 20's steps and epoch, of phase 21's ranks' steps and of
phase 22's kernel steps and world-2 ranks), the
card's name and power limit, and a last JSON line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import math
import subprocess
import sys
import time

import torch

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
PEAK_INT8 = 1979e12     # H100 SXM dense int8 tensor-core operations/s

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
    """Every CUDA library (one ``nvcc`` per source, all at once) and the
    host reader (``g++``); returns the reader's build record."""
    from pathlib import Path

    from cstp_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[build] {len(logs)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s from cstp_tpu_torch/csrc into "
        f"{build.build_dir()}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    t0 = time.perf_counter()
    jpeg = build.has_jpeglib()
    path = build.build_host("cstpack_reader")
    reader = dict(seconds=time.perf_counter() - t0, jpeg=jpeg,
                  command=" ".join(build.host_command(
                      "cstpack_reader", Path(path), jpeg)))
    log(f"[build] host reader csrc/cstpack_reader.cc in "
        f"{reader['seconds']:.1f} s, jpeglib.h found: {jpeg}: "
        f"{reader['command']}")
    return reader


def _hold_pair(tiling, x, ws, wt, scale, bias, groups=G, padded=False):
    """One tiling's kernel pair against the plain version on one input in
    ``groups`` BN groups (``padded``: ``x`` is a padded H shard of
    ``--shard_spatial``, taken by the taps9 pair as it is). Returns per
    pass its max abs error, kernel ms, and the operations and bytes the
    pass must do: one spatial conv, plus the temporal conv in pass B, each
    input read once and each output written once."""
    from cstp_tpu_torch.ops import conv21d as C

    cin, m = ws.shape[2:]
    cout = wt.shape[2]
    if tiling == "clip":
        xk = x.contiguous()
        wsk = ws.to(torch.bfloat16).reshape(9 * cin, m).contiguous()
        stats, fwd = C.run_stats, C.run_fwd
    else:
        xk = x.contiguous() if padded else C.pad_hw(x.contiguous())
        wsk = ws.to(torch.bfloat16).contiguous()
        stats, fwd = C.run_stats_taps9, C.run_fwd_taps9
    wtb = wt.to(torch.bfloat16).contiguous()
    gm, gv = stats(xk, wsk, groups)
    gm2, gv2 = stats(xk, wsk, groups)
    bitwise = torch.equal(gm, gm2) and torch.equal(gv, gv2)
    out = fwd(xk, wsk, wtb, gm, gv, scale, bias, groups)
    pm, pv = C.reference_stats(x, ws, groups, padded=padded)
    # pass B given the same statistics, so its check isolates pass B
    pout = C.reference_chain(x, ws, wt, scale, bias, gm, gv, groups,
                             padded=padded)
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
    npix = (x.shape[0] * x.shape[1] * (x.shape[2] - 2 * padded)
            * (x.shape[3] - 2 * padded))
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
    want = _per_step(10 * steps, 10 * steps, steps)
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


def _agree(run, ref, f32, acc_tol: float = 0.125, reordered=None):
    """Phase 4's rule for ``run`` against ``ref`` (a bf16 step of the same
    weights, generator and batch), with the float32 step ``f32`` as
    arbiter: ``(loss_err, acc_err, cos_run, cos_ref, ok)``. ``reordered``:
    ``ref``'s step with its BatchNorm sums taken in another order; the
    cosine arm then holds ``run`` to the lower of the two steps' cosines
    (phase 21's MA_REORDERED).

    Tolerances. Losses: both bf16 paths round the same values in another
    summation order, so loss terms agree to a few bf16 ulps (2e-2 relative)
    and an accuracy may flip by two of 16 predictions (``acc_tol``). The
    update: the gradient of this network is ill conditioned (BatchNorm
    backward of pooled features cancels to a small residual), so bf16
    rounding alone turns its direction; ``run`` must stay as close to the
    float32 update as ``ref`` does (cosine within 0.05 of it)."""
    mk, mp = run["metrics"], ref["metrics"]
    loss_err = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-6)
                   for k in mk if k.startswith("loss"))
    acc_err = max(abs(mk[k] - mp[k]) for k in mk if k.startswith("acc"))
    cos_run, cos_ref = _cos(run, f32), _cos(ref, f32)
    floor = cos_ref if reordered is None else min(cos_ref,
                                                  _cos(reordered, f32))
    ok = (loss_err <= 2e-2 and acc_err <= acc_tol
          and cos_run >= floor - 0.05)
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
    want = _per_step(FT_LAUNCHES * steps, FT_LAUNCHES * steps, 0)
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
    want = _per_step(20 * steps, 20 * steps, steps)
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
CLI_STEPS = 6           # pretrain steps per epoch at per-view B_VIEW
CLI_STEPS64 = 3         # steps of the per-view BENCH_STEP_BS epoch
CLI_TRAIN = CLI_STEPS64 * BENCH_STEP_BS   # enough videos for per-view 64
CLI_EVAL = 16           # val and test videos
CLI_FT_STEPS = CLI_TRAIN // B_FT   # a finetune epoch over the train file
CLI_JPEG_STEPS = 3      # the frame-dir JPEG epoch, per-view B_VIEW


def _cli_videos():
    """The synthetic videos of phase 12's CSTPack files."""
    from cstp_tpu_torch.data.synthetic import SyntheticVideoDataset

    return SyntheticVideoDataset(n_videos=CLI_TRAIN + 2 * CLI_EVAL,
                                 n_classes=N_FT_CLASSES, ingest_hw=(H0, W0),
                                 seed=0)


def _pack_videos(path: str, ds, ids, pool) -> None:
    """Videos ``ids`` of ``ds`` (CLI_FRAMES raw frames each) into a CSTPack
    file at ``path``."""
    from cstp_tpu_torch.data.packed import PackedWriter

    w = PackedWriter(path)
    for lo in range(0, len(ids), 32):
        chunk = ids[lo:lo + 32]
        for i, f in zip(chunk, pool.map(
                lambda i: ds.read_frames(i, range(CLI_FRAMES)), chunk)):
            w.add_video_raw(f"v{i:04d}", ds.video_meta(i)[1], f)
    w.close()


def _cli_data(root: str):
    """Train, val and test CSTPack files (``build_dataset`` finds val and
    test by replacing "train" in the train file's path) and a frame
    directory of JPEGs with its split list; returns their paths."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    ds = _cli_videos()

    def frames(i):
        return ds.read_frames(i, range(CLI_FRAMES))

    paths = {k: os.path.join(root, f"{k}.cstp")
             for k in ("train", "val", "test")}
    spans = {"train": range(CLI_TRAIN),
             "val": range(CLI_TRAIN, CLI_TRAIN + CLI_EVAL),
             "test": range(CLI_TRAIN + CLI_EVAL, CLI_TRAIN + 2 * CLI_EVAL)}
    with ThreadPoolExecutor(8) as pool:
        for split, ids in spans.items():
            _pack_videos(paths[split], ds, ids, pool)

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
    BENCH_STEP_BS, over the Python reader (per-clip thread pool) and the C++
    reader (``read_clips``, one native call a batch), both with 6 threads:
    host ms per batch, and ms per batch landed on the card through
    ``prefetch_to_device``, over the batches after the first of an epoch
    (CLI_STEPS at most)."""
    from cstp_tpu_torch.data.loader import PretrainLoader, prefetch_to_device
    from cstp_tpu_torch.data.native_reader import NativePackedDataset
    from cstp_tpu_torch.data.packed import PackedDataset

    out = {}
    for reader, ds in (("python", PackedDataset(train)),
                       ("native", NativePackedDataset(train, n_threads=6))):
        for bs in (B_VIEW, BENCH_STEP_BS):
            res, n = [], min(CLI_STEPS, CLI_TRAIN // bs) - 1
            for land in (False, True):
                it = PretrainLoader(ds, bs, T, seed=1,
                                    num_workers=6).epoch(1)
                if land:
                    it = prefetch_to_device(it, dev)
                next(it)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    next(it)
                torch.cuda.synchronize()
                res.append((time.perf_counter() - t0) * 1e3 / n)
                it.close()
            out[reader, bs] = tuple(res)
        ds.close()
    return out


def _packed_reader(path: str) -> str:
    """The reader ``build_dataset`` takes for the CSTPack file ``path``."""
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.train.loops import build_dataset

    ds = build_dataset(Config(data_backend="packed", lmdb_path=path,
                              n_workers=6).finalize(), "train")
    name = type(ds).__name__
    ds.close()
    return name


def _argv(flags):
    """CLI arguments of config ``flags``."""
    return [a for k, v in flags.items() for a in (f"--{k}", str(v))]


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
    ``save_1_max``, retrieval from save_2, a pretrain epoch of CLI_STEPS64
    at per-view BENCH_STEP_BS (bench.py's) and one from a frame directory
    of JPEGs.
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
        log(f"[cli] the packed runs read through "
            f"{_packed_reader(train)} (train/loops.py build_dataset)")
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
            "--steps_per_epoch", str(CLI_STEPS64), "--ckpt_every_epochs",
            "100", "--result_path", os.path.join(root, "results64")],
            per_pre, CLI_STEPS64)
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
    for (reader, bs), (host_ms, landed_ms) in times["loader"].items():
        log(f"[cli] loader alone, {reader} reader, per-view {bs}: "
            f"{host_ms:.1f} ms per host batch ({2 * bs * T} frames of "
            f"{H0}x{W0}, 6 threads), {landed_ms:.1f} ms per batch landed on "
            f"the card through prefetch_to_device ({card})")
    log(f"[cli] pretrain CSV {n_rows} finite rows (2 epochs + 2 resumed); "
        f"test {times['test_s']:.1f} s for {CLI_EVAL} videos, accuracy "
        f"{float(acc[1]):.4f}; retrieval {times['retrieval_s']:.1f} s, R@k "
        f"{recalls}; phase {time.perf_counter() - t_phase:.1f} s")
    return times


# ------------------------------------------------------------ step flags

def _per_step(c2, c3, c5, c6=0, c6s=0, c7=0):
    """Launches of every kernel: K2, K3, K5, K6 (dequantizing), K6 with the
    storage epilogue, K7."""
    return {"conv21d_stats": c2, "conv21d_fwd": c3, "conv21d_taps9_stats": 0,
            "conv21d_taps9_fwd": 0, "augment": c5, "int8_conv": c6,
            "int8_conv_store": c6s, "int8_bn_relu": c7}


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
    FLAG_BENCH_RUNS: step ms, pairs/s, peak GiB and launches per step;
    returns those runs by their flags (None where out of memory)."""
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
    benches = {}
    for flags, want, must_fit in FLAG_BENCH_RUNS:
        try:
            r = benches[" ".join(flags)] = bench_step.main(
                ["--mode", "pretrain", "--steps", "2", "--warmup", "1",
                 *flags])
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
    return benches


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

    common = _argv(kw) + [
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
    trip for s3d_byol and i3d_byol; and the ``--tf_i3d_ckpt`` loads.
    ``bench_step`` is driven by phases 11, 14 and 16; S3D-G's and I3D's
    readings at per-view 64 are those of PERF.md (PR 13)."""
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


# ---------------------------------------------------------------- ingest

# phase 17: videos -> frames -> CSTPack / LMDB -> pretraining, through the
# port's ingest tools on the card's machine
INGEST_VIDEOS = 4         # 2 classes x 2 videos, written with cv2
INGEST_FRAMES = 80
INGEST_WH = (320, 240)    # width, height; --res 128 gives 171 x 128 frames
INGEST_STEPS = 3          # steps of each pretrain epoch, per-view B_VIEW
# each video listed this many times in the split list, so that an epoch
# has INGEST_STEPS batches of B_VIEW
INGEST_REPEAT = -(-INGEST_STEPS * B_VIEW // INGEST_VIDEOS)


def _ingest_videos(root: str) -> None:
    """INGEST_VIDEOS MJPG videos of INGEST_FRAMES frames at INGEST_WH, 25
    fps: a smooth random picture from seed 0 that pans over time."""
    import os

    import cv2
    import numpy as np

    rng = np.random.default_rng(0)
    w, h = INGEST_WH
    for v in range(INGEST_VIDEOS):
        d = os.path.join(root, f"class{v % 2}")
        os.makedirs(d, exist_ok=True)
        wr = cv2.VideoWriter(os.path.join(d, f"clip{v}.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), 25, (w, h))
        if not wr.isOpened():
            raise SystemExit("cv2.VideoWriter could not open an MJPG file")
        base = cv2.resize(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8),
                          (w, h), interpolation=cv2.INTER_CUBIC)
        for t in range(INGEST_FRAMES):
            wr.write(np.roll(base, 4 * t, axis=1))
        wr.release()


def _tool(main, argv):
    """A tool's ``main(argv)`` in process; returns its printed lines
    (standard output and error), each echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[ingest]   {line}")
    if rc != 0:
        raise SystemExit(f"{main.__module__} {argv} returned {rc}")
    return lines


def _hold_readers(raw: str, jpeg: str, has_jpeg: bool):
    """``NativePackedDataset`` against ``PackedDataset``: the raw shard's
    frames bitwise at the stored size and mean |diff| < 6.0 resized to
    S x S; the JPEG shard's mean |diff| < 2.0 where the reader has libjpeg,
    and refused (``NoJpegDecoder``) where it has not. Returns the text of
    the record."""
    import numpy as np

    from cstp_tpu_torch.data.native_reader import (
        NativePackedDataset,
        NoJpegDecoder,
    )
    from cstp_tpu_torch.data.packed import PackedDataset

    frames = list(range(INGEST_FRAMES))
    worst = []
    for hw in ((H0, W0), (S, S)):
        nat = NativePackedDataset(raw, ingest_hw=hw, n_threads=6)
        py = PackedDataset(raw, ingest_hw=hw)
        d = max(np.abs(nat.read_frames(i, frames).astype(np.int16)
                       - py.read_frames(i, frames)).mean()
                for i in range(nat.num_videos()))
        if hw == (H0, W0) and d != 0:
            raise SystemExit(f"native raw frames differ from the Python "
                             f"reader's (mean |diff| {d})")
        if d >= 6.0:
            raise SystemExit(f"native resized raw frames mean |diff| {d}")
        worst.append(float(d))
        nat.close()
        py.close()
    text = (f"raw frames bitwise at {H0}x{W0} (mean |diff| {worst[0]}), "
            f"mean |diff| {worst[1]:.3f} at {S}x{S} (bound 6.0)")
    if has_jpeg:
        nat = NativePackedDataset(jpeg, ingest_hw=(H0, W0), n_threads=6)
        py = PackedDataset(jpeg, ingest_hw=(H0, W0))
        d = max(np.abs(nat.read_frames(i, frames).astype(np.int16)
                       - py.read_frames(i, frames)).mean()
                for i in range(0, nat.num_videos(), INGEST_REPEAT))
        nat.close()
        py.close()
        if d >= 2.0:
            raise SystemExit(f"native JPEG frames mean |diff| {d}")
        return text + f"; JPEG frames mean |diff| {d:.3f} (bound 2.0)"
    try:
        NativePackedDataset(jpeg)
    except NoJpegDecoder as e:
        return text + f"; JPEG shard refused: {e}"
    raise SystemExit("a reader built without libjpeg opened a JPEG shard")


def phase_ingest(dev, card: str, slice_ms: float, reader_build):
    """Videos to pretraining through the port alone: INGEST_VIDEOS videos
    written with cv2, ``extract_frames --res 128 --list-file`` (ffmpeg
    where it is on the PATH, else cv2), ``pack frames`` as JPEG and with
    ``--raw-hw``, ``pack make-lmdb``, ``pack lmdb`` (byte-identical to the
    JPEG shard) and ``pack info``; the C++ reader held against the Python
    one; then one ``main_byol`` epoch of INGEST_STEPS steps from the JPEG
    shard (``--data_backend packed``) and from the LMDB (``--data_backend
    lmdb``), each at 10/10/1 launches a step with finite CSV rows. Prints
    the loop step and data wait beside phase 3's bare step."""
    import os
    import shutil
    import tempfile

    from cstp_tpu_torch.cli import main_byol
    from cstp_tpu_torch.data import extract_frames, pack

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cstp_ingest_") as root:
        vids, frames = os.path.join(root, "videos"), os.path.join(root,
                                                                 "frames")
        ann = os.path.join(root, "ann")
        os.makedirs(ann)
        t0 = time.perf_counter()
        _ingest_videos(vids)
        t_write = time.perf_counter() - t0
        listed = os.path.join(root, "extracted.txt")
        decoder = ("ffmpeg" if shutil.which("ffmpeg")
                   else "cv2 (no ffmpeg on the PATH)")
        t0 = time.perf_counter()
        _tool(extract_frames.main, [
            "--vid-dir", vids, "--frame-dir", frames, "--res", "128",
            "--fps", "25", "--workers", "4", "--list-file", listed])
        t_extract = time.perf_counter() - t0
        with open(listed) as f:
            lines = f.read().splitlines()
        want = sorted(f"class{v % 2}/clip{v} {v % 2} {INGEST_FRAMES}"
                      for v in range(INGEST_VIDEOS))
        if sorted(lines) != want:
            raise SystemExit(f"extract_frames listed {lines}, not {want}")
        split = os.path.join(ann, "trainlist01_nframe.txt")
        with open(split, "w") as f:
            f.write("".join(f"{line}\n" for line in lines
                            for _ in range(INGEST_REPEAT)))
        jpeg, raw, conv, db = (os.path.join(root, n) for n in (
            "train_jpeg.cstp", "raw.cstp", "from_lmdb.cstp", "lmdb"))
        t0 = time.perf_counter()
        _tool(pack.main, ["frames", "--frame-dir", frames, "--annotation",
                          split, "--out", jpeg])
        _tool(pack.main, ["frames", "--frame-dir", frames, "--annotation",
                          listed, "--out", raw, "--raw-hw", str(H0),
                          str(W0)])
        _tool(pack.main, ["make-lmdb", "--frame-dir", frames, "--out", db])
        _tool(pack.main, ["lmdb", "--lmdb", db, "--annotation-path", ann,
                          "--out", conv])
        info = _tool(pack.main, ["info", jpeg]) + _tool(pack.main,
                                                        ["info", raw])
        t_pack = time.perf_counter() - t0
        with open(jpeg, "rb") as a, open(conv, "rb") as b:
            if a.read() != b.read():
                raise SystemExit("pack lmdb's CSTPack differs from pack "
                                 "frames' on the same split list")
        held = _hold_readers(raw, jpeg, reader_build["jpeg"])
        log(f"[ingest] readers: {held}")
        log(f"[ingest] the JPEG shard reads through {_packed_reader(jpeg)},"
            f" the raw shard through {_packed_reader(raw)} (build_dataset)")

        common = ["--model_name", "r21d_byol", "--model_depth", "1",
                  "--sample_duration", str(T), "--sample_size", str(S),
                  "--compute_dtype", "bfloat16", "--fused_conv", "1",
                  "--log_every", "0", "--n_workers", "6",
                  "--dataset", "UCF101", "--task", "loss_com",
                  "--pallas_augment", "on", "--learning_rate", "0.03",
                  "--batch_size", str(B_VIEW), "--n_epochs", "1",
                  "--steps_per_epoch", str(INGEST_STEPS),
                  "--ckpt_every_epochs", "100"]
        per_pre = {"conv21d_stats": 10, "conv21d_fwd": 10, "augment": 1}
        times = {}
        for name, data in (
                ("packed", ["--data_backend", "packed", "--lmdb_path",
                            jpeg]),
                ("lmdb", ["--data_backend", "lmdb", "--lmdb_path", db,
                          "--annotation_path", ann])):
            res = os.path.join(root, f"results_{name}")
            out, _ = _cli_run(main_byol.main, common + data + [
                "--result_path", res], per_pre, INGEST_STEPS)
            times[name] = _loop_times(out, B_VIEW)
            losses = [h["loss"] for h in out["history"]]
            del out
            torch.cuda.empty_cache()
            if not all(math.isfinite(v) for v in losses):
                raise SystemExit(f"the {name} epoch gave a non-finite loss")
            _check_rows(os.path.join(
                res, "UCF101", "loss_com",
                f"UCF101_train_clip{T}modelr21d_byol1.log"))
    seconds = time.perf_counter() - t_phase
    log(f"[ingest] {INGEST_VIDEOS} videos of {INGEST_FRAMES} frames at "
        f"{INGEST_WH[0]}x{INGEST_WH[1]} written in {t_write:.1f} s; "
        f"extract_frames by {decoder} in {t_extract:.1f} s; pack frames "
        f"(JPEG, {INGEST_VIDEOS * INGEST_REPEAT} list entries; raw "
        f"{H0}x{W0}), make-lmdb, lmdb (byte-identical to the JPEG shard) and "
        f"info in {t_pack:.1f} s: {' | '.join(info)}")
    log(f"[ingest] reader build (phase 1): {reader_build['seconds']:.1f} s, "
        f"jpeglib.h found: {reader_build['jpeg']}")
    for name, t in times.items():
        log(f"[ingest] main_byol from the {name} shard (per-view {B_VIEW}, "
            f"{t['steps']} steps): loop step {t['step_ms']:.1f} ms, data "
            f"wait {t['wait_ms']:.2f} ms per step (steps after the first), "
            f"epoch wall {t['wall_ms']:.1f} ms per step; phase 3's bare step "
            f"{slice_ms:.1f} ms, loop / bare {t['step_ms'] / slice_ms:.3f} "
            f"({card})")
    log(f"[ingest] phase {seconds:.1f} s")
    return dict(times=times, seconds=seconds)


# ------------------------------------------------------ data parallel

DP_STEPS = 3            # pretrain steps of phase 18's torchrun epoch


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_config():
    """Phase 4's kernel configuration with the NT-Xent term."""
    return _slice_config(True, ntxent_weight=0.5)


def _loss_err(run, ref):
    return max(abs(run["metrics"][k] - ref["metrics"][k])
               / max(abs(ref["metrics"][k]), 1e-6)
               for k in ref["metrics"] if k.startswith("loss"))


def _dp_runs():
    """Phase 18 (b)'s configurations: the kernel step (phase 4's, with the
    NT-Xent term) and the plain float32 step, its arbiter."""
    return {"kernel": _dp_config(),
            "f32": _slice_config_plain_f32(ntxent_weight=0.5)}


def dp_rank(rank: int, world: int, port: int, out: str,
            device: str = "cuda:0") -> None:
    """One rank of phase 18 (b): each of ``_dp_runs`` on its rows of phase
    4's per-view B_VIEW batch, over gloo on card 0; writes the metrics,
    launches and step ms, and (rank 0) the updates, under ``out``."""
    import os

    from cstp_tpu_torch.parallel import mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0")
    dev = torch.device(device)
    mesh.maybe_initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", device=dev, backend="gloo")
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rows = mesh.shard_batch(_slice_batch(dev, seed=4))
        result = {}
        for name, cfg in _dp_runs().items():
            run = _one_step_run(dev, cfg, rows)
            update = run.pop("update")
            run.pop("stats")
            run["update_norm"] = float(update.norm())
            if mesh.is_main():
                torch.save(update.float().cpu(), f"{out}.{name}.pt")
            result[name] = run
        torch.save(result, f"{out}.{rank}.pt")
    finally:
        mesh.shutdown()


def _dp_two_ranks(one, world: int = 2):
    """Phase 18 (b): ``world`` rank processes on the one card over gloo,
    each per-view B_VIEW / world, against the one-process steps ``one``
    (``_dp_runs``' names) on the global batch. The plain float32 step must
    match (loss terms within 1e-3 relative, update cosine >= 0.999). The
    kernel step is held by phase 4's rule: loss terms within 2e-2, and its
    update as close to the float32 update as the one-process kernel
    step's (cosine within 0.05): two bf16 steps that sum in other orders
    (rank halves, other cuDNN algorithms at half the batch) differ by
    their rounding, amplified by this network's ill-conditioned gradient,
    as phase 4's kernel and plain steps do. Returns the ranks' launches."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="cstp_dp_") as d:
        out, port = os.path.join(d, "rank"), _free_port()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("CSTP_", "MASTER_"))}
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--dp-rank", str(r), str(world),
             str(port), out], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            for line in text.splitlines()[-20:]:
                log(f"[dp]   rank {r}: {line}")
            if p.returncode != 0:
                raise SystemExit(f"[dp] rank {r} of {world} over gloo "
                                 f"exited {p.returncode}")
        ranks = [torch.load(f"{out}.{r}.pt", weights_only=False)
                 for r in range(world)]
        updates = {n: torch.load(f"{out}.{n}.pt").double().to(
            one[n]["update"].device) for n in one}

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a, b, dim=0))

    kernel_want = _per_step(10, 10, 1)
    ok = True
    for name, run in one.items():
        got = [r[name] for r in ranks]
        loss_err = _loss_err(got[0], run)
        c = cos(updates[name], run["update"])
        want = (kernel_want if name == "kernel"
                else dict.fromkeys(kernel_want, 0))
        if name == "kernel":
            c_f32 = cos(updates[name], one["f32"]["update"])
            c_one = _cos(run, one["f32"])
            rule = (f"cosine to the float32 update: {world} ranks "
                    f"{c_f32:.5f}, one process {c_one:.5f} (tol {world} "
                    f"ranks >= one process - 0.05)")
            ok &= loss_err <= 2e-2 and c_f32 >= c_one - 0.05
        else:
            rule = "tol: loss terms 1e-3, cosine 0.999"
            ok &= loss_err <= 1e-3 and c >= 0.999
        ok &= all(g["counts"] == want for g in got)
        ok &= len({g["update_norm"] for g in got}) == 1
        log(f"[dp] (b) {name}: {world} ranks on one card over gloo, "
            f"per-view {B_VIEW // world} each, against one process on the "
            f"per-view {B_VIEW} batch: max rel loss-term err {loss_err:.3e}"
            f", update cosine {c:.5f}; {rule}; rank updates' norms "
            f"{[round(g['update_norm'], 6) for g in got]}; launches "
            f"{[g['counts'] for g in got]}; step ms (2 steps after the "
            f"first) {[round(g['ms'], 1) for g in got]}")
    if not ok:
        raise SystemExit(f"[dp] the {world}-rank steps and the one-process "
                         "steps disagree")
    return [r["kernel"]["counts"] for r in ranks]


def _dp_torchrun(dev) -> float:
    """Phase 18 (c): ``torchrun --nproc_per_node 1 -m
    cstp_tpu_torch.cli.main_byol`` for one epoch of DP_STEPS steps with
    ``--ntxent_weight 0.5`` on the first videos of phase 12's CSTPack
    train file, written here; finite CSV rows. Returns its seconds."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    with tempfile.TemporaryDirectory(prefix="cstp_dp_cli_") as root:
        train = os.path.join(root, "train.cstp")
        with ThreadPoolExecutor(8) as pool:
            _pack_videos(train, _cli_videos(), range(DP_STEPS * B_VIEW),
                         pool)
        res = os.path.join(root, "results")
        argv = ["--model_name", "r21d_byol", "--model_depth", "1",
                "--sample_duration", str(T), "--sample_size", str(S),
                "--compute_dtype", "bfloat16", "--fused_conv", "1",
                "--pallas_augment", "on", "--ntxent_weight", "0.5",
                "--task", "loss_com", "--batch_size", str(B_VIEW),
                "--n_epochs", "1", "--steps_per_epoch", str(DP_STEPS),
                "--log_every", "1", "--n_workers", "6",
                "--data_backend", "packed", "--lmdb_path", train,
                "--dataset", "UCF101", "--result_path", res]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "cstp_tpu_torch.cli.main_byol",
               *argv]
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("CSTP_", "MASTER_"))}
        env["PYTHONPATH"] = os.pathsep.join(
            [os.getcwd()] + [p for p in [os.environ.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=300)
        seconds = time.perf_counter() - t0
        for line in (done.stdout + done.stderr).splitlines()[-12:]:
            log(f"[dp]   torchrun: {line}")
        if done.returncode != 0:
            raise SystemExit(f"[dp] torchrun main_byol exited "
                             f"{done.returncode}")
        rows = _check_rows(os.path.join(
            res, "UCF101", "loss_com",
            f"UCF101_train_clip{T}modelr21d_byol1.log"))
    log(f"[dp] (c) torchrun --nproc_per_node 1 -m cstp_tpu_torch.cli."
        f"main_byol, --ntxent_weight 0.5, 1 epoch of {DP_STEPS} steps at "
        f"per-view {B_VIEW} on {DP_STEPS * B_VIEW} videos of phase 12's "
        f"CSTPack data: {rows} finite CSV row(s), {seconds:.1f} s with the "
        "process start")
    return seconds


def phase_data_parallel(dev, card: str, slice_ms: float):
    """Phase 18: (a) phase 4's kernel step with ``--ntxent_weight 0.5``
    from its weights, generator and batch, alone and then inside a world-1
    NCCL group (cross-rank BN between K2 and K3, gradient and metric
    all-reduces, the gathered NT-Xent): loss terms within 1e-3 relative,
    update cosine >= 0.999, 10/10/1 launches, step ms over 3 steps beside
    phase 3's; (b) two ranks on the one card over gloo; (c) a torchrun
    epoch. Returns the launches of its main-path runs."""
    import os

    from cstp_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    cfg, batch = _dp_config(), _slice_batch(dev, seed=4)
    alone = _one_step_run(dev, cfg, batch, timed_steps=3)
    saved = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE",
                                            "LOCAL_RANK")}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        mesh.maybe_initialize_distributed(
            init_method=f"tcp://127.0.0.1:{_free_port()}", device=dev)
        backend = torch.distributed.get_backend()
        grouped = _one_step_run(dev, cfg, batch, timed_steps=3)
    finally:
        mesh.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    loss_err = _loss_err(grouped, alone)
    cos = _cos(grouped, alone)
    diff = float((grouped["update"] - alone["update"]).abs().max())
    want = _per_step(10, 10, 1)
    log(f"[dp] (a) world size 1 over {backend}, r21d depth 1, {T}x{S}^2 "
        f"bf16, per-view {B_VIEW}, fused_conv=1 pallas_augment=on "
        f"ntxent_weight=0.5, against the same step without a process group: "
        f"max rel loss-term err {loss_err:.3e} (tol 1e-3); update cosine "
        f"{cos:.6f} (tol 0.999), max |update diff| {diff:.3e}; launches "
        f"{grouped['counts']}")
    log(f"[dp] (a) step ms (3 steps after the first): world-1 group "
        f"{grouped['ms']:.1f}, no group {alone['ms']:.1f} (the collectives' "
        f"cost {grouped['ms'] - alone['ms']:+.1f} ms); phase 3's step "
        f"(no NT-Xent) {slice_ms:.1f} ({card})")
    if grouped["counts"] != want:
        raise SystemExit(f"[dp] launches {grouped['counts']}, expected "
                         f"{want}")
    if loss_err > 1e-3 or cos < 0.999:
        raise SystemExit("[dp] the world-1 step differs from the step "
                         "without a process group")
    counts = dict(grouped["counts"])
    del grouped
    torch.cuda.empty_cache()
    one = {"kernel": alone,
           "f32": _one_step_run(dev, _dp_runs()["f32"], batch)}
    for c in _dp_two_ranks(one):
        for k, v in c.items():
            counts[k] += v
    del alone, one
    torch.cuda.empty_cache()
    _dp_torchrun(dev)
    log(f"[dp] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


Q_EVAL_BS = 64          # the int8_static eval forward's batch (bench.py's)
Q_CHECK_BS = 4          # K6 against its float64 plain version, bitwise
# I3D sites beside R(2+1)D's (16 x 224^2 clips): (name, input (T, H, W,
# Cin), Cout, kernel, stride, low pads, high pads)
Q_I3D_SITES = [
    ("i3d conv3d_1a_7x7 (TF-SAME pads (2, 3))", (16, 224, 224, 3), 64,
     (7, 7, 7), (2, 2, 2), (2, 2, 2), (3, 3, 3)),
    ("i3d mixed_3b branch_0 (1x1x1)", (8, 28, 28, 192), 64, (1, 1, 1),
     (1, 1, 1), (0, 0, 0), (0, 0, 0)),
]
Q_CALIB_VIDEOS = 16     # train videos the calibration draws from
Q_TEST_VIDEOS = 8       # test videos of the int8_static main_test run
Q_SERVE_BATCHES = (3, 8)  # the served program's window batches
# the int8_static backbone output map's cosine to the float model's, each
# channel centred (the post-ReLU maps share a large per-channel mean, so
# their plain cosine is near 1 whatever the path; pooled over 98 positions
# the windows of these videos barely differ). It read 0.988 on an H100
# 80GB HBM3 at 700 W, and 0.000 with every act_scale at 0.05.
Q_BACKBONE_COS = 0.95


def _quant_config(quant: str = "", **over):
    """The int8 phase's eval config: R(2+1)D depth 1, 16 x 112^2, bf16,
    101 classes, no fused sites (``--fused_conv`` and ``--quant`` are
    exclusive)."""
    return _ft_config(fused=0, task="test", quant=quant, **over)


def _int8_sites(dev, model=None):
    """The distinct conv shapes of a model's eval forward on one clip (by
    default the int8_static R(2+1)D eval forward's, 24 K6 launches), in
    order: {(input (T, H, W, Cin), Cout, kernel, stride, lo, hi): [site
    names]}, from forward pre-hooks."""
    from cstp_tpu_torch.models.layers import Conv3d
    from cstp_tpu_torch.perf.bench_step import fill_act_scales
    from cstp_tpu_torch.train.finetune import create_classify_model

    if model is None:
        model = create_classify_model(_quant_config("int8_static"),
                                      N_FT_CLASSES, device=dev)
    fill_act_scales(model)
    sites = {}

    def hook(name):
        def record(m, args):
            lo = tuple(p[0] for p in m.pad_pairs)
            hi = tuple(p[1] for p in m.pad_pairs)
            key = (tuple(args[0].shape[1:]), m.weight.shape[0], m.kernel,
                   m.stride, lo, hi)
            sites.setdefault(key, []).append(name)
        return record

    handles = [m.register_forward_pre_hook(hook(n))
               for n, m in model.named_modules() if isinstance(m, Conv3d)]
    with torch.no_grad():
        model(torch.zeros((1, T, S, S, 3), device=dev, dtype=torch.bfloat16),
              train=False)
    for h in handles:
        h.remove()
    del model
    return sites


def _read_extent(n_in: int, n_out: int, k: int, s: int, lo: int) -> int:
    """The input positions along one axis that a conv's taps read: the
    union of the ``n_out`` output positions' windows, inside the input (a
    strided 1x1x1 conv reads every ``s``-th position only)."""
    return len({o * s + j - lo for o in range(n_out) for j in range(k)}
               & set(range(n_in)))


def _k6_site(dev, gen, key, batch: int = Q_EVAL_BS):
    """K6 at one conv shape: int32 accumulators and bf16 outputs against
    the plain version at batch Q_CHECK_BS (bitwise), their hash, then at
    ``batch`` K6's ms, the plain version's, cuDNN's bf16 conv3d of the
    same shape (another precision: the float path int8 replaces) and the
    bound (int8 operations at 1,979 TOPS against the bytes at 3.35 TB/s:
    the input positions the taps read, the weights, the scales and the
    bf16 output)."""
    import hashlib

    import torch.nn.functional as F

    from cstp_tpu_torch.ops import quant as Q

    (t, h, w, cin), cout, k, stride, lo, hi = key
    args = (list(stride), list(lo), list(hi))
    xq = torch.randint(-127, 128, (batch, t, h, w, cin), generator=gen,
                       device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, cin, *k), generator=gen, device=dev,
                       dtype=torch.int8)
    scale = torch.rand(cout, generator=gen, device=dev) * 1e-3 + 1e-5
    xs = xq[:Q_CHECK_BS].contiguous()
    acc = Q.int8_conv3d_cuda(xs, wq, scale, *args, torch.int32)
    out = Q.int8_conv3d_cuda(xs, wq, scale, *args, torch.bfloat16)
    acc_p = Q.int8_conv3d_plain(xs, wq, scale, *args, torch.int32)
    out_p = Q.int8_conv3d_plain(xs, wq, scale, *args, torch.bfloat16)
    torch.cuda.synchronize()
    err = float((out.float() - out_p.float()).abs().max())
    bitwise = torch.equal(acc, acc_p) and torch.equal(out, out_p)
    digest = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()
                            ).hexdigest()[:16]
    del acc, out, acc_p, out_p, xs
    ms = time_ms(lambda: Q.int8_conv3d_cuda(xq, wq, scale, *args,
                                            torch.bfloat16))
    plain_ms = time_ms(lambda: Q.int8_conv3d_plain(xq, wq, scale, *args,
                                                   torch.bfloat16),
                       iters=1, warmup=1)
    xb = torch.randn((batch, t, h, w, cin), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    if lo != hi:
        xb = F.pad(xb, (0, 0, lo[2], hi[2], lo[1], hi[1], lo[0], hi[0]))
    wb = torch.randn((cout, cin, *k), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    pad = (0, 0, 0) if lo != hi else lo
    cudnn_ms = time_ms(lambda: F.conv3d(xb.permute(0, 4, 1, 2, 3), wb,
                                        stride=stride, padding=pad))
    shape = Q.out_shape(xq.shape, wq.shape, stride, lo, hi)
    m = shape[0] * shape[1] * shape[2] * shape[3]
    ops = 2.0 * m * cout * cin * k[0] * k[1] * k[2]
    read = batch * cin * math.prod(
        _read_extent(*a) for a in zip((t, h, w), shape[1:4], k, stride, lo))
    nbytes = read + wq.numel() + 2 * m * cout + 4 * cout
    bound, by = bound_ms(ops, nbytes, PEAK_INT8)
    r = dict(ms=ms, plain_ms=plain_ms, cudnn_ms=cudnn_ms, bound=bound, by=by,
             err=err, bitwise=bitwise, hash=digest, tops=ops / ms / 1e9)
    if k == (1, 1, 1) and stride == (1, 1, 1):
        # the same s8 product through PyTorch's int8 matmul (cuBLAS): the
        # library call of the same function, timed only
        a = xq.reshape(-1, cin)
        b = wq.reshape(cout, cin).t()
        got = torch._int_mm(a, b)
        k6 = Q.int8_conv3d_cuda(xq, wq, scale, *args, torch.int32)
        r["int_mm_equal"] = torch.equal(got, k6.reshape(-1, cout))
        r["library_ms"] = time_ms(lambda: torch._int_mm(a, b))
        del got, k6
    del xq, wq, xb, wb
    torch.cuda.empty_cache()
    return r


def _k6_sites(dev):
    """Phase 19 (a): K6 at every distinct conv shape of the int8_static
    eval forward and at the two I3D sites; returns (the per-step sums over
    the eval forward's 24 launches, the I3D 1x1x1 site's record)."""
    gen = torch.Generator(device=dev).manual_seed(19)
    sites = _int8_sites(dev)
    total = dict(ms=0.0, plain_ms=0.0, cudnn_ms=0.0, bound=0.0, launches=0)
    ok = True
    for key, names in sites.items():
        r = _k6_site(dev, gen, key)
        n = len(names)
        for f in ("ms", "plain_ms", "cudnn_ms", "bound"):
            total[f] += n * r[f]
        total["launches"] += n
        ok &= r["bitwise"]
        (t, h, w, cin), cout, k, stride, lo, hi = key
        log(f"[quant] K6 {names[0]}{f' (+{n - 1})' if n > 1 else ''}: x "
            f"({Q_EVAL_BS}, {t}, {h}, {w}, {cin}) -> {cout}, kernel {k}, "
            f"stride {stride}, pads {lo}/{hi}: int32 and bf16 vs plain at "
            f"batch {Q_CHECK_BS} {'bitwise' if r['bitwise'] else 'DIFFER'} "
            f"(hash {r['hash']}); at batch {Q_EVAL_BS}: K6 {r['ms']:.3f} ms "
            f"({r['tops']:.1f} TOPS), bound {r['bound']:.3f} ms "
            f"({r['by']}), plain (float64) {r['plain_ms']:.1f} ms, cuDNN bf16 "
            f"conv3d {r['cudnn_ms']:.3f} ms (another precision)")
    i3d = None
    for name, shape, cout, k, stride, lo, hi in Q_I3D_SITES:
        r = _k6_site(dev, gen, (shape, cout, k, stride, lo, hi))
        ok &= r["bitwise"] and r.get("int_mm_equal", True)
        extra = ""
        if "library_ms" in r:
            i3d = r
            extra = (f"; torch._int_mm on the same s8 matrices "
                     f"{r['library_ms']:.3f} ms, its int32 result "
                     f"{'equal' if r['int_mm_equal'] else 'DIFFERENT'}")
        log(f"[quant] K6 {name}: x ({Q_EVAL_BS}, {', '.join(map(str, shape))})"
            f" -> {cout}, kernel {k}, stride {stride}, pads {lo}/{hi}: vs "
            f"plain {'bitwise' if r['bitwise'] else 'DIFFER'} (hash "
            f"{r['hash']}); K6 {r['ms']:.3f} ms ({r['tops']:.1f} TOPS), "
            f"bound {r['bound']:.3f} ms ({r['by']}), plain {r['plain_ms']:.1f}"
            f" ms, cuDNN bf16 {r['cudnn_ms']:.3f} ms{extra}")
    log(f"[quant] K6 per int8_static eval forward at batch {Q_EVAL_BS} "
        f"({total['launches']} launches, {len(sites)} shapes): K6 "
        f"{total['ms']:.2f} ms, bound {total['bound']:.2f} ms, plain "
        f"(float64) {total['plain_ms']:.1f} ms, cuDNN bf16 convs "
        f"{total['cudnn_ms']:.2f} ms")
    if not ok or i3d is None or total["launches"] != 24:
        raise SystemExit("[quant] K6 differs from its plain version (or "
                         "_int_mm from K6), or the eval forward did not "
                         "have 24 int8 sites")
    return total, i3d


def _float_ft_checkpoint(dev, path: str, **over):
    """A float finetune checkpoint of the phase's model (or the model of
    the config flags ``over``): 2 finetune steps (bf16, batch B_FT) from
    seed 0, so the BN running statistics are off their init."""
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.train import finetune as ft

    cfg = _ft_config(fused=0, **over)
    model, state, tx = ft.create_finetune_state(cfg, N_FT_CLASSES, seed=0,
                                                device=dev)
    step = ft.make_finetune_step(model, tx, cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    for i in range(2):
        state, _ = step(state, gen, _ft_batch(dev, seed=30 + i), 0.01)
    ckpt_lib.save_checkpoint(path, ckpt_lib.state_tree(state),
                             meta={"arch": cfg.arch, "epoch": 2})
    del model, state, tx, step
    torch.cuda.empty_cache()


def _test_windows(test_path: str, n_videos: int):
    """The sliding windows of the first ``n_videos`` test videos (numpy)."""
    import numpy as np

    from cstp_tpu_torch.data.packed import PackedDataset
    from cstp_tpu_torch.train.finetune import sliding_window_indices

    ds = PackedDataset(test_path)
    out = []
    for i in range(n_videos):
        nframes, _ = ds.video_meta(i)
        for idx in sliding_window_indices(nframes, T, 1):
            out.append(ds.read_frames(i, idx))
    video = ds.read_frames(0, range(ds.video_meta(0)[0]))
    return np.stack(out), video


def _live_logits(dev, quant: str, ckpt: str, windows, backbone=False,
                 fill=None):
    """``make_logits_step`` of the model restored from ``ckpt`` (by name,
    as run_test restores) on ``windows``, with ``backbone`` also the
    backbone's output map before its pooling (``online_net.conv5``'s, N x
    2 x 7 x 7 x 512); float32 on the host. ``fill``: every ``act_scale``
    set to this value after the restore."""
    from cstp_tpu_torch.perf.bench_step import fill_act_scales
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.train import finetune as ft

    cfg = _quant_config(quant)
    model, state, _ = ft.create_finetune_state(cfg, N_FT_CLASSES, seed=0,
                                               device=dev)
    tree, _ = ckpt_lib.restore_checkpoint(ckpt)
    ckpt_lib.load_model_by_name(model, tree)
    if fill is not None:
        fill_act_scales(model, fill)
    x = torch.from_numpy(windows).to(dev)
    seen = []
    hook = model.online_net.conv5.register_forward_hook(
        lambda m, args, y: seen.append(y.float().cpu()))
    out = ft.make_logits_step(model, cfg)(state, x).float().cpu()
    hook.remove()
    del model, state
    return (out, seen[0]) if backbone else out


def serve_check(data: str, out: str, *arts: str) -> None:
    """Phase 19 (c) in a fresh process: for each artifact,
    ``ServingModel.load`` on the card, ``predict`` at each of
    Q_SERVE_BATCHES windows and ``predict_video`` on one video; writes the
    logits, the prediction, the load seconds and K6's launches to
    ``out.<i>.npz``."""
    import numpy as np

    from cstp_tpu_torch.ops import launch_counts, reset_launch_counts
    from cstp_tpu_torch.serve import ServingModel

    arrays = np.load(data)
    for i, art in enumerate(arts):
        t0 = time.perf_counter()
        served = ServingModel.load(art)
        load_s = time.perf_counter() - t0
        reset_launch_counts()
        logits = [served.predict(arrays["windows"][:n])
                  for n in Q_SERVE_BATCHES]
        video = served.predict_video(arrays["video"], topk=5)
        torch.cuda.synchronize()
        np.savez(f"{out}.{i}.npz",
                 **{f"logits{n}": v for n, v in zip(Q_SERVE_BATCHES, logits)},
                 mean_logits=video["mean_logits"], top1=video["top1"],
                 n_windows=video["n_windows"], load_s=load_s,
                 k6=launch_counts()["int8_conv"], device=served.device.type)


def _serve_in_subprocess(data: str, out: str, arts):
    """``serve_check`` in a fresh process (this script with
    ``--serve-check``): ``([result per artifact], seconds)``."""
    import os

    import numpy as np

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, __file__, "--serve-check", data,
                           out, *arts], env=env, capture_output=True,
                          text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        for line in (done.stdout + done.stderr).splitlines()[-20:]:
            log(f"[quant]   serve-check: {line}")
        raise SystemExit(f"[quant] the serving subprocess exited "
                         f"{done.returncode}")
    return [dict(np.load(f"{out}.{i}.npz")) for i in range(len(arts))], \
        seconds


def _quant_cli(dev, root: str, counts):
    """Phase 19 (b) and (c): calibration, the int8_static test run, the
    refused uncalibrated run, the two exports and the fresh-process
    serving check. Adds the main-path launches to ``counts``; returns the
    artifacts' paths by ``--quant``."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from cstp_tpu_torch.cli import main_test
    from cstp_tpu_torch.serve import export as serve_export
    from cstp_tpu_torch.serve import quantize as serve_quantize
    from cstp_tpu_torch.train.finetune import sliding_window_indices

    train = os.path.join(root, "train.cstp")
    test = os.path.join(root, "test.cstp")
    first_test = CLI_TRAIN + CLI_EVAL     # phase 12's test videos
    with ThreadPoolExecutor(8) as pool:
        _pack_videos(train, _cli_videos(), range(Q_CALIB_VIDEOS), pool)
        _pack_videos(test, _cli_videos(),
                     range(first_test, first_test + Q_TEST_VIDEOS), pool)
    float_ckpt = os.path.join(root, "save_2_max")
    calib = os.path.join(root, "save_2_int8")
    _float_ft_checkpoint(dev, float_ckpt)
    common = ["--model_name", "r21d", "--model_depth", "1",
              "--sample_duration", str(T), "--sample_size", str(S),
              "--compute_dtype", "bfloat16", "--n_classes",
              str(N_FT_CLASSES), "--n_finetune_classes", str(N_FT_CLASSES),
              "--data_backend", "packed", "--lmdb_path", train,
              "--dataset", "UCF101", "--n_workers", "6", "--result_path",
              os.path.join(root, "results"), "--task", "test"]

    t0 = time.perf_counter()
    _, text = _cli_run(serve_quantize.main, common + [
        "--out_path", calib, "--test_md_path", float_ckpt,
        "--calib_batches", "2", "--calib_batch_size", "8"], {}, 1)
    calib_s = time.perf_counter() - t0
    if not text.startswith("calibrated 24 conv sites over 16 clips"):
        raise SystemExit("[quant] serve.quantize did not calibrate 24 sites")
    log(f"[quant] (b) serve.quantize: {text.splitlines()[0]} "
        f"({calib_s:.1f} s)")

    t0 = time.perf_counter()
    out, text = _cli_run(main_test.main, common + [
        "--quant", "int8_static", "--test_md_path", calib],
        {"int8_conv": 24}, Q_TEST_VIDEOS)
    counts["int8_conv"] += 24 * Q_TEST_VIDEOS
    log(f"[quant] (b) main_test --quant int8_static on {out['n_videos']} "
        f"videos: accuracy {out['accuracy']:.4f}, {24} K6 launches per "
        f"video, {time.perf_counter() - t0:.1f} s")
    windows, video = _test_windows(test, 2)
    live, maps = {}, {}
    for q, ck in (("", float_ckpt), ("int8_static", calib)):
        live[q], maps[q] = _live_logits(dev, q, ck, windows, backbone=True)
    # a wrong int8 path for the gate to tell apart: the calibrated model
    # with every scale at bench_step's fill (0.05, far above the measured
    # ones)
    maps["control"] = _live_logits(dev, "int8_static", calib, windows,
                                   backbone=True, fill=0.05)[1]

    def cosine(d, q="int8_static", centre=False):
        a, b = d[""], d[q]
        if centre:   # each channel's deviation from its mean
            a = a - a.flatten(0, -2).mean(0)
            b = b - b.flatten(0, -2).mean(0)
        return float(torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0))

    cos = cosine(maps, centre=True)
    cos_control = cosine(maps, "control", centre=True)
    log(f"[quant] (b) int8_static vs float on {len(windows)} windows of 2 "
        f"test videos: logits cosine {cosine(live):.5f}, max |diff| "
        f"{float((live[''] - live['int8_static']).abs().max()):.4f} (float "
        f"logits up to {float(live[''].abs().max()):.4f}, the head's "
        f"bias); backbone output map cosine {cosine(maps):.5f}, each "
        f"channel centred {cos:.5f} (tol {Q_BACKBONE_COS}); the control "
        f"(every act_scale 0.05): {cosine(maps, 'control'):.5f}, centred "
        f"{cos_control:.5f} (must be below the tol)")
    try:
        _cli_run(main_test.main, common + [
            "--quant", "int8_static", "--test_md_path", float_ckpt])
    except ValueError as e:
        if "uncalibrated" not in str(e):
            raise
        log(f"[quant] (b) main_test --quant int8_static on the float "
            f"checkpoint refused: {str(e).splitlines()[0]}")
    else:
        raise SystemExit("[quant] an uncalibrated int8_static test ran")
    if not cos >= Q_BACKBONE_COS > cos_control:
        raise SystemExit("[quant] int8_static backbone output far from the "
                         "float model's, or the wrong-scale control near it")

    data = os.path.join(root, "windows.npz")
    np.savez(data, windows=windows[:max(Q_SERVE_BATCHES)], video=video)
    runs = (("", float_ckpt), ("int8_static", calib))
    arts, export_s = [], []
    for quant, ckpt in runs:
        arts.append(os.path.join(root, f"model{quant}.cstps"))
        t0 = time.perf_counter()
        _cli_run(serve_export.main, [
            "--ckpt", ckpt, "--out", arts[-1], "--model_name", "r21d",
            "--model_depth", "1", "--num_classes", str(N_FT_CLASSES),
            "--sample_size", str(S), "--sample_duration", str(T),
            "--input_hw", *map(str, windows.shape[2:4]), "--compute_dtype",
            "bfloat16", "--quant", quant], {}, 1)
        export_s.append(time.perf_counter() - t0)
    served, seconds = _serve_in_subprocess(
        data, os.path.join(root, "served"), arts)
    log(f"[quant] (c) both artifacts served by one fresh process: "
        f"{seconds:.1f} s with its start")
    for (quant, ckpt), art, ex_s, got in zip(runs, arts, export_s, served):
        ref = live[quant]
        diffs = [float((torch.from_numpy(got[f"logits{n}"]) - ref[:n]
                        ).abs().max()) for n in Q_SERVE_BATCHES]
        live_top1 = int(_live_logits(
            dev, quant, ckpt, video[sliding_window_indices(len(video), T, 1)]
        ).mean(0).argmax())
        scale = float(ref.abs().max())
        log(f"[quant] (c) serve.export {quant or 'float'}: "
            f"{os.path.getsize(art) / 1e6:.1f} MB in {ex_s:.1f} s; the "
            f"fresh process (load {float(got['load_s']):.1f} s, on "
            f"{got['device']}) predicts {list(Q_SERVE_BATCHES)} "
            f"windows: max |diff| to the live logits step "
            f"{', '.join(f'{d:.3e}' for d in diffs)} (logits up to "
            f"{scale:.3f}); predict_video top-1 {int(got['top1'])} over "
            f"{int(got['n_windows'])} windows, live {live_top1}; K6 launches "
            f"{int(got['k6'])}")
        want_k6 = (24 * (len(Q_SERVE_BATCHES) + 1)) if quant else 0
        if (max(diffs) > 1e-2 * max(scale, 1e-3)
                or int(got["top1"]) != live_top1
                or int(got["k6"]) != want_k6):
            raise SystemExit("[quant] the served program differs from the "
                             "live logits step")
    return {quant: art for (quant, _), art in zip(runs, arts)}


def _quant_bench(dev, arts):
    """Phase 19 (d): bench_step --mode eval and serve, float and
    --quant int8_static, at per-chip batch Q_EVAL_BS, 2 steps after 1; the
    serve runs time (c)'s artifacts ``arts`` (``--artifact``: the export
    path is (c)'s, and the time does not depend on the weights or the
    scales)."""
    from cstp_tpu_torch.perf import bench_step

    out = {}
    for mode in ("eval", "serve"):
        for quant in ("", "int8_static"):
            art = ["--artifact", arts[quant]] if mode == "serve" else []
            r = bench_step.main(["--mode", mode, "--quant", quant,
                                 "--per-chip-bs", str(Q_EVAL_BS),
                                 "--steps", "2", "--warmup", "1", *art])
            k6 = r["launches_per_step"]["int8_conv"]
            extra = (f", (c)'s artifact {r['artifact_mb']:.1f} MB loaded in "
                     f"{r['load_s']:.1f} s" if mode == "serve" else "")
            log(f"[quant] (d) bench_step --mode {mode} "
                f"{'--quant int8_static ' if quant else ''}at {Q_EVAL_BS}: "
                f"{r['step_ms']:.2f} ms/step, {r['clips_per_s']:.1f} clips/s, "
                f"peak {r['peak_mem_gib']:.2f} GiB, K6 launches per step "
                f"{k6:g}{extra}")
            if k6 != (24 if quant else 0) or not math.isfinite(r["loss"]):
                raise SystemExit(f"[quant] bench_step {mode} {quant}: K6 "
                                 f"{k6} per step or a non-finite loss")
            out[(mode, quant)] = r
            torch.cuda.empty_cache()
    return out


def _quant_profile(dev):
    """Phase 19 (d): one eval step at batch B_FT under torch.profiler,
    float and int8_static (act scales 0.05): the device's busy share, its
    time by kernel and K6's share, beside the float step's convolutions."""
    from cstp_tpu_torch.perf.bench_step import fill_act_scales
    from cstp_tpu_torch.train import finetune as ft

    batch = _ft_batch(dev, seed=19)
    for quant in ("", "int8_static"):
        cfg = _quant_config(quant)
        model, state, _ = ft.create_finetune_state(cfg, N_FT_CLASSES, seed=0,
                                                   device=dev)
        fill_act_scales(model)
        step = ft.make_eval_step(model, cfg)
        step(state, batch)                                    # warm-up
        log(f"[quant] (d) one eval step at {B_FT}, {quant or 'float'}, "
            "under torch.profiler:")
        prof = profile_step(lambda: step(state, batch), top=8)
        if prof:
            k6 = sum(v for k, v in prof["ms_by_kernel"].items()
                     if "int8_conv_kernel" in k)
            log(f"[quant] (d) {quant or 'float'}: K6 {k6:.2f} ms of "
                f"{prof['busy_ms']:.2f} ms busy")
        del model, state, step
        torch.cuda.empty_cache()


def _quant_pretrain(dev, card: str, slice_ms: float, counts):
    """Phase 19 (e): the --quant int8 pretrain step at per-view B_VIEW
    (fused_conv 0, K5 on) with K6 against the same step with the plain
    int8 conv (float64) in its place: loss terms equal, update cosine >=
    0.9999; then --quant_scope target."""
    from cstp_tpu_torch.ops import quant as Q

    batch = _slice_batch(dev, seed=4)
    cfg = _slice_config(False, quant="int8", pallas_augment="on")
    k6 = _one_step_run(dev, cfg, batch)
    real = Q.int8_conv3d_cuda
    Q.int8_conv3d_cuda = Q.int8_conv3d_plain
    try:
        plain = _one_step_run(dev, cfg, batch, timed_steps=1)
    finally:
        Q.int8_conv3d_cuda = real
    target = _one_step_run(dev, _slice_config(
        False, quant="int8", quant_scope="target", pallas_augment="on"),
        batch)
    same = all(k6["metrics"][k] == plain["metrics"][k]
               for k in k6["metrics"] if k.startswith("loss"))
    cos = _cos(k6, plain)
    log(f"[quant] (e) --quant int8 pretrain step, per-view {B_VIEW}, "
        f"fused_conv 0, K5 on: K6 vs the plain int8 conv: loss terms "
        f"{'equal' if same else 'DIFFER'} (loss {k6['metrics']['loss']:.5f}"
        f" vs {plain['metrics']['loss']:.5f}), update cosine {cos:.6f} (tol "
        f"0.9999); step ms: K6 {k6['ms']:.1f}, plain int8 conv "
        f"{plain['ms']:.1f}, phase 3's kernel step {slice_ms:.1f} ({card}); "
        f"launches {k6['counts']}")
    log(f"[quant] (e) --quant_scope target: loss "
        f"{target['metrics']['loss']:.5f}, {target['ms']:.1f} ms/step, "
        f"launches {target['counts']}")
    if (not same or cos < 0.9999 or k6["counts"] != _per_step(0, 0, 1, 48)
            or plain["counts"] != _per_step(0, 0, 1, 0)
            or target["counts"] != _per_step(0, 0, 1, 24)):
        raise SystemExit("[quant] the int8 pretrain step with K6 differs "
                         "from the plain int8 conv's, or launched other "
                         "than 1 K5 and 48 (24 for scope target) K6")
    for run in (k6, target):
        for k, v in run["counts"].items():
            counts[k] += v
    return dict(k6_ms=k6["ms"], plain_ms=plain["ms"], target_ms=target["ms"])


def phase_quant_serve(dev, card: str, slice_ms: float):
    """Phase 19: int8 quantization and serving (R(2+1)D depth 1, 16 x
    112^2 from 128x171 frames, bf16): (a) K6 at every conv shape of the
    int8_static eval forward and two I3D sites; (b) serve.quantize ->
    main_test --quant int8_static, and the uncalibrated run refused; (c)
    serve.export of the float and calibrated checkpoints served from a
    fresh process; (d) bench_step eval, and serve on (c)'s artifacts,
    float and int8_static;
    (e) the --quant int8 pretrain step. Returns the K6 record for the
    kernels line and the main-path launches."""
    import tempfile

    t_phase = time.perf_counter()
    counts = {k: 0 for k in _per_step(0, 0, 0)}
    total, i3d = _k6_sites(dev)
    with tempfile.TemporaryDirectory(prefix="cstp_quant_") as root:
        arts = _quant_cli(dev, root, counts)
        torch.cuda.empty_cache()
        bench = _quant_bench(dev, arts)
    _quant_profile(dev)
    pre = _quant_pretrain(dev, card, slice_ms, counts)
    log(f"[quant] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(total=total, i3d=i3d, bench=bench,
                int8_step_ms=pre["k6_ms"]), counts


# ------------------------------------------------------------ storage chain

STORE_QUANTS = ("int8_store", "int8_store_fz")
# the storage chain's launches per pretrain step, both towers (12 sites
# each): K5, dequantizing K6, K6 with the storage epilogue, K7
STORE_PER_STEP = _per_step(0, 0, 1, 24, 24, 24)
STORE_CLI_STEPS = 3     # steps of phase 20 (d)'s main_byol epoch
# the chain's own plain step at per-view 64 does not exist; these are the
# references phase 13 measures in the same run
STORE_BENCH_REF = ("--fused-conv 0 --remat", "--fused-conv 0 --remat-policy "
                   "bnrelu")


def _store_site(dev, gen, site):
    """Phase 20 (a) at one chain site at per-view B_VIEW (2 B_VIEW clips a
    tower call): K6 with the storage epilogue and K7 on its mid against
    their plain versions (bitwise), their ms, the plain versions' ms (K6's:
    the float64 conv) and the bounds: K6's int8 operations at 1,979 TOPS
    against the bytes it must move (the input positions its taps read,
    the weights, the s8 mid, the int64 sums, the scales), K7's f32
    operations (8 an element) at 67 TFLOP/s against one s8 read and one s8
    write an element and its (N, M) operands."""
    from cstp_tpu_torch.models.layers import r21d_intermediate_channels
    from cstp_tpu_torch.ops import quant as Q

    _, shape, cout, k, stride, pad = site
    n, t, h, w, cin = shape
    m = r21d_intermediate_channels(cin, cout, k)
    xq = torch.randint(-127, 128, shape, generator=gen, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (m, cin, 1, k[1], k[2]), generator=gen,
                       device=dev, dtype=torch.int8)
    scale = torch.rand(m, generator=gen, device=dev) * 1e-3 + 1e-5
    geo = ([1, stride[1], stride[2]], [0, pad[1], pad[2]],
           [0, pad[1], pad[2]])
    one = torch.ones((), device=dev)
    # a mid scale that clips every value above half the absmax
    s_mid = (Q.int8_conv3d_store_cuda(xq, wq, scale, one, *geo)[3]
             / 254.0).reshape(())

    def k6():
        return Q.int8_conv3d_store_cuda(xq, wq, scale, s_mid, *geo)

    def k6_plain():
        return Q.int8_conv3d_store_plain(xq, wq, scale, s_mid, *geo)

    got, want = k6(), k6_plain()
    torch.cuda.synchronize()
    ok6 = all(torch.equal(a, b) for a, b in zip(got, want))
    err6 = max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, want))
    hq = got[0]
    del got, want
    ms6 = time_ms(k6)
    plain6 = time_ms(k6_plain, iters=1, warmup=0)
    rows = math.prod(hq.shape[:4])
    kk = k[1] * k[2] * cin
    read = n * t * cin * math.prod(
        _read_extent(*a) for a in zip((h, w), hq.shape[2:4], k[1:],
                                      stride[1:], pad[1:]))
    bound6, by6 = bound_ms(2.0 * rows * m * kk,
                           read + wq.numel() + hq.numel() + 16 * n * m
                           + 4 * m + 4, PEAK_INT8)
    del xq
    torch.cuda.empty_cache()
    mean = torch.randn((n, m), generator=gen, device=dev) * 0.1
    inv = torch.rand((n, m), generator=gen, device=dev) * 1.5 + 0.5
    gamma = torch.randn(m, generator=gen, device=dev) * 0.2 + 1.0
    beta = torch.randn(m, generator=gen, device=dev) * 0.2
    s_act = torch.full((), 0.011, device=dev)
    args = (hq, s_mid, mean, inv, gamma, beta, s_act)
    got = Q.bn_relu_requant_cuda(*args)
    want = Q.bn_relu_requant_plain(*args)
    torch.cuda.synchronize()
    ok7 = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    err7 = max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, want))
    del got, want
    ms7 = time_ms(lambda: Q.bn_relu_requant_cuda(*args))
    plain7 = time_ms(lambda: Q.bn_relu_requant_plain(*args), iters=3,
                     warmup=1)
    bound7, by7 = bound_ms(8.0 * hq.numel(), 2 * hq.numel() + 8 * n * m
                           + 8 * m + 8, PEAK_F32)
    mid = tuple(hq.shape)
    del hq, wq, args
    torch.cuda.empty_cache()
    return dict(mid=mid, store=dict(ms=ms6, plain_ms=plain6, bound=bound6,
                                    by=by6, err=err6, ok=ok6,
                                    tops=2.0 * rows * m * kk / ms6 / 1e9),
                k7=dict(ms=ms7, plain_ms=plain7, bound=bound7, by=by7,
                        err=err7, ok=ok7))


def _store_sites(dev):
    """Phase 20 (a): K6's storage epilogue and K7 at the 12 chain sites of
    an R(2+1)D depth 1 tower at per-view B_VIEW (2 B_VIEW clips of T x
    S^2); returns each kernel's per-pretrain-step sums (24 launches: 12
    sites x 2 towers) for the kernels line."""
    from cstp_tpu_torch.models.r21d import chain_sites

    gen = torch.Generator(device=dev).manual_seed(20)
    total = {k: dict(ms=0.0, plain_ms=0.0, bound=0.0, err=0.0, ok=True,
                     by_ms={"bytes": 0.0, "operations": 0.0})
             for k in ("store", "k7")}
    for site in chain_sites(2 * B_VIEW, T, S):
        r = _store_site(dev, gen, site)
        for k in ("store", "k7"):
            for f in ("ms", "plain_ms", "bound"):
                total[k][f] += TOWERS * r[k][f]
            total[k]["by_ms"][r[k]["by"]] += r[k]["bound"]
            total[k]["err"] = max(total[k]["err"], r[k]["err"])
            total[k]["ok"] &= r[k]["ok"]
        st, k7 = r["store"], r["k7"]
        log(f"[store] {site[0]}: x {site[1]} -> mid {r['mid']}: K6 storage "
            f"epilogue vs plain {'bitwise' if st['ok'] else 'DIFFER'}; "
            f"{st['ms']:.3f} ms "
            f"({st['tops']:.1f} TOPS), bound {st['bound']:.3f} ms "
            f"({st['by']}), plain (float64) {st['plain_ms']:.1f} ms | K7 vs "
            f"plain {'bitwise' if k7['ok'] else 'DIFFER'}; {k7['ms']:.3f} "
            f"ms, bound {k7['bound']:.3f} ms ({k7['by']}), plain "
            f"{k7['plain_ms']:.2f} ms")
    for k, name in (("store", "K6 storage epilogue"), ("k7", "K7")):
        r = total[k]
        # the bound that sets most of the summed bound
        r["by"] = max(r["by_ms"], key=r["by_ms"].get)
        log(f"[store] {name} per pretrain step (24 launches): "
            f"{r['ms']:.2f} ms, bound {r['bound']:.2f} ms (mostly "
            f"{r['by']}), plain "
            f"{r['plain_ms']:.1f} ms, max |kernel - plain| {r['err']}")
    if not (total["store"]["ok"] and total["k7"]["ok"]):
        raise SystemExit("[store] the storage epilogue or K7 differs from "
                         "its plain version")
    return total


@contextlib.contextmanager
def _plain_chain():
    """The chain's plain versions in the kernels' place (K6 both kinds,
    K7); no launch is counted inside."""
    from cstp_tpu_torch.ops import quant as Q

    real = (Q.int8_conv3d_cuda, Q.int8_conv3d_store_cuda,
            Q.bn_relu_requant_cuda)
    Q.int8_conv3d_cuda = Q.int8_conv3d_plain
    Q.int8_conv3d_store_cuda = Q.int8_conv3d_store_plain
    Q.bn_relu_requant_cuda = Q.bn_relu_requant_plain
    try:
        yield
    finally:
        (Q.int8_conv3d_cuda, Q.int8_conv3d_store_cuda,
         Q.bn_relu_requant_cuda) = real


def _store_steps(dev, card: str, slice_ms: float, int8_ms: float, counts):
    """Phase 20 (b): the int8_store and int8_store_fz pretrain steps at
    per-view B_VIEW with K5 (the first step bootstraps the scales), against
    the same steps with the chain's plain versions on the card: loss terms
    equal, update cosine >= 0.999, all 72 scales positive, launches per
    step STORE_PER_STEP; then each one's ms over 2 steps and peak GiB."""
    batch = _slice_batch(dev, seed=4)
    for quant in STORE_QUANTS:
        cfg = _slice_config(False, quant=quant, pallas_augment="on")
        k = _one_step_run(dev, cfg, batch)
        with _plain_chain():
            p = _one_step_run(dev, cfg, batch, timed_steps=1)
        same = all(k["metrics"][n] == p["metrics"][n]
                   for n in k["metrics"] if n.startswith("loss"))
        cos = _cos(k, p)
        scales = [v for n, v in k["stats"].items() if "act_scale" in n]
        pos = len(scales) == 72 and all(float(v) > 0 for v in scales)
        log(f"[store] (b) --quant {quant} pretrain step, per-view {B_VIEW}, "
            f"K5 on: kernels vs the chain's plain versions: loss terms "
            f"{'equal' if same else 'DIFFER'} (loss "
            f"{k['metrics']['loss']:.5f} vs {p['metrics']['loss']:.5f}), "
            f"update cosine {cos:.6f} (tol 0.999); {len(scales)} scales "
            f"after the bootstrap and step, all > 0: {pos}; step ms: kernels "
            f"{k['ms']:.1f}, plain chain {p['ms']:.1f}, phase 3's kernel "
            f"step {slice_ms:.1f}, phase 19's --quant int8 step "
            f"{int8_ms:.1f} ({card}); peak {k['peak_gib']:.2f} GiB; "
            f"launches {k['counts']}")
        if (not same or cos < 0.999 or not pos
                or k["counts"] != STORE_PER_STEP
                or p["counts"] != _per_step(0, 0, 1)):
            raise SystemExit(f"[store] the {quant} step with the kernels "
                             "differs from its plain chain's, left a scale "
                             "at 0, or launched other than "
                             f"{STORE_PER_STEP}")
        for n, v in k["counts"].items():
            counts[n] += v
    _store_profile(dev, batch)


def _store_profile(dev, batch):
    """Phase 20 (b): one int8_store step at per-view B_VIEW under
    torch.profiler (after the bootstrap and a warm-up step): the device's
    busy share and its time by kernel."""
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    cfg = _slice_config(False, quant="int8_store", pallas_augment="on")
    model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
    step = make_pretrain_step(model, tx, cfg)
    gen = torch.Generator(device=dev).manual_seed(5)
    for _ in range(2):
        state, _ = step(state, gen, batch, cfg.learning_rate)
    log("[store] (b) one --quant int8_store step under torch.profiler:")
    profile_step(lambda: step(state, gen, batch, cfg.learning_rate), top=16)
    del model, state, tx, step
    torch.cuda.empty_cache()


def _store_bench(flag_benches):
    """Phase 20 (c): bench_step --mode pretrain --quant int8_store (and
    int8_store_fz) at per-view BENCH_STEP_BS with K5, beside phase 13's
    plain remat steps (the plain step without remat does not fit). Both
    chain steps must fit, without remat, in less memory than phase 13's
    plain ``--remat`` step: the chain's reason to exist. An out-of-memory
    error propagates."""
    from cstp_tpu_torch.perf import bench_step

    for flags in STORE_BENCH_REF:
        r = flag_benches.get(flags)
        log(f"[store] (c) reference, phase 13's bench_step {flags}: "
            + (f"{r['step_ms']:.1f} ms/step, peak {r['peak_mem_gib']:.2f} "
               "GiB" if r else "not measured (out of memory)"))
    # phase 13 holds this run to fit (FLAG_BENCH_RUNS)
    remat_gib = flag_benches[STORE_BENCH_REF[0]]["peak_mem_gib"]
    out = {}
    for quant in STORE_QUANTS:
        r = bench_step.main(["--mode", "pretrain", "--steps", "2",
                             "--warmup", "1", "--pallas-augment", "on",
                             "--quant", quant])
        gc.collect()
        torch.cuda.empty_cache()
        got = {k: v for k, v in r["launches_per_step"].items() if v}
        log(f"[store] (c) bench_step --mode pretrain --quant {quant} at "
            f"per-view {BENCH_STEP_BS}, K5 on: {r['step_ms']:.1f} ms/step, "
            f"{r['pairs_per_s']:.1f} pairs/s, peak {r['peak_mem_gib']:.2f} "
            f"GiB (the plain --remat step's {remat_gib:.2f}), launches per "
            f"step {got}")
        want = {k: v for k, v in STORE_PER_STEP.items() if v}
        if got != want or not math.isfinite(r["loss"]):
            raise SystemExit(f"[store] bench_step --quant {quant} launched "
                             f"{got} (expected {want}) or lost its loss")
        if not r["peak_mem_gib"] < remat_gib:
            raise SystemExit(f"[store] bench_step --quant {quant} peaked at "
                             f"{r['peak_mem_gib']:.2f} GiB, not below the "
                             f"plain --remat step's {remat_gib:.2f}")
        out[quant] = r
    return out


def _store_cli(dev, card: str, counts):
    """Phase 20 (d): one ``main_byol --quant int8_store`` epoch of
    STORE_CLI_STEPS steps at per-view B_VIEW with K5 on phase 12's CSTPack
    data (its first videos, written here): STORE_PER_STEP launches a step
    (the first step's bootstrap launches none), finite CSV rows, the
    loop's step ms."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from cstp_tpu_torch.cli import main_byol

    with tempfile.TemporaryDirectory(prefix="cstp_store_cli_") as root:
        train = os.path.join(root, "train.cstp")
        with ThreadPoolExecutor(8) as pool:
            _pack_videos(train, _cli_videos(),
                         range(STORE_CLI_STEPS * B_VIEW), pool)
        res = os.path.join(root, "results")
        out, _ = _cli_run(main_byol.main, [
            "--model_name", "r21d_byol", "--model_depth", "1",
            "--sample_duration", str(T), "--sample_size", str(S),
            "--compute_dtype", "bfloat16", "--quant", "int8_store",
            "--pallas_augment", "on", "--task", "loss_com", "--batch_size",
            str(B_VIEW), "--n_epochs", "1", "--steps_per_epoch",
            str(STORE_CLI_STEPS), "--log_every", "1", "--n_workers", "6",
            "--data_backend", "packed", "--lmdb_path", train, "--dataset",
            "UCF101", "--result_path", res], STORE_PER_STEP,
            STORE_CLI_STEPS)
        rows = _check_rows(os.path.join(
            res, "UCF101", "loss_com",
            f"UCF101_train_clip{T}modelr21d_byol1.log"))
    t = _loop_times(out, B_VIEW)
    log(f"[store] (d) main_byol --quant int8_store, 1 epoch of "
        f"{STORE_CLI_STEPS} steps at per-view {B_VIEW} on "
        f"{STORE_CLI_STEPS * B_VIEW} videos of phase 12's CSTPack data: "
        f"{rows} finite CSV row(s), loop step {t['step_ms']:.1f} ms, data "
        f"wait {t['wait_ms']:.1f} ms ({card})")
    for k, v in STORE_PER_STEP.items():
        counts[k] += v * STORE_CLI_STEPS


def phase_store_chain(dev, card: str, slice_ms: float, int8_ms: float,
                      flag_benches):
    """Phase 20: the s8 storage chain (``--quant int8_store`` /
    ``int8_store_fz``; R(2+1)D depth 1, 16 x 112^2, bf16): (a) K6's
    storage epilogue and K7 at the 12 chain sites, (b) the pretrain steps
    against the chain's plain versions, (c) bench_step at per-view 64,
    (d) one main_byol epoch. Returns the kernels' per-step records and the
    main-path launches."""
    t_phase = time.perf_counter()
    counts = {k: 0 for k in _per_step(0, 0, 0)}
    total = _store_sites(dev)
    _store_steps(dev, card, slice_ms, int8_ms, counts)
    _store_bench(flag_benches)
    _store_cli(dev, card, counts)
    log(f"[store] phase {time.perf_counter() - t_phase:.1f} s")
    return total, counts


# ------------------------------------------------------- the 'model' axis

MA_B_VIEW = 8           # phase 21's global per-view batch
MA_TORCHRUN_STEPS = 3   # steps of phase 21's torchrun epoch
# phase 21 (i)-(m): the families beside R(2+1)D, at full width (the
# fused_conv flag is R(2+1)D's, and --quant excludes it)
FAMILIES = {"c3d": dict(model_name="c3d_byol", fused_conv=0),
            "r3d": dict(model_name="r3d_byol", model_depth=18,
                        resnet_shortcut="B", fused_conv=0),
            # (n)-(q): S3D-G and I3D
            "s3d": dict(model_name="s3d_byol", fused_conv=0),
            "i3d": dict(model_name="i3d_byol", fused_conv=0),
            # (t)-(v): SlowFast-50 (phase 16's: the slow pathway on every
            # 4th of the 16 frames), both pathways on one H split
            "sf": dict(model_name="slowfast", model_depth=50, tau=8, alpha=4,
                       fused_conv=0)}
# (m)'s families: K6 at world 1 at every conv shape (S3D-G's and I3D's
# launches are held on their shard inputs in (p) and (q))
MA_K6_FAMILIES = ("c3d", "r3d")
# phase 21's rank runs: name -> the mesh flags over its kernel config
MA_RUNS = {
    "spatial": dict(mesh_shape=(1, 2), shard_spatial=1),
    "tp": dict(mesh_shape=(1, 2)),
    "zero": dict(mesh_shape=(2, 1), shard_opt_state=1),
    "no_zero": dict(mesh_shape=(2, 1)),
    # (e)-(h): every R(2+1)D flag on the H shards (fused sites only where
    # the flag takes them: JAX refuses --fused_conv with --t_fold and
    # --quant)
    "s2d": dict(mesh_shape=(1, 2), shard_spatial=1, s2d_stem=True),
    "t_fold": dict(mesh_shape=(1, 2), shard_spatial=1, t_fold=1,
                   fused_conv=0),
    "int8": dict(mesh_shape=(1, 2), shard_spatial=1, quant="int8",
                 fused_conv=0),
    "int8_store": dict(mesh_shape=(1, 2), shard_spatial=1,
                       quant="int8_store", fused_conv=0),
    # (i)-(l): C3D and the 3D-ResNet (r3d-18, shortcut "B") on the H shards,
    # float and --quant int8 (K6 on the halo-extended shards); their
    # batches draw 4 playback-rate classes, as these families' heads have
    "c3d": dict(FAMILIES["c3d"], mesh_shape=(1, 2), shard_spatial=1),
    "r3d": dict(FAMILIES["r3d"], mesh_shape=(1, 2), shard_spatial=1),
    "c3d_int8": dict(FAMILIES["c3d"], mesh_shape=(1, 2), shard_spatial=1,
                     quant="int8"),
    "r3d_int8": dict(FAMILIES["r3d"], mesh_shape=(1, 2), shard_spatial=1,
                     quant="int8"),
    # (n)-(q): S3D-G and I3D on the H shards (TF-SAME sites, S3D-G's gates
    # over 'model'), float and --quant int8
    "s3d": dict(FAMILIES["s3d"], mesh_shape=(1, 2), shard_spatial=1),
    "i3d": dict(FAMILIES["i3d"], mesh_shape=(1, 2), shard_spatial=1),
    "s3d_int8": dict(FAMILIES["s3d"], mesh_shape=(1, 2), shard_spatial=1,
                     quant="int8"),
    "i3d_int8": dict(FAMILIES["i3d"], mesh_shape=(1, 2), shard_spatial=1,
                     quant="int8"),
    # (r), (s): the same towers on the H shards in float32 (MA_F32_RUNS)
    "s3d_f32": dict(FAMILIES["s3d"], mesh_shape=(1, 2), shard_spatial=1),
    "i3d_f32": dict(FAMILIES["i3d"], mesh_shape=(1, 2), shard_spatial=1),
    # (t)-(v): SlowFast-50 on the H shards, float with K5, --quant int8
    # (K6 on the halo-extended shards of both pathways, the laterals and
    # the 1x1 convs on their own rows) and float32
    "sf": dict(FAMILIES["sf"], mesh_shape=(1, 2), shard_spatial=1),
    "sf_int8": dict(FAMILIES["sf"], mesh_shape=(1, 2), shard_spatial=1,
                    quant="int8"),
    "sf_f32": dict(FAMILIES["sf"], mesh_shape=(1, 2), shard_spatial=1),
}
MA_PART = {"spatial": "a", "zero": "b", "no_zero": "b", "tp": "c",
           "s2d": "e", "t_fold": "f", "int8": "g", "int8_store": "h",
           "c3d": "i", "r3d": "j", "c3d_int8": "k", "r3d_int8": "l",
           "s3d": "n", "i3d": "o", "s3d_int8": "p", "i3d_int8": "q",
           "s3d_f32": "r", "i3d_f32": "s", "sf": "t", "sf_int8": "u",
           "sf_f32": "v"}
# the runs in phase 4's float32 plain configuration (no kernel: the plain
# augment), each held against the world-1 float32 step of the run named
# here. Phase 4's rule cannot hold a sharded S3D-G or I3D step closely:
# their bf16 updates' cosines to the float32 update at world 1 are 0.11
# and 0.56, so a backward partly wrong on the shards could pass it. In
# float32 the shards reorder sums only, and the update must stay close
MA_F32_RUNS = {"s3d_f32": "s3d", "i3d_f32": "i3d", "sf_f32": "sf"}
# ... within test_torch_port_model_axis's tolerances: the loss terms within
# 1e-5 relative, each trained leaf's update within 5e-2 of the world-1
# leaf's in norm, plus 1e-4 of the whole update's norm (``_ma_hold_f32``
# reads the leaf's departure over ``|u_1| + 2e-3 |U_1|``: at most 5e-2).
# The whole update's relative error is only logged: it is its largest
# leaves'. On the CPU a sharded S3D-G step whose gates' mean has an
# identity backward leaves the whole update within 4.5e-2 (the correct
# step 1.7e-2), its worst leaf at 5.8e-2 (3.4e-2)
MA_F32_LIMITS = (1e-5, 5e-2)
MA_FAMILY_RUNS = ("c3d", "r3d", "c3d_int8", "r3d_int8", "s3d", "i3d",
                  "s3d_int8", "i3d_int8", "sf", "sf_int8")
# the runs held against a world-1 step of their own flags (phase 4's rule)
MA_FLAG_RUNS = ("s2d", "t_fold", "int8", "int8_store") + MA_FAMILY_RUNS
# the runs whose kernels are held against their plain versions on every
# shard input they took (``_ma_recorders``)
MA_RECORDED = ("spatial", "s2d", "int8", "int8_store", "c3d_int8",
               "r3d_int8", "s3d_int8", "i3d_int8", "sf_int8")
# phase 4's accuracy rule for the int8 runs: four of 16 predictions. Every
# conv of both towers quantizes, so a BatchNorm sum reassociated over the
# shards flips round-half decisions at the next site's quantize, and the
# random-weight heads' near-tied predictions with them
# (tests/test_torch_port_shard_flags.py shows the same departure from a
# step whose BatchNorm sums alone run in another order); the (h) step
# moved three in both of its runs on the card, the float runs one or two
MA_INT8_ACC = 0.25
# ... held together with the int8 runs' update cosine to the world-1 step
# of the same flags, 0.8 of what it measured on one H100 80GB HBM3 at
# 700 W in the first call that reported it (0.84953 for (g), 0.64745 for
# (h); 0.99505 for (k) and 0.93577 for (l); 0.32361 for (p) and 0.43221
# for (q); 0.16326 for (u), rounded down); the float runs measure
# 0.948-0.997 there
# (S3D-G's 0.463 and I3D's 0.853: their bf16 updates' cosines to the
# float32 update at world 1 are 0.11 and 0.56), and the int8 updates'
# cosines to the float32 update (what an update sharing nothing of the
# world-1 int8 step's would come near) 0.23-0.30 for R(2+1)D, C3D's and
# r3d-18's 0.95 and 0.68, S3D-G's and I3D's -0.02 and 0.04, SlowFast-50's
# 0.014
MA_INT8_COS = {"int8": 0.68, "int8_store": 0.52, "c3d_int8": 0.79,
               "r3d_int8": 0.74, "s3d_int8": 0.25, "i3d_int8": 0.34,
               "sf_int8": 0.13}
# the int8 runs whose world-1 update is all but orthogonal to the float32
# update (SlowFast-50's cosine 0.01400 on one H100 80GB HBM3 at 700 W), so
# that phase 4's cosine arm compares two readings of the int8 rounding's
# noise: there (u) on (1, 2) read -0.04400, at cosine 0.16326 to world 1,
# 0.058 below world 1's reading against the rule's margin of 0.05. Each
# gets a world-1 step with only its BatchNorm sums taken in another order
# (H reversed, as the shards reorder them; its readings are on the
# phase's "BatchNorm sums H reversed" line), and the cosine arm takes the
# lower of the two world-1 cosines (``_agree``'s ``reordered``)
MA_REORDERED = ("sf_int8",)
_TAPS9 = dict(_per_step(0, 0, 1), conv21d_taps9_stats=10,
              conv21d_taps9_fwd=10)
# launches per rank and step (world 1: the same flags without the mesh)
# K6 per --quant int8 step: C3D's 8 convs and r3d-18's stem, 16 block
# convs and 3 shortcut convs, S3D-G's 77 (the stem's 2, Conv_2b's and
# Conv_2c's 3, 8 in each of 9 blocks) and I3D's 57 (3, then 6 in each
# block), in both towers; SlowFast-50's 110 a tower: each pathway's stem,
# 48 block convs and 4 projections, and the 4 laterals
FAMILY_K6 = {"c3d": 16, "r3d": 40, "s3d": 154, "i3d": 114, "sf": 220}
MA_WANT = {"spatial": _TAPS9, "s2d": _TAPS9, "t_fold": _per_step(0, 0, 1),
           "int8": _per_step(0, 0, 1, 48), "int8_store": STORE_PER_STEP,
           "c3d": _per_step(0, 0, 1), "r3d": _per_step(0, 0, 1),
           "c3d_int8": _per_step(0, 0, 1, FAMILY_K6["c3d"]),
           "r3d_int8": _per_step(0, 0, 1, FAMILY_K6["r3d"]),
           "s3d": _per_step(0, 0, 1), "i3d": _per_step(0, 0, 1),
           "s3d_int8": _per_step(0, 0, 1, FAMILY_K6["s3d"]),
           "i3d_int8": _per_step(0, 0, 1, FAMILY_K6["i3d"]),
           "s3d_f32": _per_step(0, 0, 0), "i3d_f32": _per_step(0, 0, 0),
           "sf": _per_step(0, 0, 1),
           "sf_int8": _per_step(0, 0, 1, FAMILY_K6["sf"]),
           "sf_f32": _per_step(0, 0, 0)}
MA_WANT_WORLD1 = dict(MA_WANT, s2d=_per_step(10, 10, 1))
del MA_WANT_WORLD1["spatial"]


def _ma_config(fused: bool = True, **over):
    """Phase 4's configuration (kernels, or plain float32 with ``fused``
    off) at per-view MA_B_VIEW, with ``over``'s mesh and model flags."""
    from cstp_tpu_torch.config import Config

    kw = dict(model_name="r21d", model_depth=1)
    kw.update(dict(fused_conv=1, pallas_augment="on",
                   compute_dtype="bfloat16") if fused else
              dict(pallas_augment="off", compute_dtype="float32"))
    kw.update(over)
    if not fused:
        kw["fused_conv"] = 0
    return Config(sample_duration=T, sample_size=S, batch_size=MA_B_VIEW,
                  task="loss_com", **kw).finalize()


def _ma_batch(dev, name: str = "spatial"):
    """Phase 21's batch of run ``name`` (4 playback-rate classes for the
    families with 4-way heads)."""
    n_pb = 5 if MA_RUNS[name].get("model_name", "r21d") == "r21d" else 4
    return {k: v[:MA_B_VIEW]
            for k, v in _slice_batch(dev, seed=6, n_pb=n_pb).items()}


def _ma_recorders(shards):
    """Wrappers of the kernels' CUDA entries that keep, per kind and input
    shape, the first call's inputs (and count the calls) in ``shards``:
    the padded H shards and weights of the fused sites' K4a/K4b, K6's
    inputs (halo-extended on the spatial convs), the storage epilogue's
    and K7's. Returns ``{(module, name): wrapper}``."""
    from cstp_tpu_torch.ops import conv21d as C
    from cstp_tpu_torch.ops import quant as Q

    def keep(kind, key, args):
        got = shards.setdefault(kind, {})
        if key not in got:
            got[key] = [tuple(a.detach().clone() if torch.is_tensor(a)
                              else a for a in args), 0]
        got[key][1] += 1

    made = {(C, "fused_st_conv_cuda"): C.fused_st_conv_cuda,
            (Q, "int8_conv3d_cuda"): Q.int8_conv3d_cuda,
            (Q, "int8_conv3d_store_cuda"): Q.int8_conv3d_store_cuda,
            (Q, "bn_relu_requant_cuda"): Q.bn_relu_requant_cuda}

    def fused(*args):
        # FusedSTConv's call: (x, ws, wt, scale, bias, groups, eps, tiling,
        # cross_rank, spatial)
        if args[9]:
            keep("taps9", tuple(args[0].shape), args[:6])
        return made[C, "fused_st_conv_cuda"](*args)

    def k6(*args):
        xq, wq = args[:2]
        keep("k6", (tuple(xq.shape), tuple(wq.shape), str(args[3:])), args)
        return made[Q, "int8_conv3d_cuda"](*args)

    def store(*args):
        keep("store", (tuple(args[0].shape), tuple(args[1].shape),
                       str(args[4:])), args)
        return made[Q, "int8_conv3d_store_cuda"](*args)

    def k7(*args):
        keep("k7", tuple(args[0].shape), args)
        return made[Q, "bn_relu_requant_cuda"](*args)

    return made, {(C, "fused_st_conv_cuda"): fused,
                  (Q, "int8_conv3d_cuda"): k6,
                  (Q, "int8_conv3d_store_cuda"): store,
                  (Q, "bn_relu_requant_cuda"): k7}


def _ma_step_run(dev, cfg, batch, record: bool = False,
                 timed_steps: int = 2):
    """On a rank of phase 21: one step of ``cfg`` from seed-0 weights and a
    generator seeded 5 on this rank's rows of ``batch``, with the whole
    update (gathered where 'model' splits a head), the launches, the peak
    of allocated memory and the optimizer state's bytes on this rank; then
    ``timed_steps`` steps on, their mean ms. ``record``: also the inputs
    each kernel took on the shards in that step, one per kind and shape
    (``_ma_recorders``)."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train import optim
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
    names = list(optim.trainable(model))
    p0 = {n: t.clone() for n, t in mesh.full_state_dict(model).items()
          if n in names}
    step = make_pretrain_step(model, tx, cfg)
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = mesh.shard_batch(batch)
    shards = {}
    made, recorders = _ma_recorders(shards)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    if record:
        for (mod, name), fn in recorders.items():
            setattr(mod, name, fn)
    try:
        state, m = step(state, gen, rows, cfg.learning_rate)
    finally:
        for (mod, name), fn in made.items():
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    counts = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    after = mesh.full_state_dict(model)
    update = torch.cat([(after[n] - p0[n]).flatten().double()
                        for n in names])
    opt = (tx.gather_state(state.opt_state) if hasattr(tx, "gather_state")
           else state.opt_state)
    trace = torch.cat([t.flatten() for t in opt["trace"].values()])
    opt_bytes = sum(t.numel() * t.element_size()
                    for t in state.opt_state["trace"].values())
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        state, _ = step(state, gen, rows, cfg.learning_rate)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed_steps * 1e3
    return dict(metrics={k: float(v) for k, v in m.items()}, update=update,
                leaves=[(n, p0[n].numel()) for n in names], trace=trace,
                counts=counts, peak_gib=peak_gib, opt_bytes=opt_bytes,
                ms=ms, shards=shards)


def _ma_hold_shards(shards):
    """K4a and K4b against their plain versions on each recorded padded H
    shard (``_hold_pair`` on the padded input): one line each; returns the
    per-shape records and whether all agreed."""
    out, ok = [], True
    for shape, ((x, ws, wt, scale, bias, groups), _) in sorted(
            shards.get("taps9", {}).items()):
        good, bitwise, passes = _hold_pair("taps9", x, ws, wt, scale, bias,
                                           groups, padded=True)
        rec = dict(shape=shape, ok=good and bitwise)
        for p, (kms, err, ops, nb) in passes.items():
            b, by = bound_ms(ops, nb, PEAK_BF16)
            rec[p] = dict(ms=kms, err=err, bound=b, by=by)
        out.append(rec)
        ok &= rec["ok"]
    return out, ok


def _ma_hold_int8(shards):
    """K6 (dequantizing), K6's storage epilogue and K7 against their plain
    versions on each input they took on the shards (``_ma_recorders``):
    bitwise (integer sums, one rounding each), their ms and the plain
    versions', and the bounds of phase 19 (a) and 20 (a) (the input
    positions the taps read, halo rows included). Returns ``{kind:
    [record per shape]}`` and whether all were bitwise."""
    from cstp_tpu_torch.ops import quant as Q

    out, ok = {}, True
    kinds = {"k6": (Q.int8_conv3d_cuda, Q.int8_conv3d_plain),
             "store": (Q.int8_conv3d_store_cuda, Q.int8_conv3d_store_plain),
             "k7": (Q.bn_relu_requant_cuda, Q.bn_relu_requant_plain)}
    for kind, (kernel, plain) in kinds.items():
        for key, (args, calls) in shards.get(kind, {}).items():
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            pairs = list(zip(got, want)) if kind != "k6" else [(got, want)]
            bitwise = all(torch.equal(a, b) for a, b in pairs)
            err = max(float((a.double() - b.double()).abs().max())
                      for a, b in pairs)
            del got, want, pairs
            ms = time_ms(lambda: kernel(*args))
            plain_ms = time_ms(lambda: plain(*args), iters=1, warmup=0)
            if kind == "k7":
                hq = args[0]
                n, m = hq.shape[0], hq.shape[-1]
                bound, by = bound_ms(8.0 * hq.numel(), 2 * hq.numel()
                                     + 8 * n * m + 8 * m + 8, PEAK_F32)
                shape = tuple(hq.shape)
            else:
                xq, wq = args[:2]
                stride, lo, hi = args[-4:-1] if kind == "store" else \
                    args[3:6]
                (n, t, h, w, cin), (cout, _, *k) = xq.shape, wq.shape
                o = Q.out_shape(xq.shape, wq.shape, stride, lo, hi)
                rows = math.prod(o[:4])
                read = n * cin * math.prod(
                    _read_extent(*a) for a in zip((t, h, w), o[1:4], k,
                                                  stride, lo))
                written = (rows * cout + 16 * n * cout if kind == "store"
                           else rows * cout * args[6].itemsize)
                bound, by = bound_ms(2.0 * rows * cout * cin * math.prod(k),
                                     read + wq.numel() + written + 4 * cout,
                                     PEAK_INT8)
                shape = tuple(xq.shape)
            out.setdefault(kind, []).append(dict(
                shape=shape, calls=calls, ms=ms, plain_ms=plain_ms,
                bound=bound, by=by, err=err, ok=bitwise))
            ok &= bitwise
    return out, ok


def ma_rank(rank: int, world: int, port: int, out: str,
            device: str = "cuda:0") -> None:
    """One rank of phase 21 (a)-(c) and (e)-(v): each of MA_RUNS on this
    rank's share of phase 21's batch, over gloo on card 0, then (after
    MA_RECORDED's runs) each kernel on the shard inputs it took; writes
    the records under ``out`` and (rank 0) the updates."""
    import os

    from cstp_tpu_torch.parallel import mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0")
    dev = torch.device(device)
    mesh.maybe_initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", device=dev, backend="gloo")
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        result = {}
        for name, over in MA_RUNS.items():
            # the ZeRO pair is compared bit for bit: deterministic cuDNN
            torch.backends.cudnn.deterministic = name in ("zero", "no_zero")
            # the flag runs' steps timed once (the gloo steps swing by 40%
            # between calls, MA_FLAG_RUNS' world-1 steps likewise)
            t_run = time.perf_counter()
            run = _ma_step_run(
                dev, _ma_config(fused=name not in MA_F32_RUNS, **over),
                _ma_batch(dev, name), record=name in MA_RECORDED,
                timed_steps=(1 if name in MA_FLAG_RUNS or name in MA_F32_RUNS
                             else 2))
            shards = run.pop("shards")
            if shards:
                run["shards"], run["shards_ok"] = _ma_hold_shards(shards)
                run["int8_shards"], ok8 = _ma_hold_int8(shards)
                run["shards_ok"] &= ok8
            del shards
            if mesh.is_main():
                torch.save(run["update"].float().cpu(), f"{out}.{name}.pt")
            run["update_norm"] = float(run.pop("update").norm())
            run["seconds"] = time.perf_counter() - t_run
            result[name] = run
            gc.collect()
            torch.cuda.empty_cache()
        z, n = result["zero"], result["no_zero"]
        for r in (z, n):
            r["trace"] = r["trace"].cpu()
        result["zero_bitwise"] = (torch.equal(z.pop("trace"),
                                              n.pop("trace"))
                                  and z["update_norm"] == n["update_norm"]
                                  and z["metrics"] == n["metrics"])
        for r in result.values():
            if isinstance(r, dict):
                r.pop("trace", None)
        torch.save(result, f"{out}.{rank}.pt")
    finally:
        mesh.shutdown()


def _ma_two_ranks(world1, f32):
    """Phase 21 (a)-(c): two rank processes on the one card over gloo
    (``ma_rank``); their records and updates against the world-1 kernel
    step ``world1`` with ``f32`` as arbiter (phase 4's rule)."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="cstp_ma_") as d:
        out, port = os.path.join(d, "rank"), _free_port()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("CSTP_", "MASTER_"))}
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--ma-rank", str(r), "2", str(port),
             out], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=900)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            for line in text.splitlines()[-12:]:
                log(f"[model]   rank {r}: {line}")
            if p.returncode != 0:
                raise SystemExit(f"[model] rank {r} of 2 over gloo exited "
                                 f"{p.returncode}")
        ranks = [torch.load(f"{out}.{r}.pt", weights_only=False)
                 for r in range(2)]
        updates = {n: torch.load(f"{out}.{n}.pt").double().to(
            world1["update"].device) for n in MA_RUNS}
    return ranks, updates


def _ma_torchrun(root: str) -> None:
    """Phase 21 (d): ``torchrun --nproc_per_node 2`` over this script's
    ``--ma-torchrun`` entry (gloo on card 0 for both ranks, then
    ``cstp_tpu_torch.cli.main_byol.main``): one epoch of MA_TORCHRUN_STEPS
    steps on (1, 2) ``--shard_spatial``; then its checkpoint resumed at
    world size 1 in this process (``main_byol --task resume``, no mesh
    flags) for one more epoch. Finite CSV rows from both."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from cstp_tpu_torch.cli import main_byol

    train = os.path.join(root, "train.cstp")
    with ThreadPoolExecutor(8) as pool:
        _pack_videos(train, _cli_videos(),
                     range(MA_TORCHRUN_STEPS * MA_B_VIEW), pool)
    res = os.path.join(root, "results")
    argv = ["--model_name", "r21d_byol", "--model_depth", "1",
            "--sample_duration", str(T), "--sample_size", str(S),
            "--compute_dtype", "bfloat16", "--fused_conv", "1",
            "--pallas_augment", "on", "--batch_size", str(MA_B_VIEW),
            "--steps_per_epoch", str(MA_TORCHRUN_STEPS), "--log_every", "1",
            "--ckpt_every_epochs", "1",
            "--n_workers", "4", "--data_backend", "packed", "--lmdb_path",
            train, "--dataset", "UCF101", "--result_path", res]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", __file__, "--ma-torchrun", *argv,
           "--task", "loss_com", "--n_epochs", "1", "--mesh_shape", "1", "2",
           "--shard_spatial", "1"]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CSTP_", "MASTER_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=420)
    seconds = time.perf_counter() - t0
    for line in (done.stdout + done.stderr).splitlines()[-10:]:
        log(f"[model]   torchrun: {line}")
    if done.returncode != 0:
        raise SystemExit(f"[model] torchrun main_byol exited "
                         f"{done.returncode}")
    run_dir = os.path.join(res, "UCF101", "loss_com")
    csv = os.path.join(run_dir, f"UCF101_train_clip{T}modelr21d_byol1.log")
    rows = _check_rows(csv)
    log(f"[model] (d) torchrun --nproc_per_node 2 main_byol on (1, 2) "
        f"--shard_spatial, gloo on the one card, 1 epoch of "
        f"{MA_TORCHRUN_STEPS} steps at per-view {MA_B_VIEW}: {rows} finite "
        f"CSV row(s), {seconds:.1f} s with the processes' start")
    t0 = time.perf_counter()
    out, _ = _cli_run(main_byol.main, argv + [
        "--task", "resume", "--resume_md_path",
        os.path.join(run_dir, "save_1"), "--n_epochs", "2"],
        _per_step(10, 10, 1), 2 * MA_TORCHRUN_STEPS)
    rows = _check_rows(csv)
    log(f"[model] (d) its save_1 resumed at world size 1 (no mesh flags): "
        f"{len(out['history'])} epochs, {rows} finite CSV rows in all, "
        f"{time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def _bn_sums_reordered():
    """Every ``BatchNorm`` takes its moments over the same values summed in
    another order: H reversed in a 5-D input, as the H shards reorder
    them."""
    from cstp_tpu_torch.models.layers import BatchNorm

    made = BatchNorm.batch_stats

    def batch_stats(self, xf):
        return made(self, xf.flip(2) if xf.dim() == 5 else xf)

    BatchNorm.batch_stats = batch_stats
    try:
        yield
    finally:
        BatchNorm.batch_stats = made


def _ma_world1(dev):
    """Phase 21's world-1 references: the kernel step and the float32
    plain step (phase 4's arbiter) of the base flags and of each of
    MA_FLAG_RUNS without its mesh flags: ``{name: (kernel, f32)}``."""
    refs = {}
    for name in ("spatial",) + MA_FLAG_RUNS:
        flags = {k: v for k, v in MA_RUNS[name].items()
                 if k not in ("mesh_shape", "shard_spatial")}
        t_ref = time.perf_counter()
        batch = _ma_batch(dev, name)
        kernel = _one_step_run(dev, _ma_config(**flags), batch,
                               timed_steps=1 if flags else 2)
        f32 = _one_step_run(dev, _ma_config(fused=False, **flags), batch,
                            timed_steps=1)
        if name in MA_REORDERED:
            with _bn_sums_reordered():
                kernel["reordered"] = _one_step_run(
                    dev, _ma_config(**flags), batch, timed_steps=1)
            log(f"[model] world 1, {flags}, its BatchNorm sums H reversed: "
                f"update cosine to the float32 update "
                f"{_cos(kernel['reordered'], f32):.5f} (world 1 "
                f"{_cos(kernel, f32):.5f}), to world 1 "
                f"{_cos(kernel['reordered'], kernel):.5f}")
        kernel["seconds"] = time.perf_counter() - t_ref
        want = MA_WANT_WORLD1.get(name, _per_step(10, 10, 1))
        log(f"[model] world 1, per-view {MA_B_VIEW}, {flags or 'base'}: "
            f"kernel step {kernel['ms']:.1f} ms, peak "
            f"{kernel['peak_gib']:.2f} GiB, launches {kernel['counts']}; "
            f"float32 plain step {f32['ms']:.1f} ms")
        if kernel["counts"] != want:
            raise SystemExit(f"[model] the world-1 {name} step launched "
                             f"{kernel['counts']}, expected {want}")
        refs[name] = (kernel, f32)
    return refs


def _ma_log_int8_shards(r, name, recs):
    """One line per kernel and shard shape of phase 21 (g)/(h), and the
    per-step sums; returns those sums ``{kind: (ms, bound, launches)}``."""
    sums = {}
    labels = {"k6": "K6", "store": "K6 storage epilogue", "k7": "K7"}
    for kind, rows in recs.items():
        for rec in rows:
            log(f"[model] ({MA_PART[name]}) rank {r} {labels[kind]} on the "
                f"shard {'x'.join(map(str, rec['shape']))} ({rec['calls']} "
                f"a step): vs plain {'bitwise' if rec['ok'] else 'DIFFER'}, "
                f"{rec['ms']:.3f} ms, bound {rec['bound']:.3f} ms "
                f"({rec['by']}), plain {rec['plain_ms']:.2f} ms")
        sums[kind] = tuple(sum(rec[f] * rec["calls"] for rec in rows)
                           for f in ("ms", "bound")) + (
            sum(rec["calls"] for rec in rows),)
        ms, bound, n = sums[kind]
        log(f"[model] ({MA_PART[name]}) rank {r} {labels[kind]} per step on "
            f"its shards ({n} launches): {ms:.2f} ms, bound {bound:.3f} ms")
    return sums


def _ma_hold_f32(name, run, got, ref, card):
    """Run ``name`` of MA_F32_RUNS (rank 0's record ``run``, both ranks'
    ``got``) against the world-1 float32 step ``ref`` (the same trained
    leaves in the same order) within MA_F32_LIMITS; one line. Returns
    whether it held and its readings ``[loss err, acc err, cosine, 1.0, ms
    on rank 0, world 1's ms, the worst leaf's departure]``."""
    mk, mp = run["metrics"], ref["metrics"]
    loss_err = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-6)
                   for k in mk if k.startswith("loss"))
    acc_err = max(abs(mk[k] - mp[k]) for k in mk if k.startswith("acc"))
    u, u1 = run["update"], ref["update"]
    sizes = [n for _, n in run["leaves"]]
    floor = 2e-3 * float(u1.norm())
    leaf = [float((a - b).norm()) / (float(b.norm()) + floor)
            for a, b in zip(u.split(sizes), u1.split(sizes))]
    worst = max(range(len(leaf)), key=leaf.__getitem__)
    upd_err = float((u - u1).norm() / u1.norm())
    cos = _cos(run, ref)
    limits = MA_F32_LIMITS
    agree = (sum(sizes) == u1.numel() and loss_err <= limits[0]
             and leaf[worst] <= limits[1])
    log(f"[model] ({MA_PART[name]}) {name} float32 {MA_RUNS[name]}: "
        f"against the world-1 float32 step, max rel loss-term err "
        f"{loss_err:.3e} (tol {limits[0]}), max acc diff {acc_err:.4f}, "
        f"worst leaf's update departure {leaf[worst]:.3e} "
        f"({run['leaves'][worst][0]}; tol {limits[1]}), whole update rel "
        f"err {upd_err:.3e}, cosine {cos:.6f}; launches per rank "
        f"{[g['counts'] for g in got]}; step "
        f"ms per rank {[round(g['ms'], 1) for g in got]} (world 1 "
        f"{ref['ms']:.1f}); peak GiB per rank "
        f"{[round(g['peak_gib'], 2) for g in got]} ({card})")
    return agree, [float(f"{loss_err:.3e}"), acc_err, round(cos, 6), 1.0,
                   round(got[0]["ms"], 1), round(ref["ms"], 1),
                   float(f"{leaf[worst]:.3e}")]


def phase_model_axis(dev, card: str):
    """Phase 21: the 'model' mesh axis with two gloo ranks on the one card,
    R(2+1)D depth 1, 16 x 112^2, bf16, per-view MA_B_VIEW, K5 on: (a) (1,
    2) --shard_spatial, its fused sites on K4a/K4b (10 + 10 a step) held
    against their plain versions on every padded shard and the step
    against the world-1 kernel step by phase 4's rule; (b) (2, 1)
    --shard_opt_state bitwise to (2, 1) without it; (c) (1, 2)
    tensor-parallel MLPs against world 1; (e)-(h) (1, 2) --shard_spatial
    with --s2d_stem (K4a/K4b), --t_fold 1, --quant int8 (K6 on the
    halo-extended shards) and --quant int8_store after its bootstrap (K6
    with its storage epilogue, K7), each against the world-1 step of its
    own flags by phase 4's rule (the int8 runs also by MA_INT8_COS) and
    each kernel against its plain version on the shards it took; (i)-(l)
    C3D and r3d-18 "B" on (1, 2) --shard_spatial, float and --quant int8
    (K6 on the halo-extended shards, 16 and 40 a step), likewise, and
    (n)-(q) S3D-G and I3D (154 and 114 K6 a step); (r)/(s) S3D-G and
    I3D on (1, 2) in float32 against the world-1 float32 step
    (``_ma_hold_f32``); (t)-(v) SlowFast-50, both pathways and the
    laterals on one H split: float with K5 and --quant int8 (220 K6 a
    step) by phase 4's rule, and float32 (``_ma_hold_f32``); (m) K6 at world 1 at every C3D and r3d-18 conv
    shape; (d) a torchrun epoch on (1, 2) --shard_spatial resumed at world
    1. Returns the ranks' main-path launches and the readings: per run
    ``[loss err, acc err, cosine, world 1's cosine, ms on rank 0, world
    1's ms, cosine to world 1]`` (``_ma_hold_f32``'s for (r)/(s)), the
    per-step kernel sums of the int8 runs on rank 0's shards ``(ms, bound
    ms, launches)`` and (m)'s per-step sums."""
    import tempfile

    t_phase = time.perf_counter()
    refs = _ma_world1(dev)
    world1, f32 = refs["spatial"]
    ranks, updates = _ma_two_ranks(world1, f32)
    counts = {k: 0 for k in _per_step(0, 0, 0)}
    cases = {}
    ok = True
    for name in MA_RUNS:
        got = [r[name] for r in ranks]
        want = MA_WANT.get(name, _per_step(10, 10, 1))
        ok &= all(g["counts"] == want for g in got)
        for g in got:
            for k, v in g["counts"].items():
                counts[k] += v
        run = dict(got[0], update=updates[name])
        if name in MA_F32_RUNS:
            agree, cases[name] = _ma_hold_f32(
                name, run, got, refs[MA_F32_RUNS[name]][1], card)
            ok &= agree and len({g["update_norm"] for g in got}) == 1
            continue
        ref, arbiter = refs.get(name, (world1, f32))
        acc_tol = MA_INT8_ACC if "quant" in MA_RUNS[name] else 0.125
        loss_err, acc_err, cos_run, cos_ref, agree = _agree(
            run, ref, arbiter, acc_tol, ref.get("reordered"))
        cos_w1 = _cos(run, ref)
        if name in MA_INT8_COS:
            agree &= cos_w1 >= MA_INT8_COS[name]
        if name in ("spatial", "tp") + MA_FLAG_RUNS:
            ok &= agree and len({g["update_norm"] for g in got}) == 1
        cases[name] = [float(f"{loss_err:.3e}"), acc_err, round(cos_run, 5),
                       round(cos_ref, 5), round(got[0]["ms"], 1),
                       round(ref["ms"], 1), round(cos_w1, 5)]
        log(f"[model] ({MA_PART[name]}) {name} {MA_RUNS[name]}: against "
            f"world 1, max rel loss-term err "
            f"{loss_err:.3e}, max acc diff {acc_err:.4f}, update cosine to "
            f"the float32 update {cos_run:.5f} (world 1 {cos_ref:.5f}"
            + (f", its BatchNorm sums reordered "
               f"{_cos(ref['reordered'], arbiter):.5f}; tol loss 2e-2, acc "
               f"{acc_tol}, cosine >= the lower - 0.05"
               if "reordered" in ref else f"; tol loss 2e-2, acc {acc_tol}, "
               "cosine >= world 1 - 0.05")
            + f"); to world 1 {cos_w1:.5f}"
            + (f" (tol >= {MA_INT8_COS[name]})" if name in MA_INT8_COS
               else "") + "; launches per rank "
            f"{[g['counts'] for g in got]} (want {want}); step ms per rank "
            f"{[round(g['ms'], 1) for g in got]} (world 1 "
            f"{ref['ms']:.1f}); peak GiB per rank "
            f"{[round(g['peak_gib'], 2) for g in got]} (world 1 "
            f"{ref['peak_gib']:.2f}); optimizer state MiB per rank "
            f"{[round(g['opt_bytes'] / 2**20, 1) for g in got]} ({card})")
    int8_sums = {}
    for r, rank in enumerate(ranks):
        for name in ("spatial", "s2d"):
            for rec in rank[name]["shards"]:
                n, t, hp, wp, cin = rec["shape"]
                log(f"[model] ({MA_PART[name]}) rank {r} K4a/K4b on the "
                    f"padded shard {n}x{t}x{hp}x{wp}x{cin} ({hp - 2} of the "
                    f"frame's rows): " + " | ".join(
                        f"{p} err {rec[p]['err']:.3e} {rec[p]['ms']:.3f} ms, "
                        f"bound {rec[p]['bound']:.3f} ms ({rec[p]['by']})"
                        for p in ("stats", "fwd"))
                    + f" | agree and K4a bitwise twice: {rec['ok']}")
        for name in MA_RECORDED:
            ok &= rank[name]["shards_ok"]
            sums = _ma_log_int8_shards(r, name, rank[name]["int8_shards"])
            if r == 0:
                int8_sums.update({f"{name} {k}": v for k, v in sums.items()})
        ok &= rank["zero_bitwise"]
    if set(int8_sums) != {"int8 k6", "int8_store k6", "int8_store store",
                          "int8_store k7", "c3d_int8 k6", "r3d_int8 k6",
                          "s3d_int8 k6", "i3d_int8 k6", "sf_int8 k6"}:
        ok = False
    log(f"[model] (b) --shard_opt_state on (2, 1): update, metrics and "
        f"gathered momentum bitwise those without it: "
        f"{[r['zero_bitwise'] for r in ranks]}")
    if not ok:
        raise SystemExit("[model] a 'model' axis run disagrees, launched "
                         "other kernels, or a kernel disagrees with its "
                         "plain version on a shard")
    # the seconds of this phase's family runs, (i)-(v): their world-1
    # references, their runs on rank 0 (whose rank 1 runs beside it) and (m)
    new = {n: round(refs[n][0]["seconds"] + ranks[0][n]["seconds"], 1)
           for n in MA_FAMILY_RUNS}
    new.update({n: round(ranks[0][n]["seconds"], 1) for n in MA_F32_RUNS})
    del world1, f32, updates, refs
    torch.cuda.empty_cache()
    t_m = time.perf_counter()
    families_k6 = _ma_family_k6(dev)
    new["m"] = round(time.perf_counter() - t_m, 1)
    log(f"[model] (i)-(v) seconds, each run's world-1 references and its "
        f"ranks' run: {new}, {sum(new.values()):.1f} s in all")
    with tempfile.TemporaryDirectory(prefix="cstp_ma_cli_") as root:
        _ma_torchrun(root)
    log(f"[model] phase {time.perf_counter() - t_phase:.1f} s")
    return counts, dict(cases=cases, shards=int8_sums,
                        families_k6=families_k6, new_s=new)


def _ma_family_k6(dev):
    """Phase 21 (m): K6 at world 1 at every distinct conv shape of C3D and
    r3d-18 (16 x 112^2; a Cin-3 stem of kernel 3 or 7, full 3x3x3 taps up
    to 512 channels, strided 3x3x3 and 1x1x1 convs), bitwise to its plain
    version at batch Q_CHECK_BS, timed with its bound at the towers'
    2 x MA_B_VIEW clips. Returns per family the per-step sums over its
    FAMILY_K6 launches ``(ms, bound ms, plain ms, launches)``."""
    from cstp_tpu_torch.train.finetune import create_classify_model

    gen = torch.Generator(device=dev).manual_seed(21)
    out, ok = {}, True
    for fam in MA_K6_FAMILIES:
        kw = FAMILIES[fam]
        cfg = _ft_config(task="test", quant="int8_static", **kw)
        model = create_classify_model(cfg, N_FT_CLASSES, device=dev)
        sites = _int8_sites(dev, model)
        del model
        sums = [0.0, 0.0, 0.0, 0]
        for key, names in sites.items():
            r = _k6_site(dev, gen, key, batch=2 * MA_B_VIEW)
            n = len(names)
            ok &= r["bitwise"]
            for i, f in enumerate(("ms", "bound", "plain_ms")):
                sums[i] += 2 * n * r[f]    # both towers
            sums[3] += 2 * n
            (t, h, w, cin), cout, k, stride, lo, hi = key
            log(f"[model] (m) {fam} K6 {names[0]}"
                f"{f' (+{n - 1})' if n > 1 else ''}: x ({t}, {h}, {w}, "
                f"{cin}) -> {cout}, kernel {k}, stride {stride}, pads "
                f"{lo}/{hi}: vs plain at batch {Q_CHECK_BS} "
                f"{'bitwise' if r['bitwise'] else 'DIFFER'}; at batch "
                f"{2 * MA_B_VIEW}: {r['ms']:.3f} ms, bound "
                f"{r['bound']:.3f} ms ({r['by']}), plain (float64) "
                f"{r['plain_ms']:.1f} ms, cuDNN bf16 {r['cudnn_ms']:.3f} ms")
        log(f"[model] (m) {fam} K6 per --quant int8 step at world 1 "
            f"({sums[3]} launches, {len(sites)} shapes, per-view "
            f"{MA_B_VIEW}): {sums[0]:.2f} ms, bound {sums[1]:.3f} ms, plain "
            f"{sums[2]:.1f} ms")
        ok &= sums[3] == FAMILY_K6[fam]
        out[fam] = [round(sums[0], 3), round(sums[1], 4),
                    round(sums[2], 1), sums[3]]
    if not ok:
        raise SystemExit("[model] (m) K6 differs from its plain version at "
                         "a C3D or r3d-18 site, or a family has another "
                         "count of int8 sites")
    return out


# ------------------------------------------------------------ rewrites, ranks

# phase 22 (a): the K2/K3 sites whose mid widths --mid_round 128 changes
# (144 / 288 / 576 -> 128 / 256 / 512; conv5's 1152 stays, phase 2's), as
# SITES: (site, T, H=W, Cin, M, Cout, calls per tower)
MID_ROUND = 128
MID_ROUND_SITES = [
    ("conv2.block1.conv1/conv2", 16, 56, 64, 128, 64, 2),
    ("conv3.block1.conv2", 8, 28, 128, 256, 128, 1),
    ("conv4.block1.conv2", 4, 14, 256, 512, 256, 1),
]
# phase 22 (b)'s steps at per-view B_VIEW: tag -> (config flags, whether
# the kernel step takes the fused sites, its launches per step); the plain
# step of each takes neither kernel
REWRITE_RUNS = {
    "--mid_round 128 --fused_conv 1": (dict(mid_round=MID_ROUND), True,
                                       _per_step(10, 10, 1)),
    "--s2d_stem --fused_conv 1": (dict(s2d_stem=True), True,
                                  _per_step(10, 10, 1)),
    "--t_fold 1": (dict(t_fold=1), False, _per_step(0, 0, 1)),
    # 12 sites a tower, their spatial convs K6 on the folded (N T, 1, H, W)
    "--t_fold 1 --quant int8": (dict(t_fold=1, quant="int8"), False,
                                _per_step(0, 0, 1, 48)),
}
EVAL_TEST_VIDEOS = 5    # an uneven split over two data rows
# K6 launches per video of the int8_static forward: R(2+1)D depth 1's 24
# convs, r3d-18's 20
EVAL_K6 = 24
EVAL_K6_R3D = FAMILY_K6["r3d"] // 2
EVAL_K6_I3D = FAMILY_K6["i3d"] // 2
EVAL_K6_SF = FAMILY_K6["sf"] // 2
# phase 22 (c)'s world-2 runs on (1, 2) H shards, R(2+1)D's and r3d-18's:
# both ranks run every video (K6 on the halo-extended shards); each held
# to the world-1 int8_static report of its model, whose config record
# (the report's head) differs in the mesh flags alone
EVAL_SPATIAL = {"test int8_static (1, 2)": "test int8_static",
                "test int8_static r3d-18 (1, 2)": "test int8_static r3d-18",
                "test int8_static i3d (1, 2)": "test int8_static i3d",
                "test int8_static slowfast_fb (1, 2)":
                    "test int8_static slowfast_fb"}
MESH_FLAGS = {"mesh_shape", "shard_spatial"}
EVAL_R3D = dict(model_name="r3d", model_depth=18, resnet_shortcut="B")
EVAL_I3D = dict(model_name="i3d")
EVAL_SF = dict(model_name="slowfast_fb", model_depth=50, tau=8, alpha=4)
# phase 22 (c)'s I3D --i3d_conv_head finetune step (16 x 224^2 from
# 256x340 frames, batch FT_HEAD_BATCH), at world 1 (bf16, and float32 as
# phase 4's arbiter) and on (1, 2) H shards in the torchrun ranks
FT_HEAD = dict(model_name="i3d_byol", i3d_conv_head=1, sample_size=S_LARGE)
FT_HEAD_BATCH = 8
FT_HEAD_RUN = "finetune i3d --i3d_conv_head (1, 2)"
FT_HEAD_MESH = dict(mesh_shape=(1, 2), shard_spatial=1)


def _same_report(got: str, want: str, mesh_flags: bool) -> bool:
    """Byte for byte, or (``mesh_flags``) but for the mesh flags in the
    config record at the report's head."""
    if not mesh_flags:
        return got == want
    (cg, end_g), (cw, end_w) = (json.JSONDecoder().raw_decode(t)
                                for t in (got, want))
    return got[end_g:] == want[end_w:] and cg.keys() == cw.keys() and {
        k for k in cg if cg[k] != cw[k]} == MESH_FLAGS


def _mid_round_sites(dev):
    """Phase 22 (a): K2/K3 against the plain chain at MID_ROUND_SITES (2 x
    B_VIEW clips, G BN groups), phase 2's tolerances, plans and K2's
    bitwise repeat, then the SHA-256 prefixes of K3's output (given the
    plain statistics) and K2's statistics, as ``perf/sweep_conv21d_fwd.py
    --hash`` takes them (deterministic cuDNN)."""
    from cstp_tpu_torch.ops import conv21d as C
    from cstp_tpu_torch.perf.sweep_conv21d_fwd import _digest

    gen = torch.Generator(device=dev).manual_seed(0)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for site, t, hw, cin, m, cout, _ in MID_ROUND_SITES:
            n = 2 * B_VIEW

            def rnd(*shape, std=1.0):
                return torch.randn(shape, generator=gen, device=dev) * std
            x = rnd(n, t, hw, hw, cin).to(torch.bfloat16)
            ws = rnd(3, 3, cin, m, std=(9 * cin) ** -0.5)
            wt = rnd(3, m, cout, std=(3 * m) ** -0.5)
            scale = 0.5 + torch.rand(m, generator=gen, device=dev)
            bias = rnd(m, std=0.1)
            gm, gv = C.reference_stats(x, ws, G)
            pms = {"stats": time_ms(lambda: C.reference_stats(x, ws, G)),
                   "fwd": time_ms(lambda: C.reference_chain(
                       x, ws, wt, scale, bias, gm, gv, G))}
            ok, bitwise, passes = _hold_pair("clip", x, ws, wt, scale, bias)
            parts = []
            for p, (kms, err, ops, nb) in passes.items():
                b, by = bound_ms(ops, nb, PEAK_BF16)
                parts.append(f"{p} err {err:.3e} {kms:.3f} ms (plain "
                             f"{pms[p]:.3f}), bound {b:.3f} ms ({by})")
            log(f"[rewrite] (a) {site} at --mid_round {MID_ROUND}: N={n} "
                f"T={t} {hw}x{hw} Cin={cin} M={m} Cout={cout}: "
                + " | ".join(parts) + " | tol stats rtol 1e-2 atol 1e-3, "
                "fwd rtol 0.1 atol 0.05")
            log_stats_plan(C.plan_stats(n, t, hw, hw, cin, m, G),
                           passes["stats"], pms["stats"], bitwise)
            log_fwd_plan(C.plan_fwd(n, t, hw, hw, cin, m, cout),
                         passes["fwd"], pms["fwd"])
            wsk = ws.to(torch.bfloat16).reshape(9 * cin, m).contiguous()
            y = C.run_fwd(x, wsk, wt.to(torch.bfloat16).contiguous(), gm, gv,
                          scale, bias, G)
            log(f"[hash] K3 {site} M={m}: {_digest(y)}, K2: "
                f"{_digest(*C.run_stats(x, wsk, G))}")
            if not (ok and bitwise):
                raise SystemExit(f"[rewrite] K2/K3 disagree with their plain "
                                 f"version at {site}, M={m}, or K2 repeats "
                                 "differently")
            del x, y, gm, gv
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def _rewrite_steps(dev, card: str, slice_ms: float, counts):
    """Phase 22 (b): one step of each REWRITE_RUNS configuration from the
    same weights, generator and batch, its launches checked, against its
    plain bf16 step (no kernel; ``--quant int8``'s with the plain int8 conv
    in K6's place) by phase 4's rule with the plain float32 step of the
    same flags as arbiter; each timed over 2 steps. Adds the kernel steps'
    launches to ``counts``."""
    from cstp_tpu_torch.ops import quant as Q

    batch = _slice_batch(dev, seed=4)
    real = Q.int8_conv3d_cuda
    for tag, (over, fused, want) in REWRITE_RUNS.items():
        kernel = _one_step_run(dev, _slice_config(
            fused, pallas_augment="on", **over), batch)
        if "quant" in over:
            Q.int8_conv3d_cuda = Q.int8_conv3d_plain
        try:
            plain = _one_step_run(dev, _slice_config(False, **over), batch)
            f32 = _one_step_run(dev, _slice_config_plain_f32(**over), batch)
        finally:
            Q.int8_conv3d_cuda = real
        loss_err, acc_err, cos_k, cos_p, ok = _agree(kernel, plain, f32)
        log(f"[rewrite] (b) {tag}, per-view {B_VIEW}: kernel step "
            f"{kernel['ms']:.1f} ms ({B_VIEW / kernel['ms'] * 1e3:.1f} pairs/"
            f"s, peak {kernel['peak_gib']:.2f} GiB), plain bf16 "
            f"{plain['ms']:.1f} ms, plain float32 {f32['ms']:.1f} ms (2 steps "
            f"after one; phase 3's step {slice_ms:.1f} ms; {card}); loss "
            f"{kernel['metrics']['loss']:.5f} vs plain "
            f"{plain['metrics']['loss']:.5f}, max rel loss-term err "
            f"{loss_err:.3e} (tol 2e-2), max accuracy diff {acc_err:.4f} (tol "
            f"0.125), update cosine to float32: kernel {cos_k:.5f}, plain "
            f"{cos_p:.5f} (tol kernel >= plain - 0.05); launches "
            f"{kernel['counts']}, plain {plain['counts']}")
        if kernel["counts"] != want or any(plain["counts"].values()):
            raise SystemExit(f"[rewrite] {tag}: launches {kernel['counts']} "
                             f"(expected {want}), plain {plain['counts']}")
        if not ok:
            raise SystemExit(f"[rewrite] {tag}: the kernel step and the "
                             "plain step disagree")
        for k, v in kernel["counts"].items():
            counts[k] += v
        del kernel, plain, f32
        torch.cuda.empty_cache()


def _s3d_s2d_step(dev, card: str, counts):
    """Phase 22 (d): the s3d_byol ``--s2d_stem`` pretrain step at per-view
    B_VIEW with K5 (0/0/1) against the plain bf16 step (0/0/0) by phase
    4's rule, the plain float32 step as arbiter."""
    over = dict(model_name="s3d_byol", s2d_stem=True)
    batch = _slice_batch(dev, seed=4)
    runs = {k: _one_step_run(dev, cfg, batch) for k, cfg in (
        ("kernel", _slice_config(False, pallas_augment="on", **over)),
        ("plain", _slice_config(False, **over)),
        ("f32", _slice_config_plain_f32(**over)))}
    k, p, f = (runs[n] for n in ("kernel", "plain", "f32"))
    loss_err, acc_err, cos_k, cos_p, ok = _agree(k, p, f)
    log(f"[rewrite] (d) s3d_byol --s2d_stem pretrain, per-view {B_VIEW}: K5 "
        f"step {k['ms']:.1f} ms (peak {k['peak_gib']:.2f} GiB), plain bf16 "
        f"{p['ms']:.1f} ms, plain float32 {f['ms']:.1f} ms ({card}); max rel "
        f"loss-term err {loss_err:.3e} (tol 2e-2), max accuracy diff "
        f"{acc_err:.4f} (tol 0.125), update cosine to float32: K5 "
        f"{cos_k:.5f}, plain {cos_p:.5f}; launches {k['counts']}, plain "
        f"{p['counts']}")
    if k["counts"] != _per_step(0, 0, 1) or any(p["counts"].values()):
        raise SystemExit(f"[rewrite] s3d --s2d_stem: launches {k['counts']} "
                         f"(expected 0/0/1), plain {p['counts']}")
    if not ok:
        raise SystemExit("[rewrite] s3d --s2d_stem: the K5 step and the "
                         "plain step disagree")
    for key, v in k["counts"].items():
        counts[key] += v


def _conv_head_step(dev, dtype: str = "bfloat16", **mesh_flags):
    """One I3D ``--i3d_conv_head`` ft_all step (FT_HEAD, batch
    FT_HEAD_BATCH of phase 15's 256x340 frames, seed-0 weights, a
    generator seeded 12) on this rank's rows: its metrics, the whole
    update of the trainable parameters (float64, flat) and the launches
    (none: K5 is the pretrain augment's)."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train import finetune as ft
    from cstp_tpu_torch.train import optim

    cfg = _ft_config(fused=0, dtype=dtype, batch_size=FT_HEAD_BATCH,
                     **FT_HEAD, **mesh_flags)
    model, state, tx = ft.create_finetune_state(cfg, N_FT_CLASSES, seed=0,
                                                device=dev)
    names = list(optim.trainable(model))
    p0 = {n: t.clone() for n, t in mesh.full_state_dict(model).items()
          if n in names}
    step = ft.make_finetune_step(model, tx, cfg)
    gen = torch.Generator(device=dev).manual_seed(12)
    batch = {k: v[:FT_HEAD_BATCH]
             for k, v in _ft_batch(dev, 13, NATIVE_HW).items()}
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step(state, gen, mesh.shard_batch(batch), cfg.learning_rate)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    after = mesh.full_state_dict(model)
    update = torch.cat([(after[n] - p0[n]).flatten().double()
                        for n in names])
    del model, state, tx, step, batch
    torch.cuda.empty_cache()
    return dict(metrics={k: float(v) for k, v in m.items()}, update=update,
                counts=counts, ms=seconds * 1e3)


def _eval_runs(root: str, train: str, float_ckpt: str, calib: str,
               calib_r3d: str, calib_i3d: str, calib_sf: str):
    """Phase 22 (c)'s flags common to its CLIs, and its CLI runs: name ->
    (CLI module name, argv, K6 launches over the run at world size 1)."""
    import os

    common = ["--model_name", "r21d", "--model_depth", "1",
              "--sample_duration", str(T), "--sample_size", str(S),
              "--compute_dtype", "bfloat16", "--n_classes",
              str(N_FT_CLASSES), "--n_finetune_classes", str(N_FT_CLASSES),
              "--data_backend", "packed", "--lmdb_path", train,
              "--dataset", "UCF101", "--n_workers", "4", "--result_path",
              os.path.join(root, "results")]
    videos = Q_CALIB_VIDEOS + EVAL_TEST_VIDEOS     # gallery and queries
    runs = {}
    for quant, ckpt in (("", float_ckpt), ("int8_static", calib)):
        q = ["--quant", quant] if quant else []
        k6 = EVAL_K6 if quant else 0
        runs[f"test {quant or 'float'}"] = (
            "main_test", common + ["--task", "test", "--test_md_path", ckpt]
            + q, k6 * EVAL_TEST_VIDEOS)
        runs[f"retrieval {quant or 'float'}"] = (
            "main_retrieval", common + ["--task", "retrieval",
                                        "--test_md_path", ckpt] + q,
            k6 * videos)
    for name, ckpt, kw, k6 in (("r3d-18", calib_r3d, EVAL_R3D, EVAL_K6_R3D),
                               ("i3d", calib_i3d, EVAL_I3D, EVAL_K6_I3D),
                               ("slowfast_fb", calib_sf, EVAL_SF,
                                EVAL_K6_SF)):
        runs[f"test int8_static {name}"] = ("main_test", common + [
            "--task", "test", "--test_md_path", ckpt, "--quant",
            "int8_static"] + _argv(kw), k6 * EVAL_TEST_VIDEOS)
    mesh = ["--mesh_shape", "1", "2", "--shard_spatial", "1"]
    for spatial, name in EVAL_SPATIAL.items():
        cli, argv, k6 = runs[name]
        runs[spatial] = (cli, argv + mesh, k6)
    return common, runs


def eval_torchrun(spec: str) -> None:
    """One torchrun rank of phase 22 (c): gloo on card 0 (both ranks share
    it; NCCL takes one card a rank), then each run of the JSON file
    ``spec`` through its CLI's ``main``; writes per run its K6 launches
    and (rank 0) its report, and the files opened for writing by
    ``train.loops`` on a rank other than 0. Last, the I3D conv head's
    finetune step on (1, 2) H shards (``_conv_head_step``): its metrics
    and launches, and (rank 0) its update to ``<spec>.ft.pt``."""
    import builtins
    import importlib

    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train import loops

    with open(spec) as f:
        runs = json.load(f)
    mesh.maybe_initialize_distributed(device=torch.device("cuda", 0),
                                      backend="gloo")
    torch.backends.cudnn.allow_tf32 = False     # as main() runs world 1
    torch.backends.cuda.matmul.allow_tf32 = False
    writes, out = [], {}
    try:
        if not mesh.is_main():
            def guarded(file, mode="r", *a, **k):
                if any(c in mode for c in "wax+"):
                    writes.append(str(file))
                return builtins.open(file, mode, *a, **k)

            loops.open = guarded
        for name, (cli, argv, _) in runs.items():
            main = importlib.import_module(f"cstp_tpu_torch.cli.{cli}").main
            torch.cuda.synchronize()
            _reset_launch_counts()
            t0 = time.perf_counter()
            res = main(argv)
            torch.cuda.synchronize()
            out[name] = dict(
                k6=_launch_counts()["int8_conv"],
                seconds=time.perf_counter() - t0,
                report=(open(res["report"]).read() if mesh.is_main()
                        else None))
        run = _conv_head_step(torch.device("cuda", 0), **FT_HEAD_MESH)
        if mesh.is_main():
            torch.save(run["update"].float().cpu(), f"{spec}.ft.pt")
        run["update_norm"] = float(run.pop("update").norm())
        out[FT_HEAD_RUN] = run
        out["writes"] = writes
        with open(f"{spec}.{mesh.rank()}.json", "w") as f:
            json.dump(out, f)
    finally:
        mesh.shutdown()


def _eval_ranks(dev, card: str, counts):
    """Phase 22 (c): ``main_test`` and ``main_retrieval``, float and
    ``--quant int8_static``, at world size 1 in this process and then
    under ``torchrun --nproc_per_node 2`` (this script's
    ``--eval-torchrun``; two gloo ranks on the one card), on CSTPack files
    written here (Q_CALIB_VIDEOS train videos, the gallery and the
    calibration's, and EVAL_TEST_VIDEOS test videos); each world-2 report
    must be the world-1 report byte for byte, rank 1 must write no file,
    and each rank must launch K6 for its own videos (video i on rank i %
    2). The ``int8_static`` ``main_test`` runs at world 2 on (1, 2)
    ``--shard_spatial`` too (EVAL_SPATIAL), for R(2+1)D and for r3d-18
    (its own checkpoint and calibration): both ranks run every video, and
    each report is world 1's but for the mesh flags in its config line.
    The same ``main_test`` of I3D and of SlowFast-FB-50 (each its own
    checkpoint and calibration) on (1, 2) too, and the I3D conv head's finetune step on (1, 2) in the
    torchrun ranks against its world-1 steps (phase 4's rule).
    Adds the world-2 ranks' K6 launches to ``counts``; returns the seconds
    of the r3d-18, i3d and slowfast_fb runs and of the conv head's
    steps."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from cstp_tpu_torch.cli import main_retrieval, main_test
    from cstp_tpu_torch.serve import quantize as serve_quantize

    clis = {"main_test": main_test.main, "main_retrieval": main_retrieval.main}
    with tempfile.TemporaryDirectory(prefix="cstp_eval_ranks_") as root:
        train = os.path.join(root, "train.cstp")
        first_test = CLI_TRAIN + CLI_EVAL
        with ThreadPoolExecutor(8) as pool:
            _pack_videos(train, _cli_videos(), range(Q_CALIB_VIDEOS), pool)
            _pack_videos(os.path.join(root, "test.cstp"), _cli_videos(),
                         range(first_test, first_test + EVAL_TEST_VIDEOS),
                         pool)
        float_ckpt = os.path.join(root, "save_2_max")
        calib = os.path.join(root, "save_2_int8")
        float_r3d = os.path.join(root, "r3d_save_2_max")
        calib_r3d = os.path.join(root, "r3d_save_2_int8")
        float_i3d = os.path.join(root, "i3d_save_2_max")
        calib_i3d = os.path.join(root, "i3d_save_2_int8")
        float_sf = os.path.join(root, "sf_save_2_max")
        calib_sf = os.path.join(root, "sf_save_2_int8")
        _float_ft_checkpoint(dev, float_ckpt)
        common, runs = _eval_runs(root, train, float_ckpt, calib, calib_r3d,
                                  calib_i3d, calib_sf)
        t_new = {}
        for tag, kw, fl, cal in (("r3d-18", EVAL_R3D, float_r3d, calib_r3d),
                                 ("i3d", EVAL_I3D, float_i3d, calib_i3d),
                                 ("slowfast_fb", EVAL_SF, float_sf, calib_sf),
                                 ("r21d", {}, float_ckpt, calib)):
            t0 = time.perf_counter()
            if kw:
                _float_ft_checkpoint(dev, fl, **kw)
            _cli_run(serve_quantize.main, common + _argv(kw) + [
                "--task", "test", "--out_path", cal, "--test_md_path",
                fl, "--calib_batches", "2", "--calib_batch_size", "8"],
                {}, 1)
            t_new[tag] = time.perf_counter() - t0
        # the conv head's world-1 steps: bf16, and float32 as arbiter
        t0 = time.perf_counter()
        head = {dtype: _conv_head_step(dev, dtype)
                for dtype in ("bfloat16", "float32")}
        t_new["conv head"] = time.perf_counter() - t0
        one = {}
        for name, (cli, argv, k6) in runs.items():
            if name in EVAL_SPATIAL:     # world 2 only
                continue
            t0 = time.perf_counter()
            out, _ = _cli_run(clis[cli], argv, {"int8_conv": k6}, 1)
            one[name] = dict(seconds=time.perf_counter() - t0,
                             report=open(out["report"]).read())
        spec = os.path.join(root, "runs.json")
        with open(spec, "w") as f:
            json.dump(runs, f)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", __file__, "--eval-torchrun", spec]
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("CSTP_", "MASTER_"))}
        env["PYTHONPATH"] = os.pathsep.join(
            [os.getcwd()] + [p for p in [os.environ.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=300)
        seconds = time.perf_counter() - t0
        for line in (done.stdout + done.stderr).splitlines()[-8:]:
            log(f"[rewrite]   torchrun: {line}")
        if done.returncode != 0:
            raise SystemExit(f"[rewrite] torchrun main_test/main_retrieval "
                             f"exited {done.returncode}")
        ranks = []
        for r in range(2):
            with open(f"{spec}.{r}.json") as f:
                ranks.append(json.load(f))
        head_update = torch.load(f"{spec}.ft.pt").double().to(dev)
    ok = not ranks[1]["writes"]
    # the conv head on (1, 2) against world 1 (phase 4's rule)
    got = [rank[FT_HEAD_RUN] for rank in ranks]
    run = dict(got[0], update=head_update)
    loss_err, acc_err, cos_run, cos_ref, agree = _agree(
        run, head["bfloat16"], head["float32"])
    same = len({g["update_norm"] for g in got}) == 1
    ok &= agree and same and not any(any(g["counts"].values()) for g in got)
    log(f"[rewrite] (c) {FT_HEAD_RUN}, batch {FT_HEAD_BATCH}, {T}x"
        f"{S_LARGE}^2 bf16 (torchrun, gloo on the one card) against world "
        f"1: max rel loss-term err {loss_err:.3e} (tol 2e-2), max acc diff "
        f"{acc_err:.4f} (tol 0.125), update cosine to the float32 update "
        f"{cos_run:.5f} (world 1 {cos_ref:.5f}; tol >= world 1 - 0.05); to "
        f"world 1 {_cos(run, head['bfloat16']):.5f}; the ranks' update norms "
        f"equal: {same}; launches per rank {[g['counts'] for g in got]}; "
        f"step ms per rank {[round(g['ms'], 1) for g in got]} (world 1 "
        f"{head['bfloat16']['ms']:.1f}; {card})")
    del head, head_update, run
    for name, (cli, argv, k6) in runs.items():
        test = cli == "main_test"
        per_video = k6 // (EVAL_TEST_VIDEOS + (0 if test else
                                               Q_CALIB_VIDEOS))
        # video i on rank i % 2, over the test split (and the gallery); on
        # H shards every video on both ranks
        share = [len(range(r, EVAL_TEST_VIDEOS, 2)) + (0 if test else len(
            range(r, Q_CALIB_VIDEOS, 2))) for r in range(2)]
        if name in EVAL_SPATIAL:
            share = [EVAL_TEST_VIDEOS] * 2
        want = [per_video * s for s in share]
        got = [rank[name]["k6"] for rank in ranks]
        ref = one[EVAL_SPATIAL.get(name, name)]
        same = _same_report(ranks[0][name]["report"], ref["report"],
                            name in EVAL_SPATIAL)
        ok &= same and got == want
        counts["int8_conv"] += sum(got)
        lines = ref["report"].splitlines()
        log(f"[rewrite] (c) {cli} {name.split(' ', 1)[1]}: world 2 "
            f"(torchrun, gloo on the one card) report equal to world 1's: "
            f"{same} ({len(lines)} lines, last {lines[-1]!r}); K6 launches "
            f"per rank {got} (want {want}); world 1 {ref['seconds']:.1f} s, "
            f"world 2 {ranks[0][name]['seconds']:.1f} s ({card})")
    log(f"[rewrite] (c) torchrun --nproc_per_node 2, {len(runs)} runs: "
        f"{seconds:.1f} s "
        f"with the processes' start; files rank 1 opened for writing: "
        f"{ranks[1]['writes']}")
    # the r3d-18, i3d and slowfast_fb runs: each checkpoint and
    # calibration, its world-1 test and its world-2 tests on rank 0; the
    # conv head's steps
    seconds = {}
    for tag in ("r3d-18", "i3d", "slowfast_fb"):
        names = [n for n in runs if f" {tag}" in n]
        seconds[f"test {tag}"] = round(t_new[tag] + sum(
            one[n]["seconds"] for n in names if n in one) + sum(
            ranks[0][n]["seconds"] for n in names), 1)
    seconds["conv head"] = round(t_new["conv head"] + ranks[0][
        FT_HEAD_RUN]["ms"] / 1e3, 1)
    log(f"[rewrite] (c) seconds of the r3d-18, i3d and slowfast_fb runs and "
        f"the conv head's steps (world 1 and rank 0's): {seconds}")
    if not ok:
        raise SystemExit("[rewrite] a world-2 test or retrieval report "
                         "differs from world 1's, rank 1 wrote a file, a "
                         "rank launched K6 for other videos, or the conv "
                         "head's step on (1, 2) disagrees with world 1's")
    return seconds


def phase_rewrites(dev, card: str, slice_ms: float):
    """Phase 22: the rewrite flags and the evaluation loops over ranks. (a)
    K2/K3 at the --mid_round 128 site shapes; (b) one step each of
    REWRITE_RUNS against its plain step; (c) main_test and main_retrieval
    at world 2 against world 1 (with I3D's conv head step on (1, 2)); (d)
    the s3d --s2d_stem pretrain step with K5. Returns the main-path
    launches and the seconds of (c)'s r3d-18 and i3d runs."""
    t_phase = time.perf_counter()
    counts = {k: 0 for k in _per_step(0, 0, 0)}
    _mid_round_sites(dev)
    _rewrite_steps(dev, card, slice_ms, counts)
    seconds = _eval_ranks(dev, card, counts)
    _s3d_s2d_step(dev, card, counts)
    log(f"[rewrite] phase {time.perf_counter() - t_phase:.1f} s")
    return counts, seconds


def kernels_line(conv, aug_err, aug_t, counts, k6, store):
    """The ``{"kernels": [...]}`` record. K2/K3 times and bounds are per
    pretrain step (its 10 launches at the four sites) and K5's its one
    launch, with launches from the slice phase plus phase 16's main-path
    runs (K5 in the two SlowFast pretrain steps, K2/K3 in the
    ``--legacy_pace`` finetune step), phase 18's (the world-1 step and
    each gloo rank's kernel step) and phase 19's (K6 in the int8_static
    test run and the --quant int8 pretrain steps, K5 in those steps);
    K4a/K4b are one launch at the benchmark's default shape, with launches
    from its taps9 run and phase 21's ``--shard_spatial`` ranks (10 each a
    step, on the padded H shards, in its (a) and (e) runs, whose per-shape
    times are its lines); K6's numbers are one launch at the I3D 1x1x1 site
    at batch Q_EVAL_BS, where ``torch._int_mm`` computes the same product
    (``library_ms``), while its launches are R(2+1)D's, which has no
    stride-1 1x1x1 conv: that path's own per-shape times are phase 19
    (a)'s lines; phase 22 adds the launches of its rewrite steps (K2/K3 at
    the ``--mid_round`` widths, K5, K6 on the folded shapes) and of its
    world-2 ``int8_static`` ranks, phase 21 those of its int8 ranks ((g),
    (h), (k), (l), (p), (q), (u)) on their H shards. The storage epilogue's and K7's numbers are per
    pretrain step (their 24 launches each at the 12 sites of both towers,
    per-view B_VIEW; phase 20 (a)), with launches from phase 20's
    int8_store steps and CLI epoch and phase 21 (h)'s ranks (per-shard
    times on its lines). ``counts`` is None when no step ran."""
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
        # no Pallas call: the int8 lax.conv_general_dilated of --quant
        ("int8_conv", "cstp_tpu_torch/csrc/int8_conv.cu",
         "cstp_tpu/ops/quant.py:53", k6),
        # no Pallas call: the XLA fusion of --quant int8_store's chain
        ("int8_conv_store", "cstp_tpu_torch/csrc/int8_conv.cu",
         "cstp_tpu/ops/quant.py:187", store["store"]),
        ("int8_bn_relu", "cstp_tpu_torch/csrc/int8_store.cu",
         "cstp_tpu/ops/quant.py:187", store["k7"]),
    ]
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": None if counts is None else counts[name],
         "max_abs_err": r["err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound"],
         "bound_by": r["by"], "library_ms": r.get("library_ms")}
        for name, src, rep, r in rows]}


# the phases ``--phases`` runs alone: n -> fn(dev, card); a time of an
# earlier phase that they print beside theirs is nan
_NAN = float("nan")
ALONE = {
    12: lambda dev, card: phase_cli(dev, card, _NAN, _NAN),
    14: lambda dev, card: phase_families(dev, card, _NAN),
    19: lambda dev, card: phase_quant_serve(dev, card, _NAN),
    21: phase_model_axis,
    22: lambda dev, card: phase_rewrites(dev, card, _NAN),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel-vs-plain phase")
    ap.add_argument("--phases", type=int, nargs="+", metavar="N",
                    choices=sorted(ALONE),
                    help="build the kernels, then run only these phases "
                    "(those that need no earlier phase's result, another "
                    "phase's times printed as nan) and print their seconds; "
                    "no kernels line and no last line")
    ap.add_argument("--dp-rank", nargs=4, metavar=("RANK", "WORLD", "PORT",
                                                    "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--serve-check", nargs="+",
                    metavar="DATA OUT ART", help=argparse.SUPPRESS)
    ap.add_argument("--ma-rank", nargs=4, metavar=("RANK", "WORLD", "PORT",
                                                    "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--ma-torchrun", nargs=argparse.REMAINDER,
                    help=argparse.SUPPRESS)
    ap.add_argument("--eval-torchrun", metavar="SPEC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dp_rank:    # one rank of phase 18 (b), started by that phase
        r, w, port, out = args.dp_rank
        dp_rank(int(r), int(w), int(port), out)
        return 0
    if args.ma_rank:    # one rank of phase 21 (a)-(c), started by it
        r, w, port, out = args.ma_rank
        ma_rank(int(r), int(w), int(port), out)
        return 0
    if args.ma_torchrun is not None:   # a torchrun rank of phase 21 (d)
        from cstp_tpu_torch.cli import main_byol
        from cstp_tpu_torch.parallel import mesh

        # both ranks on card 0, so gloo: NCCL takes one rank per card
        mesh.maybe_initialize_distributed(device=torch.device("cuda", 0),
                                          backend="gloo")
        try:
            main_byol.main(args.ma_torchrun)
        finally:
            mesh.shutdown()
        return 0
    if args.eval_torchrun:  # a torchrun rank of phase 22 (c)
        eval_torchrun(args.eval_torchrun)
        return 0
    if args.serve_check:    # phase 19 (c)'s fresh serving process
        serve_check(*args.serve_check)
        return 0
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
    # the data layer's log lines (which reader and which JPEG decode path)
    data_log = logging.getLogger("cstp_tpu_torch.data")
    data_log.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[data] %(message)s"))
    data_log.addHandler(handler)
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[device] TF32 off for cuDNN convolutions and matmuls (comparisons "
        "in full f32)")
    t0 = time.perf_counter()
    summary = dict(seconds={}, step_ms={})
    ph = summary["seconds"]

    def timed(n, fn, *a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        ph[n] = round(time.perf_counter() - t, 1)
        return out

    reader_build = timed(1, phase_build)
    if args.phases:
        for n in args.phases:
            timed(n, ALONE[n], dev, card)
        summary["seconds"]["all"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({"summary": summary}, separators=(",", ":")),
              flush=True)
        return 0
    conv = timed(2, phase_conv21d, dev)
    aug_err, aug_t = timed("2 augment", phase_augment, dev)
    hashes = timed("2 hashes", phase_hashes, dev)
    summary["hashes"] = {k: h for k, (h, _) in hashes.items()}
    counts = None
    if args.kernels_only:
        k6 = _k6_sites(dev)[1]
        store = _store_sites(dev)
    else:
        sl = timed(3, phase_slice, dev, card)
        counts = dict(sl["counts"])
        summary["step_ms"]["slice"] = round(sl["step_ms"], 1)
        parity = timed(4, phase_parity, dev)
        summary["step_ms"].update({f"parity {n}": round(v, 1) for n, v in
                                   parity["step_ms"].items()})
        bench_counts = timed(5, phase_bench, dev)
        for k in ("conv21d_taps9_stats", "conv21d_taps9_fwd"):
            counts[k] = bench_counts[k]
        timed(6, phase_conv21d_paths, dev)
        ft = timed(7, phase_finetune, dev, card)
        timed(8, phase_eval, dev, ft["model"], ft["state"])
        del ft
        torch.cuda.empty_cache()
        timed(9, phase_finetune_parity, dev)
        timed(10, phase_grad_accum, dev, card)
        bench = timed(11, phase_bench_step, dev)
        summary["step_ms"].update({f"bench_step {n}": round(r["step_ms"], 1)
                                   for n, r in bench.items()})
        timed(12, phase_cli, dev, card, sl["step_ms"],
              bench["pretrain"]["step_ms"])
        flag_benches = timed(13, phase_flags, dev, card, sl["step_ms"])
        timed(14, phase_families, dev, card, sl["step_ms"])
        timed(15, phase_inception, dev, card, sl["step_ms"])
        for k, v in timed(16, phase_slowfast_legacy, dev, card,
                          sl["step_ms"]).items():
            counts[k] += v
        timed(17, phase_ingest, dev, card, sl["step_ms"], reader_build)
        for k, v in timed(18, phase_data_parallel, dev, card,
                          sl["step_ms"]).items():
            counts[k] += v
        quant, quant_counts = timed(19, phase_quant_serve, dev, card,
                                    sl["step_ms"])
        for k, v in quant_counts.items():
            counts[k] += v
        k6 = quant["i3d"]
        store, store_counts = timed(
            20, phase_store_chain, dev, card, sl["step_ms"],
            quant["int8_step_ms"], flag_benches)
        for k, v in store_counts.items():
            counts[k] += v
        ma_counts, ma = timed(21, phase_model_axis, dev, card)
        for k, v in ma_counts.items():
            counts[k] += v
        summary["model_axis"] = ma["cases"]
        summary["shards_ms_bound"] = {
            k: [round(ms, 3), round(b, 4), n]
            for k, (ms, b, n) in ma["shards"].items()}
        summary["families_k6"] = ma["families_k6"]
        summary["families_s"] = ma["new_s"]
        rw_counts, rw_seconds = timed(22, phase_rewrites, dev, card,
                                      sl["step_ms"])
        summary["families_s"].update(rw_seconds)
        for k, v in rw_counts.items():
            counts[k] += v
    line = kernels_line(conv, aug_err, aug_t, counts, k6, store)
    print(json.dumps(line), flush=True)
    log(card)
    summary["kernels_ms_bound"] = {
        r["name"]: [round(r["ms"], 3), round(r["bound_ms"], 4)]
        for r in line["kernels"]}
    summary["seconds"]["all"] = round(time.perf_counter() - t0, 1)
    # the run's key readings on one line, so a cut tail still carries them
    print(json.dumps({"summary": summary}, separators=(",", ":")),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
