#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cstp_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel-vs-plain only

Phases:
  1. device and build: the card's name and power limit, then every CUDA
     kernel of the pretrain path built from ``cstp_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the pretrain step gives it, with times and roofline bounds;
  3. the pretrain step itself (R(2+1)D depth 1, 16 x 112^2, bf16, per-view
     batch 16, fused conv blocks and fused augmentation): one warm-up and
     three timed steps, with the kernels' launch counts, then one step
     under torch.profiler (device busy share, device time by kernel);
  4. one step from the same weights, generator and batch through the
     kernel configuration, the plain bf16 configuration (``fused_conv=0``,
     ``pallas_augment="off"``) and the plain float32 one, which arbitrates
     how far bf16 rounding alone moves the update; then each one's step
     time.
Then one JSON line describing the kernels, the card's name and power limit,
and a last JSON line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
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


def phase_conv21d(dev):
    """K2 (stats) and K3 (fwd) against the plain chain at the four sites."""
    from cstp_tpu_torch.ops import conv21d as C

    gen = torch.Generator(device=dev).manual_seed(0)
    n = 2 * B_VIEW
    # per kernel: times and bounds summed over one step's launches
    res = {k: dict(ms=0.0, plain_ms=0.0, bound=0.0, ops_ms=0.0, bytes_ms=0.0,
                   err=0.0) for k in ("stats", "fwd")}
    for site, t, hw, cin, m, cout, calls in SITES:
        def rnd(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device=dev) * std
        x = rnd(n, t, hw, hw, cin).to(torch.bfloat16)
        ws = rnd(3, 3, cin, m, std=(9 * cin) ** -0.5)
        wt = rnd(3, m, cout, std=(3 * m) ** -0.5)
        scale = 0.5 + torch.rand(m, generator=gen, device=dev)
        bias = rnd(m, std=0.1)
        xb = x.contiguous()
        ws2 = ws.to(torch.bfloat16).reshape(9 * cin, m).contiguous()
        wtb = wt.to(torch.bfloat16).contiguous()

        gm, gv = C.run_stats(xb, ws2, G)
        out = C.run_fwd(xb, ws2, wtb, gm, gv, scale, bias, G)
        pm, pv = C.reference_stats(x, ws, G)
        # pass B given the same statistics, so its check isolates pass B
        pout = C.reference_chain(x, ws, wt, scale, bias, gm, gv, G)
        torch.cuda.synchronize()
        e_stats = max((gm - pm).abs().max().item(), (gv - pv).abs().max().item())
        e_fwd = (out.float() - pout.float()).abs().max().item()
        # tolerances: bf16 rounding of the spatial conv differs with the
        # summation order (one bf16 ulp on some mid values), which moves the
        # statistics by a small fraction of an ulp and the bf16 output by a
        # few ulps (as tests/test_conv21d.py allows)
        ok_stats = (torch.allclose(gm, pm, rtol=1e-2, atol=1e-3)
                    and torch.allclose(gv, pv, rtol=1e-2, atol=1e-3))
        ok_fwd = torch.allclose(out.float(), pout.float(), rtol=0.1, atol=0.05)
        npix = n * t * hw * hw
        ops_s = 2.0 * npix * 9 * cin * m
        bytes_s = x.numel() * 2 + ws2.numel() * 2 + 2 * G * m * 4
        ops_f = ops_s + 2.0 * npix * 3 * m * cout
        bytes_f = (x.numel() * 2 + ws2.numel() * 2 + wtb.numel() * 2
                   + 2 * G * m * 4 + 2 * m * 4 + npix * cout * 2)
        ms_s = time_ms(lambda: C.run_stats(xb, ws2, G))
        ms_f = time_ms(lambda: C.run_fwd(xb, ws2, wtb, gm, gv, scale, bias, G))
        pms_s = time_ms(lambda: C.reference_stats(x, ws, G))
        pms_f = time_ms(lambda: C.reference_chain(x, ws, wt, scale, bias,
                                                  gm, gv, G))
        b_s, _ = bound_ms(ops_s, bytes_s, PEAK_BF16)
        b_f, _ = bound_ms(ops_f, bytes_f, PEAK_BF16)
        log(f"[conv21d] {site} N={n} T={t} {hw}x{hw} Cin={cin} M={m} "
            f"Cout={cout}: stats err {e_stats:.3e} (tol rtol 1e-2 atol 1e-3) "
            f"{ms_s:.3f} ms, plain {pms_s:.3f} ms, bound {b_s:.3f} ms | "
            f"fwd err {e_fwd:.3e} (tol rtol 0.1 atol 0.05) {ms_f:.3f} ms, "
            f"plain {pms_f:.3f} ms, bound {b_f:.3f} ms | library_ms null")
        if not (ok_stats and ok_fwd):
            raise SystemExit(f"conv21d kernel disagrees with its plain version"
                             f" at {site}")
        for key, ms, pms, ops, nb, err in (
                ("stats", ms_s, pms_s, ops_s, bytes_s, e_stats),
                ("fwd", ms_f, pms_f, ops_f, bytes_f, e_fwd)):
            r = res[key]
            per_step = TOWERS * calls
            r["ms"] += per_step * ms
            r["plain_ms"] += per_step * pms
            r["bound"] += per_step * bound_ms(ops, nb, PEAK_BF16)[0]
            r["ops_ms"] += per_step * ops / PEAK_BF16 * 1e3
            r["bytes_ms"] += per_step * nb / PEAK_BYTES * 1e3
            r["err"] = max(r["err"], err)
        del x, xb, out, pout
        torch.cuda.empty_cache()
    for r in res.values():
        r["by"] = "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes"
    return res


def _aug_inputs(dev, gen, null: bool):
    from cstp_tpu_torch.pretext.boxes import sample_pair_boxes

    n = 2 * B_VIEW
    frames = torch.randint(0, 256, (n, T, H0, W0, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    rot = torch.randint(0, 4, (n,), generator=gen, device=dev)
    box1, box2, _ = sample_pair_boxes(gen, rot[:B_VIEW], rot[B_VIEW:],
                                      float(W0), float(H0))
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
    cores): resize taps from the boxes, shears, blur, per-pixel jitter."""
    from cstp_tpu_torch.augment.ops import resample_weights

    ny = (resample_weights(H0, S, box[:, 1], box[:, 3]) != 0).sum(2).float()
    nx = (resample_weights(W0, S, box[:, 0], box[:, 2]) != 0).sum(2).float()
    # per output value: a multiply-add per (y tap, x tap) and per y tap
    resize = (2 * ny[:, :, None] * nx[:, None, :] + 2 * ny[:, :, None]).sum()
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


def phase_augment(dev):
    from cstp_tpu_torch.ops import augment as A

    gen = torch.Generator(device=dev).manual_seed(1)
    err_max = 0.0
    timing = None
    for null in (True, False):
        frames, box, rot, p = _aug_inputs(dev, gen, null)
        for norm in ("tf", "imagenet"):
            got = A.fused_augment_clips(frames, box, rot, *p, sample_size=S,
                                        norm_method=norm)
            want = A.fused_augment_clips_plain(frames, box, rot, *p,
                                               sample_size=S, norm_method=norm,
                                               out_dtype=torch.float32)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            # tolerance 2e-2 as tests/test_pallas_augment.py: f32 summation
            # order plus the kernel's bf16 output (half an ulp <= 7.8e-3
            # below |v| = 4)
            ok = err <= 2e-2 and got.shape == (2 * B_VIEW, T, S, S, 3)
            log(f"[augment] null={null} norm={norm}: max abs err {err:.3e} "
                f"(tol 2e-2)")
            if not ok:
                raise SystemExit("augment kernel disagrees with its plain "
                                 "version")
            err_max = max(err_max, err)
            if not null and norm == "tf":
                ms = time_ms(lambda: A.fused_augment_clips(
                    frames, box, rot, *p, sample_size=S))
                pms = time_ms(lambda: A.fused_augment_clips_plain(
                    frames, box, rot, *p, sample_size=S), iters=3, warmup=1)
                n_out = frames.shape[0] * T * S * S * 3
                nbytes = frames.numel() + n_out * 2 + frames.shape[0] * (T * 9 + 12) * 4
                ops = _aug_ops(box, p, n_out)
                b, by = bound_ms(ops, nbytes, PEAK_F32)
                log(f"[augment] N={frames.shape[0]} T={T} {H0}x{W0} -> {S}: "
                    f"{ms:.3f} ms, plain {pms:.3f} ms, bound {b:.4f} ms "
                    f"({by}) | library_ms null")
                timing = dict(ms=ms, plain_ms=pms, bound=b, by=by)
    return err_max, timing


def _slice_config(fused: bool):
    from cstp_tpu_torch.config import Config

    return Config(model_name="r21d", model_depth=1, sample_duration=T,
                  sample_size=S, batch_size=B_VIEW, compute_dtype="bfloat16",
                  fused_conv=int(fused),
                  pallas_augment="on" if fused else "off",
                  task="loss_com").finalize()


def _slice_batch(dev, seed: int):
    """uint8 frame pairs and pretext labels, as the data loader gives them
    (bench.py's synthetic batch: 16 x 128 x 171 frames)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def labels(k):
        return torch.randint(0, k, (B_VIEW,), generator=gen, device=dev)

    frames = [torch.randint(0, 256, (B_VIEW, T, H0, W0, 3), generator=gen,
                            device=dev, dtype=torch.uint8) for _ in range(2)]
    return dict(frames1=frames[0], frames2=frames[1], rot1=labels(4),
                rot2=labels(4), tem=labels(5), pb=labels(5))


def _launch_counts():
    from cstp_tpu_torch.ops import augment as A
    from cstp_tpu_torch.ops import conv21d as C

    return {"conv21d_stats": C.launches["stats"],
            "conv21d_fwd": C.launches["fwd"], "augment": A.launches}


def _reset_launch_counts():
    from cstp_tpu_torch.ops import augment as A
    from cstp_tpu_torch.ops import conv21d as C

    C.launches.update(stats=0, fwd=0)
    A.launches = 0


def phase_slice(dev, card: str, steps: int = 3):
    """The pretrain step through its entry points, kernels on."""
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
            "augment": steps}
    if counts != want:
        raise SystemExit(f"launch counts {counts}, expected {want}")
    if not bool(torch.isfinite(losses).all()) or moved <= 0.0:
        raise SystemExit("the pretrain step gave non-finite losses or left "
                         "the online parameters unchanged")
    profile_step(lambda: step(state, gen, batch, cfg.learning_rate))
    return dict(counts=counts, step_ms=dt * 1e3, pairs_per_s=B_VIEW / dt)


def profile_step(run, top: int = 12):
    """One more step under torch.profiler: the device's busy share of the
    step's wall time (union of kernel intervals) and device time by kernel.
    Profiling slows the host side, so the wall time here is not the step
    time above."""
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


def _slice_config_plain_f32():
    from cstp_tpu_torch.config import Config

    return Config(model_name="r21d", model_depth=1, sample_duration=T,
                  sample_size=S, batch_size=B_VIEW, compute_dtype="float32",
                  fused_conv=0, pallas_augment="off",
                  task="loss_com").finalize()


def phase_parity(dev, timed_steps: int = 2):
    """One step from the same weights, generator seed and batch through
    three configurations: the kernels (bf16, fused_conv=1,
    pallas_augment=on), the plain bf16 configuration (fused_conv=0,
    pallas_augment=off) and the plain configuration in float32, which
    arbitrates. Then the step time of each."""
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
        trainable,
    )

    batch = _slice_batch(dev, seed=4)
    runs = {}
    for name, cfg in (("kernel", _slice_config(True)),
                      ("plain", _slice_config(False)),
                      ("f32", _slice_config_plain_f32())):
        model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
        p0 = {n: p.detach().clone() for n, p in trainable(model).items()}
        step = make_pretrain_step(model, tx, cfg)
        gen = torch.Generator(device=dev).manual_seed(5)
        state, m = step(state, gen, batch, cfg.learning_rate)
        update = torch.cat([(p.detach() - p0[n]).flatten().double()
                            for n, p in trainable(model).items()])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            state, _ = step(state, gen, batch, cfg.learning_rate)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / timed_steps * 1e3
        runs[name] = ({k: float(v) for k, v in m.items()}, update, ms)
        del model, state, tx, step, p0
        torch.cuda.empty_cache()
    mk, mp, mf = (runs[n][0] for n in ("kernel", "plain", "f32"))

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(
            runs[a][1], runs[b][1], dim=0))

    cos_k, cos_p, cos_kp = cos("kernel", "f32"), cos("plain", "f32"), \
        cos("kernel", "plain")
    # Tolerances. Losses: both bf16 paths round the same values in another
    # summation order, so loss terms agree to a few bf16 ulps (2e-2
    # relative) and an accuracy may flip by two of 16 predictions. The
    # update: the gradient of this network is ill conditioned (BatchNorm
    # backward of pooled features cancels to a small residual), so bf16
    # rounding alone turns its direction; the kernel path must stay as
    # close to the float32 update as the plain bf16 path does (cosine
    # within 0.05 of it).
    loss_err = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-6)
                   for k in mk if k.startswith("loss"))
    acc_err = max(abs(mk[k] - mp[k]) for k in mk if k.startswith("acc"))
    log(f"[parity] kernel vs plain bf16 step: loss {mk['loss']:.5f} vs "
        f"{mp['loss']:.5f} (float32 {mf['loss']:.5f}); max rel loss-term err "
        f"{loss_err:.3e} (tol 2e-2); max accuracy diff {acc_err:.4f} "
        f"(tol 0.125); update cosine to the float32 update: kernel "
        f"{cos_k:.5f}, plain {cos_p:.5f} (tol kernel >= plain - 0.05); "
        f"kernel vs plain {cos_kp:.5f}")
    log(f"[parity] step ms ({timed_steps} steps after the first): kernel "
        f"{runs['kernel'][2]:.1f}, plain bf16 {runs['plain'][2]:.1f}, "
        f"plain float32 {runs['f32'][2]:.1f}")
    if not (loss_err <= 2e-2 and acc_err <= 0.125
            and cos_k >= cos_p - 0.05):
        raise SystemExit("the kernel step and the plain step disagree")
    return dict(loss_err=loss_err, acc_err=acc_err, cos_k=cos_k,
                cos_p=cos_p, step_ms={n: r[2] for n, r in runs.items()})


def kernels_line(conv, aug_err, aug_t, counts):
    """The ``{"kernels": [...]}`` record; times and bounds are per step
    (the 10 conv launches of one step, the one augment launch)."""
    pallas = "cstp_tpu/ops/pallas"
    rows = [
        ("conv21d_stats", "cstp_tpu_torch/csrc/conv21d.cu",
         f"{pallas}/conv21d.py:347", conv["stats"]),
        ("conv21d_fwd", "cstp_tpu_torch/csrc/conv21d.cu",
         f"{pallas}/conv21d.py:432", conv["fwd"]),
        ("augment", "cstp_tpu_torch/csrc/augment.cu",
         f"{pallas}/augment.py:244", dict(aug_t, err=aug_err)),
    ]
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": r["err"], "ms": r["ms"],
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
    if not args.kernels_only:
        sl = phase_slice(dev, card)
        phase_parity(dev)
        print(json.dumps(kernels_line(conv, aug_err, aug_t, sl["counts"])),
              flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
