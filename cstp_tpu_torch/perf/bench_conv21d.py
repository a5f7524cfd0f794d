"""Standalone benchmark: the fused (2+1)D conv block against its plain chain.

The port of ``perf/bench_conv21d.py``, at the same default shapes: the
layer-1 site of the flagship pretrain step at per-view batch 64 (two views
concatenated: 128 clips of 16 x 56 x 56 x 64, mid 144, two BN groups). It
runs on the card unless ``--device cpu`` is given:

    python -m cstp_tpu_torch.perf.bench_conv21d [--b 128] [--t 16] [--hw 56]
        [--cin 64] [--mid 144] [--cout 64] [--groups 2] [--iters 10]
        [--mode fwd|grad|both] [--tiling clip|taps9] [--device cuda|cpu]

It times four variants, each over ``--iters`` calls after one warm-up call,
with CUDA events on the card (the host clock on the CPU): the plain chain's
forward, the fused forward with the chosen tiling, the plain gradient with
respect to ``ws`` and the fused gradient, which takes the default tiling as
the JAX entry does. ``main`` returns the times in ms and each variant's
kernel launches. On the card a failed build or launch raises.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from cstp_tpu_torch import resolve_device
from cstp_tpu_torch.ops import conv21d as C

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
VARIANTS = ("plain_fwd", "fused_fwd", "plain_grad", "fused_grad")


def make_inputs(b, t, hw, cin, mid, cout, dev, seed: int = 0):
    """x, ws, wt, scale, bias in float32 from one seeded generator, at the
    JAX entry's scales."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return (normal(b, t, hw, hw, cin) * 0.5, normal(3, 3, cin, mid) * 0.05,
            normal(3, mid, cout) * 0.05, normal(mid) * 0.3, normal(mid) * 0.1)


def device_line(dev) -> str:
    if dev.type != "cuda":
        return str(dev)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _time_ms(fn, dev, iters: int) -> float:
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=128)   # 2B concat views @ b=64
    ap.add_argument("--t", type=int, default=16)
    ap.add_argument("--hw", type=int, default=56)
    ap.add_argument("--cin", type=int, default=64)
    ap.add_argument("--mid", type=int, default=144)
    ap.add_argument("--cout", type=int, default=64)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mode", default="both", choices=["fwd", "grad", "both"])
    ap.add_argument("--tiling", default="clip", choices=list(C.TILINGS),
                    help="kernel pair of the fused forward: clip = K2/K3 "
                         "(the unpadded input); taps9 = K4a/K4b (the same "
                         "kernels on the input padded once)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card only cpu runs")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b, t, hw, g = args.b, args.t, args.hw, args.groups
    x, ws, wt, scale, bias = make_inputs(b, t, hw, args.cin, args.mid,
                                         args.cout, dev)

    def plain_fwd():
        gm, gv = C.reference_stats(x, ws, g)
        return C.reference_chain(x, ws, wt, scale, bias, gm, gv,
                                 g).float().sum()

    def fused_fwd():
        out, _, _ = C.fused_st_conv(x, ws, wt, scale, bias, g, 1e-5,
                                    args.tiling)
        return out.float().sum()

    def plain_grad():
        w = ws.detach().requires_grad_(True)
        out = C.reference_chain(x, w, wt, scale, bias,
                                *C.reference_stats(x, w, g), g)
        return torch.autograd.grad(out.float().square().sum(), w)[0].sum()

    def fused_grad():
        w = ws.detach().requires_grad_(True)
        out = C.fused_st_conv(x, w, wt, scale, bias, g)[0]
        return torch.autograd.grad(out.float().square().sum(), w)[0].sum()

    card = device_line(dev)
    print(f"shapes: x=({b},{t},{hw},{hw},{args.cin}) mid={args.mid} "
          f"cout={args.cout} groups={g} tiling={args.tiling} device={card}",
          flush=True)
    fns = dict(plain_fwd=plain_fwd, fused_fwd=fused_fwd,
               plain_grad=plain_grad, fused_grad=fused_grad)
    names = {"fwd": VARIANTS[:2], "grad": VARIANTS[2:],
             "both": VARIANTS}[args.mode]
    results = {"tiling": args.tiling, "device": card, "launches": {}}
    for name in names:
        before = dict(C.launches)
        results[name] = _time_ms(fns[name], dev, args.iters)
        results["launches"][name] = {k: v - before[k]
                                     for k, v in C.launches.items()}
        label = f"fused/{args.tiling}" if name == "fused_fwd" else name
        print(f"{label:12s} {results[name]:9.3f} ms", flush=True)
    if args.mode in ("fwd", "both"):
        print(f"fwd speedup: {results['plain_fwd'] / results['fused_fwd']:.3f}x")
    if args.mode in ("fwd", "both") and dev.type == "cuda":
        # useful contraction FLOPs, as the JAX entry counts them: the plain
        # chain runs the spatial conv once, the fused forward twice (pass A
        # and pass B)
        sp = 2 * b * t * hw * hw * (9 * args.cin) * args.mid
        tc = 2 * b * t * hw * hw * args.mid * args.cout * 3
        for name, flops in (("plain_fwd", sp + tc), ("fused_fwd", 2 * sp + tc)):
            tf = flops / (results[name] * 1e-3) / 1e12
            print(f"  {name}: {tf:.1f} TFLOP/s = {tf * 1e12 / PEAK_BF16:.1%} "
                  f"of the H100 SXM dense bf16 peak ({flops / 1e9:.1f} GFLOP)")
    if args.mode in ("grad", "both"):
        print(f"grad speedup: "
              f"{results['plain_grad'] / results['fused_grad']:.3f}x")
    return results


if __name__ == "__main__":
    main()
