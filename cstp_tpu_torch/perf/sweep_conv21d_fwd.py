"""Times K3 (``cstp_conv21d_fwd``) or K2 (``cstp_conv21d_stats``) under
every launch plan it takes, at the four (2+1)D sites of the R(2+1)D depth-1
pretrain step (N=32 clips, two BN groups), on one CUDA GPU:

    python -m cstp_tpu_torch.perf.sweep_conv21d_fwd [--sites conv2,conv5]
    python -m cstp_tpu_torch.perf.sweep_conv21d_fwd --pass stats
    python -m cstp_tpu_torch.perf.sweep_conv21d_fwd --tiling taps9 [...]

With ``--tiling taps9`` it does the same for K4b / K4a
(``cstp_conv21d_taps9_fwd`` / ``_stats``: the same kernels on the input
padded once) under the same plans.

For each site it prints every plan of ``fwd_plans`` (row tile P, cluster,
chunks, stages), fastest first, with its ms (CUDA events, 10 launches
after 2 warm-ups, taken twice) and the largest difference of its output
from that of ``plan_fwd``'s plan, which is 0: a plan changes how the work
is cut, not the sums. With ``--pass stats`` it does the same for every
plan of ``stats_plans`` (row tile P, mid chunk, stages, tiles per block)
against ``plan_stats``'s; there the difference of the mean and variance is
not 0 but a few f32 ulps, since a plan changes the order of the sums.
Without a card it exits with an error.

    python -m cstp_tpu_torch.perf.sweep_conv21d_fwd --hash [--tiling taps9]

prints instead, at each site, a SHA-256 of K3's output under ``plan_fwd``'s
plan, given the plain statistics (cuDNN, deterministic), and one of K2's
statistics under ``plan_stats``'s plan, on the inputs ``chip_smoke.py``
draws (generator seed 0, the same draws in the same order), so two builds
of K2 and K3 can be held to bitwise equal outputs; with ``--tiling taps9``
the same of K4b and K4a, which equal K3's and K2's where the two tilings
agree bitwise. It calls only the wrappers' default plans, so it also runs
against an older checkout of the package (``PYTHONPATH``).
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess

import torch

from cstp_tpu_torch.ops import conv21d as C

# (site, T, H=W, Cin, M, Cout), as chip_smoke.py's SITES
SITES = [("conv2", 16, 56, 64, 144, 64), ("conv3", 8, 28, 128, 288, 128),
         ("conv4", 4, 14, 256, 576, 256), ("conv5", 2, 7, 512, 1152, 512)]
N, GROUPS = 32, 2
# the kernel pair of each tiling: (pass B, pass A)
KERNELS = {"clip": ("K3", "K2"), "taps9": ("K4b", "K4a")}


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def _passes(tiling, x, ws2):
    """The tiling's kernel input and wrappers: (x or its padded copy, ws in
    the wrapper's shape, pass A, pass B)."""
    cin, m = x.shape[-1], ws2.shape[-1]
    if tiling == "taps9":
        return (C.pad_hw(x), ws2.reshape(3, 3, cin, m), C.run_stats_taps9,
                C.run_fwd_taps9)
    return x, ws2, C.run_stats, C.run_fwd


def sweep_site(site, t, hw, cin, m, cout, gen, tiling="clip"):
    """[(ms, ms, plan, max abs diff from plan_fwd's output)], fastest
    first."""
    dev = gen.device
    x = torch.randn((N, t, hw, hw, cin), generator=gen,
                    device=dev).to(torch.bfloat16)
    ws2 = (torch.randn((9 * cin, m), generator=gen, device=dev)
           * (9 * cin) ** -0.5).to(torch.bfloat16)
    wt = (torch.randn((3, m, cout), generator=gen, device=dev)
          * (3 * m) ** -0.5).to(torch.bfloat16)
    scale = 0.5 + torch.rand(m, generator=gen, device=dev)
    bias = 0.1 * torch.randn(m, generator=gen, device=dev)
    xk, wsk, stats, fwd = _passes(tiling, x, ws2)
    gm, gv = stats(xk, wsk, GROUPS)

    def run(plan=None):
        return fwd(xk, wsk, wt, gm, gv, scale, bias, GROUPS, plan=plan)

    ref = run()
    rows = []
    for plan in C.fwd_plans(N, t, hw, hw, cin, m, cout):
        diff = (run(plan).float() - ref.float()).abs().max().item()
        rows.append((*(_time_ms(lambda: run(plan)) for _ in range(2)),
                     plan, diff))
    return sorted(rows, key=lambda r: min(r[:2]))


def sweep_site_stats(t, hw, cin, m, gen, tiling="clip"):
    """[(ms, ms, plan, max abs diff from plan_stats's mean and variance)],
    fastest first."""
    dev = gen.device
    x = torch.randn((N, t, hw, hw, cin), generator=gen,
                    device=dev).to(torch.bfloat16)
    ws2 = (torch.randn((9 * cin, m), generator=gen, device=dev)
           * (9 * cin) ** -0.5).to(torch.bfloat16)
    xk, wsk, stats, _ = _passes(tiling, x, ws2)
    ref = torch.cat(stats(xk, wsk, GROUPS))
    rows = []
    for plan in C.stats_plans(N, t, hw, hw, cin, m, GROUPS):
        def run(plan=plan):
            return stats(xk, wsk, GROUPS, plan=plan)
        diff = (torch.cat(run()) - ref).abs().max().item()
        rows.append((*(_time_ms(run) for _ in range(2)), plan, diff))
    return sorted(rows, key=lambda r: min(r[:2]))


def _digest(*tensors):
    """SHA-256 prefix of the tensors' bytes (bf16 as int16)."""
    h = hashlib.sha256()
    for t in tensors:
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def hash_outputs(gen, tiling="clip"):
    """{site: (SHA-256 prefix of pass B's bf16 output given the plain
    statistics, of pass A's mean and variance, of the plain statistics)}
    of the tiling's kernels (K3, K2 or K4b, K4a), on chip_smoke.py's
    phase-2 inputs. cuDNN runs deterministic here (the plain statistics
    are a cuDNN conv) and its flags are restored on return."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        return _hash_sites(gen, tiling)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def _hash_sites(gen, tiling):
    dev = gen.device
    out = {}
    for site, t, hw, cin, m, cout in SITES:
        def rnd(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device=dev) * std
        x = rnd(N, t, hw, hw, cin).to(torch.bfloat16)
        ws = rnd(3, 3, cin, m, std=(9 * cin) ** -0.5)
        wt = rnd(3, m, cout, std=(3 * m) ** -0.5)
        scale = 0.5 + torch.rand(m, generator=gen, device=dev)
        bias = rnd(m, std=0.1)
        gm, gv = C.reference_stats(x, ws, GROUPS)
        xk, wsk, stats, fwd = _passes(
            tiling, x, ws.to(torch.bfloat16).reshape(9 * cin, m))
        y = fwd(xk, wsk, wt.to(torch.bfloat16), gm, gv, scale, bias, GROUPS)
        out[site] = (_digest(y), _digest(*stats(xk, wsk, GROUPS)),
                     _digest(gm, gv))
        del x, xk, y
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", default=",".join(s[0] for s in SITES),
                    help="comma-separated sites to sweep")
    ap.add_argument("--pass", dest="which", choices=("fwd", "stats"),
                    default="fwd", help="K3 (fwd) or K2 (stats)")
    ap.add_argument("--tiling", choices=("clip", "taps9"), default="clip",
                    help="K2/K3 (clip) or K4a/K4b (taps9, the same kernels "
                         "on the padded input)")
    ap.add_argument("--hash", action="store_true",
                    help="print hashes of pass B's output and pass A's "
                         "statistics per site instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_conv21d_fwd needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    k_fwd, k_stats = KERNELS[args.tiling]
    kernel = k_fwd if args.which == "fwd" else k_stats
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.hash:
        print(f"{k_fwd}/{k_stats} output hashes, N={N}, {GROUPS} BN groups, "
              f"on {card}")
        hashes = hash_outputs(gen, args.tiling)
        for site, (h_out, h_stats, h_plain) in hashes.items():
            print(f"{k_fwd} output sha256 {site}: {h_out} (its input "
                  f"statistics {h_plain}); {k_stats} statistics sha256 "
                  f"{site}: {h_stats}")
        return hashes
    print(f"{kernel} plan sweep, N={N}, {GROUPS} BN groups, on {card}")
    wanted = args.sites.split(",")
    out = {}
    for site, t, hw, cin, m, cout in SITES:
        if site not in wanted:
            continue
        if args.which == "stats":
            chosen = C.plan_stats(N, t, hw, hw, cin, m, GROUPS)
            out[site] = rows = sweep_site_stats(t, hw, cin, m, gen,
                                                args.tiling)
            print(f"== {site}: T={t} {hw}x{hw} {cin}->{m}")
            for ms0, ms1, p, diff in rows:
                mark = " <- plan_stats" if p == chosen else ""
                print(f"  {ms0:8.3f} {ms1:8.3f} ms  P {p['P']:3d} stages "
                      f"{p['stages']} chunk {p['bn']:4d} warp tile "
                      f"32x{8 * p['ni']}, "
                      f"{p['tpb']:4d} tiles per block, {p['blocks']:5d} "
                      f"blocks, model {C.stats_cost(p):7.1f} max diff "
                      f"{diff:.1e}{mark}")
            torch.cuda.empty_cache()
            continue
        chosen = C.plan_fwd(N, t, hw, hw, cin, m, cout)
        out[site] = rows = sweep_site(site, t, hw, cin, m, cout, gen,
                                      args.tiling)
        print(f"== {site}: T={t} {hw}x{hw} {cin}->{m}->{cout}")
        for ms0, ms1, p, diff in rows:
            mark = " <- plan_fwd" if p == chosen else ""
            print(f"  {ms0:8.3f} {ms1:8.3f} ms  cluster {p['cluster']} "
                  f"P {p['P']:3d} stages {p['stages']} blocks "
                  f"{p['blocks'] * p['cluster']:4d} chunks {p['bn']}/"
                  f"{p['bno']} warp tile 32x{8 * p['ni']} max diff "
                  f"{diff:.1e}{mark}")
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
