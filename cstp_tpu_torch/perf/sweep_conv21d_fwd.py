"""Times K3 (``cstp_conv21d_fwd``) or K2 (``cstp_conv21d_stats``) under
every launch plan it takes, at the four (2+1)D sites of the R(2+1)D depth-1
pretrain step (N=32 clips, two BN groups), on one CUDA GPU:

    python -m cstp_tpu_torch.perf.sweep_conv21d_fwd [--sites conv2,conv5]
    python -m cstp_tpu_torch.perf.sweep_conv21d_fwd --pass stats

For each site it prints every plan of ``fwd_plans`` (row tile P, cluster,
chunks, stages), fastest first, with its ms (CUDA events, 10 launches
after 2 warm-ups, taken twice) and the largest difference of its output
from that of ``plan_fwd``'s plan, which is 0: a plan changes how the work
is cut, not the sums. With ``--pass stats`` it does the same for every
plan of ``stats_plans`` (row tile P, mid chunk, stages, tiles per block)
against ``plan_stats``'s; there the difference of the mean and variance is
not 0 but a few f32 ulps, since a plan changes the order of the sums.
Without a card it exits with an error.

    python -m cstp_tpu_torch.perf.sweep_conv21d_fwd --hash

prints instead a SHA-256 of K3's output under ``plan_fwd``'s plan at each
site, on the inputs ``chip_smoke.py`` draws (generator seed 0, the same
draws in the same order) with the plain statistics (cuDNN, deterministic),
so two builds of K3 can be held to bitwise equal outputs.
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


def sweep_site(site, t, hw, cin, m, cout, gen):
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
    gm, gv = C.run_stats(x, ws2, GROUPS)

    def run(plan=None):
        return C.run_fwd(x, ws2, wt, gm, gv, scale, bias, GROUPS, plan=plan)

    ref = run()
    rows = []
    for plan in C.fwd_plans(N, t, hw, hw, cin, m, cout):
        diff = (run(plan).float() - ref.float()).abs().max().item()
        rows.append((*(_time_ms(lambda: run(plan)) for _ in range(2)),
                     plan, diff))
    return sorted(rows, key=lambda r: min(r[:2]))


def sweep_site_stats(t, hw, cin, m, gen):
    """[(ms, ms, plan, max abs diff from plan_stats's mean and variance)],
    fastest first."""
    dev = gen.device
    x = torch.randn((N, t, hw, hw, cin), generator=gen,
                    device=dev).to(torch.bfloat16)
    ws2 = (torch.randn((9 * cin, m), generator=gen, device=dev)
           * (9 * cin) ** -0.5).to(torch.bfloat16)
    ref = torch.cat(C.run_stats(x, ws2, GROUPS))
    rows = []
    for plan in C.stats_plans(N, t, hw, hw, cin, m, GROUPS):
        def run(plan=plan):
            return C.run_stats(x, ws2, GROUPS, plan=plan)
        diff = (torch.cat(run()) - ref).abs().max().item()
        rows.append((*(_time_ms(run) for _ in range(2)), plan, diff))
    return sorted(rows, key=lambda r: min(r[:2]))


def hash_fwd(gen):
    """{site: SHA-256 prefix of K3's bf16 output bytes}, on chip_smoke.py's
    phase-2 inputs."""
    dev = gen.device
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
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
        y = C.run_fwd(x, ws.to(torch.bfloat16).reshape(9 * cin, m),
                      wt.to(torch.bfloat16), gm, gv, scale, bias, GROUPS)
        digest = hashlib.sha256
        out[site] = (digest(y.view(torch.int16).cpu().numpy().tobytes())
                     .hexdigest()[:16],
                     digest(torch.cat([gm, gv]).cpu().numpy().tobytes())
                     .hexdigest()[:16])
        del x, y
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", default=",".join(s[0] for s in SITES),
                    help="comma-separated sites to sweep")
    ap.add_argument("--pass", dest="which", choices=("fwd", "stats"),
                    default="fwd", help="K3 (fwd) or K2 (stats)")
    ap.add_argument("--hash", action="store_true",
                    help="print a hash of K3's output per site instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_conv21d_fwd needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    kernel = "K3" if args.which == "fwd" else "K2"
    print(f"{kernel} plan sweep, N={N}, {GROUPS} BN groups, on {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.hash:
        hashes = hash_fwd(gen)
        for site, (h_out, h_stats) in hashes.items():
            print(f"K3 output sha256 {site}: {h_out} (its input statistics "
                  f"{h_stats})")
        return hashes
    wanted = args.sites.split(",")
    out = {}
    for site, t, hw, cin, m, cout in SITES:
        if site not in wanted:
            continue
        if args.which == "stats":
            chosen = C.plan_stats(N, t, hw, hw, cin, m, GROUPS)
            out[site] = rows = sweep_site_stats(t, hw, cin, m, gen)
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
        out[site] = rows = sweep_site(site, t, hw, cin, m, cout, gen)
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
