"""Times K3 (``cstp_conv21d_fwd``) under every launch plan it takes, at the
four (2+1)D sites of the R(2+1)D depth-1 pretrain step (N=32 clips, two BN
groups), on one CUDA GPU:

    python -m cstp_tpu_torch.perf.sweep_conv21d_fwd [--sites conv2,conv5]

For each site it prints every plan of ``fwd_plans`` (row tile P, cluster,
chunks, stages), fastest first, with its ms (CUDA events, 10 launches
after 2 warm-ups, taken twice) and the largest difference of its output
from that of ``plan_fwd``'s plan, which is 0: a plan changes how the work
is cut, not the sums. Without a card it exits with an error.
"""

from __future__ import annotations

import argparse
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", default=",".join(s[0] for s in SITES),
                    help="comma-separated sites to sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_conv21d_fwd needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"K3 plan sweep, N={N}, {GROUPS} BN groups, on {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    wanted = args.sites.split(",")
    out = {}
    for site, t, hw, cin, m, cout in SITES:
        if site not in wanted:
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
