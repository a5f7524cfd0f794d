"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; every test skips without a CUDA GPU. This file imports no
JAX, so it also runs on a machine that has PyTorch only:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from cstp_tpu_torch.ops import augment as A
from cstp_tpu_torch.ops import conv21d as C

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def _conv_inputs(dev, rng, n, t, hw, cin, m, cout):
    x = _t(rng.normal(size=(n, t, hw, hw, cin)), dev, torch.bfloat16)
    ws = _t(rng.normal(size=(3, 3, cin, m)) * (9 * cin) ** -0.5, dev,
            torch.float32)
    wt = _t(rng.normal(size=(3, m, cout)) * (3 * m) ** -0.5, dev,
            torch.float32)
    scale = _t(rng.uniform(0.5, 1.5, m), dev, torch.float32)
    bias = _t(rng.normal(size=m) * 0.1, dev, torch.float32)
    return x, ws, wt, scale, bias


def _check_fused(tiling, x, ws, wt, scale, bias):
    """One fused forward launches the tiling's pair once each (and no other
    kernel) and matches the plain version. Tolerances as
    tests/test_conv21d.py: the spatial conv's bf16 rounding can differ by an
    ulp with the summation order."""
    keys = {"clip": ("stats", "fwd"),
            "taps9": ("stats_taps9", "fwd_taps9")}[tiling]
    before = dict(C.launches)
    out, gm, gv = C.fused_st_conv(x, ws, wt, scale, bias, 2, 1e-5, tiling)
    assert {k: C.launches[k] - before[k] for k in C.launches} == {
        k: int(k in keys) for k in C.launches}
    pm, pv = C.reference_stats(x, ws, 2)
    pout = C.reference_chain(x, ws, wt, scale, bias, gm, gv, 2)
    torch.testing.assert_close(gm, pm, rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(gv, pv, rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(out.float(), pout.float(), rtol=0.1,
                               atol=0.05)


@pytest.mark.parametrize("tiling", ["clip", "taps9"])
@pytest.mark.parametrize("shape", [(8, 16, 56, 64, 144, 64),
                                   (8, 8, 28, 128, 288, 128),
                                   (8, 2, 7, 512, 1152, 512)])
def test_conv21d_kernels_match_plain_version(dev, shape, tiling):
    """K2/K3 ("clip") and K4a/K4b ("taps9") at main-path site shapes, bf16,
    two BN groups."""
    rng = np.random.default_rng(0)
    _check_fused(tiling, *_conv_inputs(dev, rng, *shape))


@pytest.mark.parametrize("shape", [(4, 1, 5, 32, 16, 16),
                                   (2, 3, 9, 16, 48, 32),
                                   (2, 2, 3, 16, 16, 16)])
def test_conv21d_taps9_edge_shapes(dev, shape):
    """K4a/K4b where a frame is smaller than a pixel tile, a tile crosses
    image rows, and T = 1 leaves only the centre temporal tap."""
    rng = np.random.default_rng(3)
    _check_fused("taps9", *_conv_inputs(dev, rng, *shape))


@pytest.mark.parametrize("shape", [
    (2, 3, 7, 32, 16, 16),      # a tile spans both clips, of two BN groups
    (2, 1, 5, 32, 16, 16),      # T = 1: the centre temporal tap only; a
                                # frame smaller than a tile
    (4, 2, 6, 32, 48, 32),      # T = 2: a ring of two mid frames
    (2, 3, 7, 32, 560, 16),     # ragged last tile, three mid chunks, the
                                # last one ragged
    (2, 3, 14, 32, 288, 32),    # a cluster of 2 blocks per row tile, ragged
                                # last tile
    (4, 4, 14, 256, 576, 256),  # a cluster of 4 at conv4's widths
])
def test_conv21d_fwd_edge_shapes(dev, shape):
    """K3 where a tile spans two clips of different BN groups, a frame is
    smaller than a tile, T is 1 or 2, the last tile and the last mid chunk
    are ragged, and a row tile is split over a cluster of 2 or 4 blocks."""
    rng = np.random.default_rng(4)
    _check_fused("clip", *_conv_inputs(dev, rng, *shape))


def test_conv21d_fwd_plan_fills_each_sm_once(dev):
    """The plan's shared memory leaves one resident K3 block per SM at the
    conv2 site (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    plan = C.plan_fwd(32, 16, 56, 56, 64, 144, 64)
    assert C.fwd_occupancy(plan) == 1


@pytest.mark.parametrize("shape", [
    (2, 1, 7, 32, 16, 1),       # 7x7, T = 1, one group, M = 16, Cin = 32
    (4, 2, 14, 32, 48, 2),      # 14x14, T = 2, two groups
    (8, 1, 5, 32, 1152, 4),     # four groups of 50 rows: each ends mid-tile;
                                # M = 1152 in several chunks
    (4, 2, 7, 512, 1152, 2),    # conv5's widths
    (4, 3, 9, 64, 144, 4),      # conv2's widths, four groups of 243 rows
])
def test_conv21d_stats_edge_shapes(dev, shape):
    """K2 under every plan of stats_plans (row tiles of 32 to 128 rows,
    every chunk width, 3 or 4 stages) against the plain statistics, where
    frames are smaller than a tile, T is 1 or 2, groups are 1, 2 or 4 and
    end inside a tile, and M is 16 or 1152. Tolerances as chip_smoke.py."""
    n, t, hw, cin, m, groups = shape
    rng = np.random.default_rng(5)
    x, ws = _conv_inputs(dev, rng, n, t, hw, cin, m, 16)[:2]
    ws2 = ws.to(torch.bfloat16).reshape(9 * cin, m)
    pm, pv = C.reference_stats(x, ws, groups)
    for plan in C.stats_plans(n, t, hw, hw, cin, m, groups):
        before = C.launches["stats"]
        gm, gv = C.run_stats(x, ws2, groups, plan=plan)
        assert C.launches["stats"] == before + 1
        torch.testing.assert_close(gm, pm, rtol=1e-2, atol=1e-3)
        torch.testing.assert_close(gv, pv, rtol=1e-2, atol=1e-3)


def test_conv21d_stats_is_bitwise_deterministic(dev):
    """Two launches of K2 give bitwise the same statistics: a fixed order of
    sums throughout, no float atomics."""
    rng = np.random.default_rng(6)
    x, ws = _conv_inputs(dev, rng, 8, 4, 28, 128, 288, 16)[:2]
    ws2 = ws.to(torch.bfloat16).reshape(9 * 128, 288)
    first = C.run_stats(x, ws2, 2)
    for _ in range(3):
        again = C.run_stats(x, ws2, 2)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_conv21d_stats_plan_has_its_resident_blocks(dev):
    """At the pretrain step's four sites, K2's plan has the resident blocks
    per SM it assumes (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    for t, hw, cin, m in ((16, 56, 64, 144), (8, 28, 128, 288),
                          (4, 14, 256, 576), (2, 7, 512, 1152)):
        plan = C.plan_stats(32, t, hw, hw, cin, m, 2)
        assert C.stats_occupancy(plan) == C.STATS_PER_SM == 2


def test_conv21d_backward_runs_on_the_card(dev):
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(4, 4, 8, 8, 32)), dev,
           torch.bfloat16).requires_grad_(True)
    ws = _t(rng.normal(size=(3, 3, 32, 16)) * 0.1, dev,
            torch.float32).requires_grad_(True)
    wt = _t(rng.normal(size=(3, 16, 16)) * 0.1, dev, torch.float32)
    scale, bias = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    out, _, _ = C.fused_st_conv(x, ws, wt, scale, bias, 2)
    gx, gws = torch.autograd.grad(out.float().square().sum(), [x, ws])
    assert gx.dtype == torch.bfloat16 and gws.dtype == torch.float32
    assert torch.isfinite(gx.float()).all() and torch.isfinite(gws).all()


@pytest.mark.parametrize("null", [True, False])
def test_augment_kernel_matches_plain_version(dev, null):
    """K5 at 16 x 128 x 171 -> 112 frames, atol 2e-2 (the Pallas test's)."""
    n, t, h0, w0, s = 4, 16, 128, 171, 112
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (n, t, h0, w0, 3)).astype(np.uint8)
    box = np.stack([rng.uniform(0, 40, n), rng.uniform(0, 20, n),
                    rng.uniform(60, 130, n), rng.uniform(60, 105, n)], 1)
    rotk = rng.integers(0, 4, n)
    flip = rng.integers(0, 2, n).astype(bool)
    if null:
        angle, sigma = np.zeros(n), np.zeros(n)
        factors = np.tile([1.0, 1.0, 1.0, 0.0], (n, 1))
        graymix = np.tile(np.eye(3), (n, t, 1, 1))
    else:
        angle, sigma = rng.uniform(-10, 10, n), rng.uniform(0.1, 2.0, n)
        factors = np.stack([rng.uniform(0.6, 1.4, n), rng.uniform(0.6, 1.4, n),
                            rng.uniform(0.6, 1.4, n),
                            rng.uniform(-0.1, 0.1, n)], 1)
        gray = np.eye(3)[rng.integers(0, 3, (n, t))][:, :, None, :]
        graymix = np.broadcast_to(gray, (n, t, 3, 3))
    args = [_t(frames, dev), _t(box, dev, torch.float32),
            _t(rotk, dev, torch.int32), _t(angle, dev, torch.float32),
            _t(factors, dev, torch.float32), _t(graymix, dev, torch.float32),
            _t(sigma, dev, torch.float32), _t(flip, dev)]
    before = A.launches
    got = A.fused_augment_clips(*args, sample_size=s)
    assert A.launches == before + 1 and got.dtype == torch.bfloat16
    want = A.fused_augment_clips_plain(*args, sample_size=s,
                                       out_dtype=torch.float32)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=0)
