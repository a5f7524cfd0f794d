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


@pytest.mark.parametrize("shape", [(8, 16, 56, 64, 144, 64),
                                   (8, 8, 28, 128, 288, 128),
                                   (8, 2, 7, 512, 1152, 512)])
def test_conv21d_kernels_match_plain_version(dev, shape):
    """K2 and K3 at main-path site shapes, bf16, two BN groups. Tolerances
    as tests/test_conv21d.py: the spatial conv's bf16 rounding can differ by
    an ulp with the summation order."""
    n, t, hw, cin, m, cout = shape
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(n, t, hw, hw, cin)), dev, torch.bfloat16)
    ws = _t(rng.normal(size=(3, 3, cin, m)) * (9 * cin) ** -0.5, dev,
            torch.float32)
    wt = _t(rng.normal(size=(3, m, cout)) * (3 * m) ** -0.5, dev,
            torch.float32)
    scale = _t(rng.uniform(0.5, 1.5, m), dev, torch.float32)
    bias = _t(rng.normal(size=m) * 0.1, dev, torch.float32)
    before = dict(C.launches)
    out, gm, gv = C.fused_st_conv(x, ws, wt, scale, bias, 2)
    assert C.launches == {"stats": before["stats"] + 1,
                          "fwd": before["fwd"] + 1}
    pm, pv = C.reference_stats(x, ws, 2)
    pout = C.reference_chain(x, ws, wt, scale, bias, gm, gv, 2)
    torch.testing.assert_close(gm, pm, rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(gv, pv, rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(out.float(), pout.float(), rtol=0.1,
                               atol=0.05)


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
