"""The port's fused clip augmentation (``cstp_tpu_torch/ops/augment.py``)
against the JAX package's Pallas kernel, run in interpret mode as
``tests/test_pallas_augment.py`` runs it.

Both sides get the same numpy parameters (the parameter seam: the two
packages' random streams differ). On the CPU the port runs the kernel's
plain version. The tolerance is the Pallas test's, 2e-2 on the normalised
views: float32 resampling summed in another order, and HSV round trips whose
hue sector can flip on values at a sector edge. The kernel itself is tested
on the card by tests/test_torch_port_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.ops.pallas.augment import fused_augment_clips as jax_fused
from cstp_tpu_torch.augment.pipeline import (
    apply_pretrain_aug,
    apply_pretrain_aug_fused,
)
from cstp_tpu_torch.augment.params import ClipAugParams
from cstp_tpu_torch.ops import augment as A

N, T, H0, W0, S = 3, 4, 64, 80, 48

def _inputs(seed, null=False, hue_sign=0.0):
    """uint8 frames, boxes inside the frame, rot90 labels and per-clip
    parameters (identity-valued when ``null``)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (N, T, H0, W0, 3)).astype(np.uint8)
    box = np.stack([rng.uniform(0, 10, N), rng.uniform(0, 8, N),
                    rng.uniform(30, 60, N), rng.uniform(30, 50, N)],
                   axis=1).astype(np.float32)
    rotk = rng.integers(0, 4, (N,)).astype(np.int32)
    flip = rng.integers(0, 2, (N,)).astype(bool)
    if null:
        p = (np.zeros(N, np.float32),
             np.tile(np.float32([1.0, 1.0, 1.0, 0.0]), (N, 1)),
             np.tile(np.eye(3, dtype=np.float32), (N, T, 1, 1)),
             np.zeros(N, np.float32), flip)
    else:
        hue = rng.uniform(-0.1, 0.1, N)
        if hue_sign:
            hue = hue_sign * np.abs(hue)
        gray = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (N, T))]
        p = (rng.uniform(-10, 10, N).astype(np.float32),
             np.stack([rng.uniform(0.6, 1.4, N), rng.uniform(0.6, 1.4, N),
                       rng.uniform(0.6, 1.4, N), hue],
                      axis=1).astype(np.float32),
             np.ascontiguousarray(np.broadcast_to(gray[:, :, None, :],
                                                  (N, T, 3, 3))),
             rng.uniform(0.1, 2.0, N).astype(np.float32), flip)
    return frames, box, rotk, p


def _both(frames, box, rotk, p, norm):
    want = np.asarray(jax_fused(
        *map(jnp.asarray, (frames, box, rotk, *p)), sample_size=S,
        norm_method=norm, out_dtype=jnp.float32, interpret=True))
    got = A.fused_augment_clips(
        *map(torch.from_numpy, (frames, box, rotk, *p)), sample_size=S,
        norm_method=norm, out_dtype=torch.float32)
    assert got.shape == (N, T, S, S, 3) and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("norm", ["tf", "imagenet"])
@pytest.mark.parametrize("null", [True, False])
def test_fused_augment_matches_jax_kernel(null, norm):
    got, want = _both(*_inputs(0, null), norm)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_negative_hue_shifts_match_jax_kernel():
    """Negative hue shifts wrap with a floor-mod (``% 1.0`` in JAX)."""
    frames, box, rotk, p = _inputs(1, hue_sign=-1.0)
    assert (p[1][:, 3] < 0).all()
    got, want = _both(frames, box, rotk, p, "tf")
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_fused_and_ops_programs_agree_on_sampled_params():
    """``pretrain_augment_batch_fused`` and ``pretrain_augment_batch`` apply
    the same sampled parameters: one fused call over the 2B clips and the
    ops path per view give the same views on the CPU (float32, same ops)."""
    f1, b1, r1, p1 = _inputs(4)
    f2, b2, r2, p2 = _inputs(5)
    t = lambda *a: [torch.from_numpy(x) for x in a]  # noqa: E731
    sampled = (*t(b1, b2), None, ClipAugParams(*t(*p1)),
               ClipAugParams(*t(*p2)))
    fused = apply_pretrain_aug_fused(*t(f1, f2, r1, r2), sampled,
                                     sample_size=S, out_dtype=torch.float32)
    plain = apply_pretrain_aug(*t(f1, f2, r1, r2), sampled, sample_size=S)
    for a, b in zip(fused, plain):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_wrapper_refuses_wide_downscales():
    """A box more than 2.75x the output size needs more resample taps than
    the kernel keeps per row; the wrapper says so instead of truncating."""
    frames = torch.zeros((1, 1, 400, 400, 3), dtype=torch.uint8)
    z = torch.zeros(1)
    with pytest.raises(ValueError, match="tap"):
        A._check_cuda_inputs(frames, torch.zeros(1, 4), z.int(), z,
                             torch.zeros(1, 4), torch.zeros(1, 1, 3, 3), z,
                             z.int(), 112)
