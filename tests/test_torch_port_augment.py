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

from _torch_threads import torch_threads  # noqa: F401

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


@pytest.mark.parametrize("out_dtype", [torch.float16, torch.float32])
def test_out_dtype_matches_jax_kernel(out_dtype):
    """The port writes the ``out_dtype`` it is asked for (the plain version
    here, the kernel on the card) and holds the JAX kernel's float32 output:
    2e-2 as above, which also covers float16's rounding (half an ulp is
    <= 2e-3 below |v| = 4)."""
    frames, box, rotk, p = _inputs(6)
    want = np.asarray(jax_fused(
        *map(jnp.asarray, (frames, box, rotk, *p)), sample_size=S,
        norm_method="tf", out_dtype=jnp.float32, interpret=True))
    got = A.fused_augment_clips(
        *map(torch.from_numpy, (frames, box, rotk, *p)), sample_size=S,
        out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (N, T, S, S, 3)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


def _check_args(n, t, h0, w0):
    frames = torch.zeros((n, t, h0, w0, 3), dtype=torch.uint8)
    z = torch.zeros(n)
    return (frames, torch.zeros(n, 4), z.int(), z, torch.zeros(n, 4),
            torch.zeros(n, t, 3, 3), z, z.int())


@pytest.mark.parametrize("hw", [(400, 400), (336, 448), (256, 340)])
def test_wrapper_accepts_native_frames(hw):
    """Frames 3x or more the output size on their longer side (native
    256/320-short-side frames, about 17-21 taps per resample row) pass the
    kernel's checks: it has no tap cap; its chunk height fits."""
    chunk = A._check_cuda_inputs(*_check_args(1, 1, *hw), 112)
    assert chunk in (16, 8, 4, 2, 1)
    assert A.smem_bytes(112, hw[1], chunk) <= A._MAX_SMEM


@pytest.mark.parametrize("null", [True, False])
def test_wide_downscale_matches_jax_kernel(null):
    """A box over 4x the output size (120x150 frames -> S = 32, more than
    16 nonzero taps per resample row) through the port's plain path matches the JAX
    kernel at the Pallas test's 2e-2."""
    n, t, h0, w0, s = 2, 2, 120, 150, 32
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (n, t, h0, w0, 3)).astype(np.uint8)
    box = np.stack([rng.uniform(0, 5, n), rng.uniform(0, 5, n),
                    rng.uniform(140, 145, n), rng.uniform(110, 115, n)],
                   axis=1).astype(np.float32)
    rotk = rng.integers(0, 4, (n,)).astype(np.int32)
    flip = rng.integers(0, 2, (n,)).astype(bool)
    if null:
        p = (np.zeros(n, np.float32),
             np.tile(np.float32([1.0, 1.0, 1.0, 0.0]), (n, 1)),
             np.tile(np.eye(3, dtype=np.float32), (n, t, 1, 1)),
             np.zeros(n, np.float32), flip)
    else:
        p = (rng.uniform(-10, 10, n).astype(np.float32),
             np.float32([[1.2, 0.8, 1.1, 0.05], [0.7, 1.3, 0.9, -0.05]]),
             np.tile(np.eye(3, dtype=np.float32), (n, t, 1, 1)),
             rng.uniform(0.1, 2.0, n).astype(np.float32), flip)
    taps = (A.ops.resample_weights(w0, s, torch.from_numpy(box[:, 0]),
                                   torch.from_numpy(box[:, 2])) != 0).sum(2)
    assert int(taps.max()) > 16
    want = np.asarray(jax_fused(
        *map(jnp.asarray, (frames, box, rotk, *p)), sample_size=s,
        out_dtype=jnp.float32, interpret=True))
    got = A.fused_augment_clips(*map(torch.from_numpy, (frames, box, rotk,
                                                        *p)),
                                sample_size=s, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("case", ["sample_size", "out_dtype"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    """An S whose buffers do not fit one block's shared memory even with
    the frame in device memory (S = 1200: 16 warps' temp rows alone take
    230 KB), and an integer output dtype, raise ValueError in the
    wrapper's checks, which run before any CUDA call."""
    if case == "sample_size":
        with pytest.raises(ValueError,
                           match=r"sample_size 1200 .* bytes .* device"):
            A._check_cuda_inputs(*_check_args(1, 1, 256, 340), 1200)
    else:
        with pytest.raises(ValueError, match="torch.int32"):
            A._check_cuda_inputs(*_check_args(1, 1, 128, 171), 112,
                                 out_dtype=torch.int32)


def _smem_formula(s, w0, chunk, smem_frame):
    """csrc/augment.cu's shared-memory sum, written out: the f32 frame
    [S][3S + 1] where it is in shared memory, then the larger of the
    resample's buffers and the later stages' (16 warps), each 128-aligned."""
    a = lambda b: -(-b // 128) * 128  # noqa: E731
    pitch = -(-3 * w0 // 16) * 16 + 32
    resample = (a(24 * s) + a(2 * chunk * pitch) + a(12 * chunk * s)
                + a(4 * s * chunk))
    post = a(4 * 16 * 3 * s) + a(4 * 17) + a(4 * 15) + a(4 * s)
    return (a(4 * s * (3 * s + 1)) if smem_frame else 0) + max(resample,
                                                               post)


@pytest.mark.parametrize("s,w0", [(112, 171), (224, 340), (224, 171),
                                  (131, 171), (600, 1920)])
def test_smem_formula_with_the_frame_in_either_place(s, w0):
    """The Python copy of the kernel's shared-memory formula, with the frame
    in shared memory and outside it, and its chunk height: the largest of
    16..1 rows that fits 232,448 bytes."""
    for smem_frame in (True, False):
        for chunk in A._CHUNKS:
            assert A.smem_bytes(s, w0, chunk, smem_frame) == _smem_formula(
                s, w0, chunk, smem_frame)
        fits = [c for c in A._CHUNKS
                if _smem_formula(s, w0, c, smem_frame) <= 232448]
        if fits:
            assert A.chunk_rows(s, w0, smem_frame) == fits[0]
        else:
            with pytest.raises(ValueError, match=f"sample_size {s}"):
                A.chunk_rows(s, w0, smem_frame)
    assert A.frame_bytes(s) == _smem_formula(s, w0, 1, True) - \
        _smem_formula(s, w0, 1, False)


def test_wrapper_puts_a_frame_too_large_for_shared_memory_in_device_memory():
    """S = 224 from native 256x340 frames (I3D's sample size): the f32
    frame (603 KB) cannot be in shared memory, so the wrapper takes the
    device-memory frame, raises nothing, and walks the clips in launches
    whose frames fit SCRATCH_BYTES; S = 112 keeps its frame in shared
    memory and the chunk height it had."""
    n, t = 64, 16
    assert A._check_cuda_inputs(*_check_args(n, t, 256, 340), 224) == 16
    chunk, per_launch = A.launch_plan(n, t, 224, 340)
    assert A.smem_bytes(224, 340, 1, smem_frame=True) > A._MAX_SMEM
    assert chunk == A.chunk_rows(224, 340, smem_frame=False) == 16
    assert A.smem_bytes(224, 340, chunk, smem_frame=False) <= A._MAX_SMEM
    assert 1 <= per_launch < n
    assert per_launch * t * A.frame_bytes(224) <= A.SCRATCH_BYTES
    assert (per_launch + 1) * t * A.frame_bytes(224) > A.SCRATCH_BYTES
    assert A.launch_plan(2, t, 224, 340) == (16, 2)
    assert A.launch_plan(n, t, 112, 171) == (A.chunk_rows(112, 171), 0)
