"""Fused CSTP clip augmentation: the CUDA kernel and its plain version.

``fused_augment_clips`` is the port of ``cstp_tpu/ops/pallas/augment.py``:
crop + bicubic resize -> rot90 -> 3-shear small rotation -> jitter -> gray
mix -> blur -> hflip -> normalize, one call for the batch. For CUDA tensors
it launches ``csrc/augment.cu`` (one block per clip frame, bf16 output) or
raises; for CPU tensors it runs :func:`fused_augment_clips_plain`, the same
chain written with the ops of ``cstp_tpu_torch/augment/ops.py``.
All randomness arrives as identity-when-off parameters
(``cstp_tpu_torch/augment/params.py``).
"""

from __future__ import annotations

import ctypes

import torch

from cstp_tpu_torch.augment import ops
from cstp_tpu_torch.augment.params import ClipAugParams
from cstp_tpu_torch.augment.pipeline import apply_clip_aug
from cstp_tpu_torch.ops import build

# launches of the CUDA kernel (one per call on CUDA tensors)
launches = 0

_MAX_TAPS = 16  # csrc/augment.cu kMaxTaps


def fused_augment_clips_plain(frames, box, rotk, angle, factors, graymix,
                              sigma, flip, sample_size: int = 112,
                              norm_method: str = "tf",
                              out_dtype=torch.bfloat16):
    """The plain PyTorch version of the kernel, on any device: the
    composition of ``tests/test_pallas_augment.py::_xla_reference``."""
    v = ops.crop_resize_clip(frames.to(torch.float32), box.float(),
                             sample_size)
    v = ops.rot90_clip(v, rotk)
    v = apply_clip_aug(v, ClipAugParams(angle.float(), factors.float(),
                                        graymix.float(), sigma.float(),
                                        flip.bool()))
    return ops.normalize_clip(v, norm_method).to(out_dtype)


def _check_cuda_inputs(frames, box, rotk, angle, factors, graymix, sigma,
                       flip, sample_size):
    n, t, h0, w0, c = frames.shape
    want = {
        "frames": (frames, torch.uint8, (n, t, h0, w0, 3)),
        "box": (box, torch.float32, (n, 4)),
        "rotk": (rotk, torch.int32, (n,)),
        "angle": (angle, torch.float32, (n,)),
        "factors": (factors, torch.float32, (n, 4)),
        "graymix": (graymix, torch.float32, (n, t, 3, 3)),
        "sigma": (sigma, torch.float32, (n,)),
        "flip": (flip, torch.int32, (n,)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.device != frames.device:
            raise ValueError(f"fused_augment_clips: {name} on {x.device}, "
                             f"frames on {frames.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"fused_augment_clips: {name} must be {dtype} "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"fused_augment_clips: {name} not contiguous")
    # boxes lie inside the frame (pretext/boxes.py), so a resample row has
    # at most floor(4 * max(1, size / S)) + 5 taps in its window
    fmax = max(1.0, max(h0, w0) / sample_size)
    if int(4 * fmax) + 5 > _MAX_TAPS:
        raise ValueError(f"fused_augment_clips: frames {h0}x{w0} downscale "
                         f"to {sample_size} beyond the kernel's "
                         f"{_MAX_TAPS}-tap resample rows")


def fused_augment_clips(frames, box, rotk, angle, factors, graymix, sigma,
                        flip, sample_size: int = 112, norm_method: str = "tf",
                        out_dtype=torch.bfloat16):
    """(N, T, H0, W0, 3) uint8 frames + per-clip params ->
    (N, T, S, S, 3) normalized views. CUDA tensors run the kernel, which
    writes bf16 only; CPU tensors run the plain version in ``out_dtype``."""
    global launches
    if frames.device.type != "cuda":
        return fused_augment_clips_plain(frames, box, rotk, angle, factors,
                                         graymix, sigma, flip, sample_size,
                                         norm_method, out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError("fused_augment_clips: the CUDA kernel writes bf16")
    if norm_method not in ("tf", "imagenet"):
        raise ValueError(f"unknown norm_method {norm_method!r}")
    box = box.float().contiguous()
    rotk = rotk.to(torch.int32).contiguous()
    angle = angle.float().contiguous()
    factors = factors.float().contiguous()
    graymix = graymix.float().contiguous()
    sigma = sigma.float().contiguous()
    flip = flip.to(torch.int32).contiguous()
    _check_cuda_inputs(frames, box, rotk, angle, factors, graymix, sigma,
                       flip, sample_size)
    n, t, h0, w0, _ = frames.shape
    out = torch.empty((n, t, sample_size, sample_size, 3),
                      dtype=torch.bfloat16, device=frames.device)
    lib = _lib()
    err = lib.cstp_augment_clips(
        frames.data_ptr(), box.data_ptr(), rotk.data_ptr(), angle.data_ptr(),
        factors.data_ptr(), graymix.data_ptr(), sigma.data_ptr(),
        flip.data_ptr(), out.data_ptr(), n, t, h0, w0, sample_size,
        int(norm_method == "imagenet"),
        torch.cuda.current_stream(frames.device).cuda_stream)
    build.check(err, "cstp_augment_clips")
    launches += 1
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"cstp_augment_clips": ([_P] * 9 + [_I] * 6 + [_P], _I)}


def _lib():
    return build.load("augment", _SIGNATURES)
