"""Fused CSTP clip augmentation: the CUDA kernel and its plain version.

``fused_augment_clips`` is the port of ``cstp_tpu/ops/pallas/augment.py``:
crop + bicubic resize -> rot90 -> 3-shear small rotation -> jitter -> gray
mix -> blur -> hflip -> normalize, one call for the batch. For CUDA tensors
it launches ``csrc/augment.cu`` (one block per clip frame, output in bf16,
f16 or f32; the frame in shared memory where it fits, else in a
device-memory scratch, ``launch_plan``) or raises; for CPU tensors it runs
:func:`fused_augment_clips_plain`, the same chain written with the ops of
``cstp_tpu_torch/augment/ops.py``.
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

# output dtypes of the kernel, by the code csrc/augment.cu takes
_OUT_TYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

# csrc/augment.cu's shared-memory formula, kept here so that a shape the
# kernel cannot take is refused before a launch
_MAX_SMEM = 232_448     # shared memory one block may use on sm_90
_WARPS = 16             # kThreads / 32
_BLUR_TAPS = 15         # 2 * kBlurRadius + 1
_CHUNKS = (16, 8, 4, 2, 1)
# device-memory frames of one launch, where the frame does not fit shared
# memory: the launches walk the clips in chunks whose frames fit this
SCRATCH_BYTES = 256 * 2 ** 20


def _a128(b: int) -> int:
    return (b + 127) & ~127


def frame_bytes(s: int) -> int:
    """One f32 frame [S][3S + 1] (csrc/augment.cu frame_bytes)."""
    return _a128(4 * s * (3 * s + 1))


def smem_bytes(s: int, w0: int, chunk: int, smem_frame: bool = True) -> int:
    """Dynamic shared memory of one block (csrc/augment.cu smem_bytes): the
    f32 frame where it is in shared memory, then the larger of the
    resample's buffers (per-row taps and normalisers, two stages of
    ``chunk`` uint8 source rows, ``chunk`` f32 rows of the horizontal pass,
    the vertical weights of the staged rows for each output row) and the
    later stages' (per-warp temp rows, block-sum slots, blur taps and
    reciprocals)."""
    pitch = ((3 * w0 + 15) & ~15) + 32
    resample = (_a128(6 * 4 * s) + _a128(2 * chunk * pitch)
                + _a128(4 * chunk * 3 * s) + _a128(4 * s * chunk))
    post = (_a128(4 * _WARPS * 3 * s) + _a128(4 * (_WARPS + 1))
            + _a128(4 * _BLUR_TAPS) + _a128(4 * s))
    return (frame_bytes(s) if smem_frame else 0) + max(resample, post)


def _fitting_chunk(s: int, w0: int, smem_frame: bool) -> int:
    return next((c for c in _CHUNKS
                 if smem_bytes(s, w0, c, smem_frame) <= _MAX_SMEM), 0)


def chunk_rows(s: int, w0: int, smem_frame: bool = True) -> int:
    """Source rows per copy stage (csrc/augment.cu chunk_rows): the largest
    of 16, 8, 4, 2, 1 whose buffers fit (beside the frame when
    ``smem_frame``). Raises ValueError when none does."""
    chunk = _fitting_chunk(s, w0, smem_frame)
    if not chunk:
        where = ("" if smem_frame
                 else " beside a frame in device memory")
        raise ValueError(
            f"fused_augment_clips: sample_size {s} with frames {w0} wide "
            f"needs {smem_bytes(s, w0, 1, smem_frame)} bytes of shared "
            f"memory per block{where}, more than the {_MAX_SMEM} one block "
            "may use")
    return chunk


def launch_plan(n: int, t: int, s: int, w0: int):
    """How the wrapper launches K5 for n clips of t frames w0 wide -> s:
    ``(chunk, per_launch)``. With the frame in shared memory wherever it
    fits (then ``per_launch`` is 0: one launch for every clip), else in a
    device-memory scratch of ``per_launch * t`` frames, one launch per
    ``per_launch`` clips, as many as ``SCRATCH_BYTES`` holds (at least
    one). Raises ValueError when even the buffers beside a device-memory
    frame do not fit."""
    chunk = _fitting_chunk(s, w0, True)
    if chunk:
        return chunk, 0
    chunk = chunk_rows(s, w0, smem_frame=False)
    return chunk, max(1, min(n, SCRATCH_BYTES // (t * frame_bytes(s))))


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
                       flip, sample_size, out_dtype=torch.bfloat16):
    """Checks what the kernel takes, before any CUDA call; returns the chunk
    height (source rows per copy stage) the kernel will choose, with the
    frame where ``launch_plan`` puts it."""
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"fused_augment_clips: the CUDA kernel writes "
                         f"{', '.join(map(str, _OUT_TYPES))}, not {out_dtype}")
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
    return launch_plan(n, t, sample_size, w0)[0]


def fused_augment_clips(frames, box, rotk, angle, factors, graymix, sigma,
                        flip, sample_size: int = 112, norm_method: str = "tf",
                        out_dtype=torch.bfloat16):
    """(N, T, H0, W0, 3) uint8 frames + per-clip params ->
    (N, T, S, S, 3) normalized views in ``out_dtype``. CUDA tensors run the
    kernel, which writes bf16, f16 or f32 (another dtype raises
    ``ValueError``); CPU tensors run the plain version."""
    global launches
    if frames.device.type != "cuda":
        return fused_augment_clips_plain(frames, box, rotk, angle, factors,
                                         graymix, sigma, flip, sample_size,
                                         norm_method, out_dtype)
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
                       flip, sample_size, out_dtype)
    n, t, h0, w0, _ = frames.shape
    _, per_launch = launch_plan(n, t, sample_size, w0)
    out = torch.empty((n, t, sample_size, sample_size, 3), dtype=out_dtype,
                      device=frames.device)
    scratch = None
    if per_launch:
        scratch = torch.empty(per_launch * t * frame_bytes(sample_size) // 4,
                              dtype=torch.float32, device=frames.device)
    lib = _lib()
    err = lib.cstp_augment_clips(
        frames.data_ptr(), box.data_ptr(), rotk.data_ptr(), angle.data_ptr(),
        factors.data_ptr(), graymix.data_ptr(), sigma.data_ptr(),
        flip.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), per_launch, n, t,
        h0, w0, sample_size,
        int(norm_method == "imagenet"), _OUT_TYPES[out_dtype],
        torch.cuda.current_stream(frames.device).cuda_stream)
    build.check(err, "cstp_augment_clips")
    launches += 1
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"cstp_augment_clips": ([_P] * 10 + [_I] * 8 + [_P], _I),
               "cstp_augment_chunk_rows": ([_I] * 3, _I),
               "cstp_augment_smem_bytes": ([_I] * 4, _I),
               "cstp_augment_frame_bytes": ([_I], ctypes.c_longlong)}


def _lib():
    return build.load("augment", _SIGNATURES)
