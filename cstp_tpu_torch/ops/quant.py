"""int8 quantized forward convolutions (``--quant``): the CUDA kernel K6 and
its plain version.

The port of ``cstp_tpu/ops/quant.py`` (its dynamic/static int8 conv, the
calibration observation and the calibration guard; the s8 storage chain,
``int8_store``, is not ported yet). The scheme is the JAX package's:

* activations: one scale per tensor, ``sx = absmax(x) / 127 + 1e-12``
  (dynamic, recomputed per call) or a given static scale (``--quant
  int8_fixed``: 0.05; ``int8_static``: the site's calibrated ``act_scale``);
  ``xq = clip(round(x.f32 / sx), -127, 127)``, rounding half to even;
* weights: one scale per output channel, ``sw[c] = absmax(w[c]) / 127 +
  1e-12``;
* the conv of ``xq`` and ``wq`` accumulates exactly in int32 and is
  dequantized as ``acc.f32 * (sx * sw)`` (the scale product formed first),
  then cast to the output dtype.

The conv is the custom op ``cstp::int8_conv3d(xq, wq, scale, stride,
pad_lo, pad_hi, out_dtype)`` on NDHWC s8 activations and OIDHW s8 weights:
its CPU implementation is the plain version (``F.conv3d`` in float64 on the
integer values, exact for these sums, rounded to int32, then the same
epilogue), its CUDA implementation launches K6 (``csrc/int8_conv.cu``, an
implicit GEMM on the s8 tensor cores) or raises, and its fake
implementation gives the output's shape, so ``torch.export`` can put the
int8 conv into a serving program (``serve/export.py``). ``out_dtype``
``torch.int32`` returns the accumulator itself, for the checks.

The gradient is straight-through, as ``_int8_conv_bwd``: the bf16 conv's
input and weight gradients at the dequantized input ``x_hat = (xq * sx)``
in bf16 and ``w`` in bf16, none to the scale.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from cstp_tpu_torch.ops import build

EPS = 1e-12
QMAX = 127.0
FIXED_SCALE = 0.05          # --quant int8_fixed
STATIC_FLOOR = 1e-8         # --quant int8_static: max(act_scale, 1e-8)
QUANT_MODES = ("int8", "int8_fixed", "int8_static", "int8_calib")

# launches of K6 (one per call on CUDA tensors)
launches = 0

# output kinds of csrc/int8_conv.cu
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_KP = 32                    # the packed weights' K is a multiple of this


# ------------------------------------------------------------ quantize

def _true_div(a: torch.Tensor, v: float) -> torch.Tensor:
    """``a / v`` rounded once. On CUDA a Python scalar divisor becomes a
    product with its rounded reciprocal; a 0-d tensor on ``a``'s device
    keeps the true quotient, as JAX computes it."""
    return a / torch.full((), v, dtype=a.dtype, device=a.device)


def activation_absmax_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor symmetric int8 scale of ``x``: ``absmax / 127 +
    1e-12`` in float32 (0-d)."""
    return _true_div(x.float().abs().amax(), QMAX) + EPS


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x.f32 / scale), -127, 127)`` as int8; ``scale`` a 0-d
    float32 tensor or one broadcasting against ``x``."""
    return torch.clamp(torch.round(x.float() / scale), -QMAX,
                       QMAX).to(torch.int8)


def quantize_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: ``(xq, scale)``."""
    scale = activation_absmax_scale(x)
    return quantize_with_scale(x, scale), scale


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int8 over an OIDHW (or any out-first)
    weight: ``(wq, (Cout,) scales)``."""
    wf = w.float()
    scale = _true_div(wf.abs().amax(dim=tuple(range(1, wf.dim()))),
                      QMAX) + EPS
    bshape = (-1,) + (1,) * (wf.dim() - 1)
    return quantize_with_scale(wf, scale.reshape(bshape)), scale


# ------------------------------------------------------------ plain version

def _pads(padding) -> Tuple[List[int], List[int]]:
    """Per-axis ``(lo, hi)`` pads (an int or a pair each) -> lo, hi lists."""
    pairs = [(p, p) if isinstance(p, int) else (int(p[0]), int(p[1]))
             for p in padding]
    return [lo for lo, _ in pairs], [hi for _, hi in pairs]


def out_shape(x_shape, w_shape, stride, pad_lo, pad_hi) -> Tuple[int, ...]:
    """(N, To, Ho, Wo, Cout) of x (N, T, H, W, Cin) and w (Cout, Cin, kt,
    kh, kw)."""
    n, *dims, _ = x_shape
    cout, _, *ks = w_shape
    sp = [(d + lo + hi - k) // s + 1
          for d, k, s, lo, hi in zip(dims, ks, stride, pad_lo, pad_hi)]
    return (n, *sp, cout)


def _check_args(xq, wq, scale, stride, pad_lo, pad_hi, out_dtype):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8_conv3d takes int8 xq and wq, got {xq.dtype} "
                         f"and {wq.dtype}")
    if xq.dim() != 5 or wq.dim() != 5 or xq.shape[-1] != wq.shape[1]:
        raise ValueError(f"int8_conv3d takes xq (N, T, H, W, Cin) and wq "
                         f"(Cout, Cin, kt, kh, kw); got {tuple(xq.shape)} "
                         f"and {tuple(wq.shape)}")
    if len(stride) != 3 or len(pad_lo) != 3 or len(pad_hi) != 3:
        raise ValueError("int8_conv3d takes 3 strides and 3 + 3 pads")
    if min(stride) < 1 or min(pad_lo) < 0 or min(pad_hi) < 0:
        raise ValueError(f"int8_conv3d: stride {stride}, pads {pad_lo} "
                         f"{pad_hi}")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"int8_conv3d out_dtype {out_dtype} not in "
                         f"{list(_OUT_KINDS)}")
    if out_dtype != torch.int32 and tuple(scale.shape) != (wq.shape[0],):
        raise ValueError(f"int8_conv3d: scale {tuple(scale.shape)}, expected "
                         f"({wq.shape[0]},)")
    if min(out_shape(xq.shape, wq.shape, stride, pad_lo, pad_hi)[1:4]) < 1:
        raise ValueError("int8_conv3d: the padded input is smaller than the "
                         "kernel")


def int8_conv3d_acc_plain(xq, wq, stride, pad_lo, pad_hi) -> torch.Tensor:
    """The exact int32 accumulator: ``F.conv3d`` in float64 on the integer
    values (every partial sum below 2^53), rounded to int32, contiguous
    NDHWC as K6 writes it (a later reduction over another memory order
    would sum in another order)."""
    lo, hi = pad_lo, pad_hi
    xd = F.pad(xq.double(), (0, 0, lo[2], hi[2], lo[1], hi[1], lo[0], hi[0]))
    acc = F.conv3d(xd.permute(0, 4, 1, 2, 3), wq.double(),
                   stride=tuple(stride))
    return acc.permute(0, 2, 3, 4, 1).round().to(torch.int32).contiguous()


def dequantize(acc: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """``acc.f32 * scale`` cast to ``out_dtype`` (K6's epilogue)."""
    return (acc.float() * scale.float()).to(out_dtype)


def int8_conv3d_plain(xq, wq, scale, stride, pad_lo, pad_hi,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of K6: the accumulator, then the epilogue
    (``out_dtype`` ``torch.int32``: the accumulator itself)."""
    _check_args(xq, wq, scale, stride, pad_lo, pad_hi, out_dtype)
    acc = int8_conv3d_acc_plain(xq, wq, stride, pad_lo, pad_hi)
    if out_dtype == torch.int32:
        return acc
    return dequantize(acc, scale, out_dtype)


# ------------------------------------------------------------ CUDA kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = ([_P] * 4 + [_I] * 20 + [_P], _I)


def _lib():
    return build.load("int8_conv", {"cstp_int8_conv3d": _SIG})


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """OIDHW s8 -> (Cout, Kp) s8: row c the kt*kh*kw*Cin weights in (dt,
    dh, dw, ci) order, then zeros up to a multiple of 32."""
    cout = wq.shape[0]
    w2 = wq.permute(0, 2, 3, 4, 1).reshape(cout, -1)
    kp = -(-w2.shape[1] // _KP) * _KP
    return F.pad(w2, (0, kp - w2.shape[1])).contiguous()


def int8_conv3d_cuda(xq, wq, scale, stride, pad_lo, pad_hi,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """K6 on CUDA tensors: the int8 conv of ``xq`` (N, T, H, W, Cin) and
    ``wq`` (Cout, Cin, kt, kh, kw), dequantized by ``scale`` (Cout,) f32
    into ``out_dtype`` (or the int32 accumulator)."""
    global launches
    _check_args(xq, wq, scale, stride, pad_lo, pad_hi, out_dtype)
    dev = xq.device
    if dev.type != "cuda" or wq.device != dev or scale.device != dev:
        raise ValueError(f"K6 takes CUDA tensors on one device, got "
                         f"{xq.device}, {wq.device}, {scale.device}")
    x = xq.contiguous()
    wp = pack_weight(wq)
    sc = scale.float().contiguous()
    shape = out_shape(x.shape, wq.shape, stride, pad_lo, pad_hi)
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    kt, kh, kw = wq.shape[2:]
    err = _lib().cstp_int8_conv3d(
        x.data_ptr(), wp.data_ptr(), sc.data_ptr(), out.data_ptr(),
        *x.shape, *shape[1:], kt, kh, kw, *stride, *pad_lo, wp.shape[1],
        _OUT_KINDS[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "cstp_int8_conv3d")
    launches += 1
    return out


# ------------------------------------------------------------ custom op

@torch.library.custom_op("cstp::int8_conv3d", mutates_args=(),
                         device_types="cpu")
def int8_conv3d(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                stride: List[int], pad_lo: List[int], pad_hi: List[int],
                out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 conv: the plain version on the CPU, K6 on CUDA (any other
    device raises)."""
    return int8_conv3d_plain(xq, wq, scale, stride, pad_lo, pad_hi,
                             out_dtype)


@int8_conv3d.register_kernel("cuda")
def _int8_conv3d_k6(xq, wq, scale, stride, pad_lo, pad_hi, out_dtype):
    return int8_conv3d_cuda(xq, wq, scale, stride, pad_lo, pad_hi, out_dtype)


@int8_conv3d.register_fake
def _int8_conv3d_fake(xq, wq, scale, stride, pad_lo, pad_hi, out_dtype):
    return xq.new_empty(out_shape(xq.shape, wq.shape, stride, pad_lo, pad_hi),
                        dtype=out_dtype)


# ------------------------------------------------------------ autograd

def _conv_ndhwc(x, w, stride, pad_lo, pad_hi):
    """Float conv of NDHWC ``x`` and OIDHW ``w`` with (lo, hi) pads."""
    lo, hi = pad_lo, pad_hi
    xp = F.pad(x, (0, 0, lo[2], hi[2], lo[1], hi[1], lo[0], hi[0]))
    y = F.conv3d(xp.permute(0, 4, 1, 2, 3), w, stride=tuple(stride))
    return y.permute(0, 2, 3, 4, 1)


def _int8_forward(x, w, act_scale, stride, pad_lo, pad_hi, out_dtype):
    """-> (out, xq, sx): quantize x (dynamic where ``act_scale`` is None),
    quantize w, the int8 conv dequantized by ``sx * sw``."""
    if act_scale is None:
        xq, sx = quantize_tensor(x)
    else:
        sx = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device)
        xq = quantize_with_scale(x, sx)
    wq, sw = quantize_weight(w)
    out = torch.ops.cstp.int8_conv3d(xq, wq, sx * sw, list(stride),
                                     list(pad_lo), list(pad_hi), out_dtype)
    return out, xq, sx


class _Int8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, act_scale, stride, pad_lo, pad_hi, out_dtype):
        out, xq, sx = _int8_forward(x, w, act_scale, stride, pad_lo, pad_hi,
                                    out_dtype)
        ctx.save_for_backward(xq, sx, w)
        ctx.x_dtype = x.dtype
        ctx.geometry = (stride, pad_lo, pad_hi)
        return out

    @staticmethod
    def backward(ctx, g):
        xq, sx, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        # the dequantized input: the point the forward evaluated
        xhat = (xq.float() * sx).to(torch.bfloat16).requires_grad_(need_x)
        wb = w.detach().to(torch.bfloat16).requires_grad_(need_w)
        with torch.enable_grad():
            out = _conv_ndhwc(xhat, wb, *ctx.geometry)
        wanted = [t for t, n in ((xhat, need_x), (wb, need_w)) if n]
        got = iter(torch.autograd.grad(out, wanted, g.to(torch.bfloat16)))
        dx = next(got).to(ctx.x_dtype) if need_x else None
        dw = next(got).to(w.dtype) if need_w else None
        return dx, dw, None, None, None, None, None


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
              padding: Sequence, out_dtype=torch.bfloat16,
              act_scale=None) -> torch.Tensor:
    """int8-quantized 3D convolution with a straight-through bf16 backward.

    ``x``: (N, T, H, W, Cin) float; ``w``: (Cout, Cin, kt, kh, kw) float;
    ``stride`` per axis; ``padding`` an int or a ``(lo, hi)`` pair per axis.
    ``act_scale``: None for the dynamic per-tensor scale, else the static
    scale (a float or a 0-d tensor, which gets no gradient). Returns
    ``out_dtype``."""
    pad_lo, pad_hi = _pads(padding)
    stride = [int(s) for s in stride]
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Int8Conv.apply(x, w, act_scale, stride, pad_lo, pad_hi,
                               out_dtype)
    return _int8_forward(x, w, act_scale, stride, pad_lo, pad_hi,
                         out_dtype)[0]


# ------------------------------------------------------------ guards

def iter_scales(tree, prefix: str = ""):
    """``(path, value)`` of every ``act_scale`` leaf of a nested dict (the
    JAX package's batch_stats) or a flat state dict (``...act_scale``)."""
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if k == "act_scale" or str(k).endswith(".act_scale"):
            yield path, v
        elif isinstance(v, dict):
            yield from iter_scales(v, path)


def check_int8_calibrated(tree, context: str) -> int:
    """Guard for ``--quant int8_static``: raise unless every conv site in
    ``tree`` (a model's state dict, or nested batch statistics) carries a
    calibrated (non-zero) ``act_scale``. A float checkpoint restored by
    name leaves ``act_scale`` at 0, and a ~0 static scale clips every
    activation to +/-127 and dequantizes to ~0: silently wrong logits. Call
    it right after the restore on the eval, test, retrieval and serve
    paths. Returns the number of calibrated sites."""
    zeros, n_sites = [], 0
    for path, v in iter_scales(tree):
        n_sites += 1
        if float(torch.as_tensor(v)) <= 0.0:
            zeros.append(path)
    if n_sites == 0:
        raise ValueError(
            f"--quant int8_static ({context}): no act_scale sites in "
            "batch_stats — this model family has no quantized conv sites; "
            "int8_static would be a silent float run. Use a supported "
            "backbone or drop --quant.")
    if zeros:
        raise ValueError(
            f"--quant int8_static ({context}): {len(zeros)}/{n_sites} conv "
            "sites have act_scale == 0 (uncalibrated — e.g. "
            f"{zeros[0]}). Run the calibration pass first:\n"
            "  python -m cstp_tpu_torch.serve.quantize --test_md_path CKPT "
            "--out_path CKPT_int8 ...\nthen pass --test_md_path CKPT_int8.")
    return n_sites
