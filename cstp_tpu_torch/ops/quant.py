"""int8 quantization (``--quant``): the int8 conv (the CUDA kernel K6), the
s8 storage chain (K6's storage epilogue and K7), and their plain versions.

The port of ``cstp_tpu/ops/quant.py``: its dynamic/static int8 conv, the
calibration observation, the calibration guard and the s8 storage chain
(``int8_store``, below). The int8 conv's scheme is the JAX package's:

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

The s8 storage chain (``--quant int8_store`` / ``int8_store_fz`` and the
``int8_store_calib`` bootstrap; ``cstp_tpu/ops/quant.py:139-339``) spans a
factorized (2+1)D block: quantize ``x`` at the delayed scale ``s_in`` ->
int8 spatial conv -> K6's storage epilogue (dequantize, absmax of the f32
mid ``h``, requantize to s8 at ``s_mid``, exact int64 sums of ``hq`` and
``hq^2`` per sample and channel) -> the grouped BatchNorm moments of ``hh =
hq * s_mid``, from those sums -> K7 (``csrc/int8_store.cu``: normalise,
affine, ReLU, requantize s8 -> s8 at ``s_act``) -> int8 temporal conv
(K6, dequantized into the input's dtype). The f32 mid never reaches device
memory on the card; the backward keeps only the three s8 tensors
(``xq``, ``hq``, ``yq``), the weights, ``gamma``, the ``(G, M)`` moments
and the scales, and is the JAX package's: the bf16 conv VJPs at the
dequantized stored inputs, the ReLU mask from the stored output, the
grouped-BN three-term gradient, none to the scales. The moments are a
function of the integer sums alone (summed in int64, formed in float64,
rounded once to f32), so the kernel and its plain version agree bitwise,
and so do one process and the ranks of ``--sync_bn 1``, whose sums are
all-reduced exactly; JAX's f32 mean over ``hh`` differs from them only by
its own rounding. ``float_store_chain`` is the same block in float (the
bootstrap, eval, and the reference of the tests).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cstp_tpu_torch.ops import build
from cstp_tpu_torch.ops.bn import (
    BN_EPS,
    group_mean,
    group_moments,
    per_sample,
)
from cstp_tpu_torch.parallel import mesh

EPS = 1e-12
QMAX = 127.0
FIXED_SCALE = 0.05          # --quant int8_fixed
STATIC_FLOOR = 1e-8         # --quant int8_static: max(act_scale, 1e-8)
# the per-conv modes (models/layers.py Conv3d)
QUANT_MODES = ("int8", "int8_fixed", "int8_static", "int8_calib")
# the s8 storage chain's modes (models/layers.py SpatioTemporalConv)
STORE_MODES = ("int8_store", "int8_store_fz", "int8_store_calib")
STORE_FLOOR = 1e-6          # the chain quantizes at max(act_scale_*, 1e-6)
STORE_DECAY = 0.999         # int8_store: scale = max(0.999 * scale, obs)

# launches of K6 (one per call on CUDA tensors): with a dequantizing
# epilogue (``launches``) and with the storage epilogue; and of K7
launches = 0
store_launches = 0
bnrelu_launches = 0

# output kinds of csrc/int8_conv.cu (3, the storage epilogue, is
# ``cstp_int8_conv3d_store``'s)
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_KP = 32                    # the packed weights' K is a multiple of this


# ------------------------------------------------------------ quantize

def _true_div(a: torch.Tensor, v: float) -> torch.Tensor:
    """``a / v`` rounded once. On CUDA a Python scalar divisor becomes a
    product with its rounded reciprocal; a 0-d tensor on ``a``'s device
    keeps the true quotient, as JAX computes it."""
    return a / torch.full((), v, dtype=a.dtype, device=a.device)


def activation_absmax_scale(x: torch.Tensor,
                            axis: Optional[str] = None) -> torch.Tensor:
    """The per-tensor symmetric int8 scale of ``x``: ``absmax / 127 +
    1e-12`` in float32 (0-d); with ``axis`` (``mesh.scale_axis``) the
    absmax is the maximum over the ranks that hold parts of the tensor,
    bitwise the one-process tensor's."""
    amax = x.float().abs().amax()
    if axis is not None:
        amax, = mesh.all_reduce_max(amax, axis=axis)
    return _true_div(amax, QMAX) + EPS


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x.f32 / scale), -127, 127)`` as int8; ``scale`` a 0-d
    float32 tensor or one broadcasting against ``x``."""
    return torch.clamp(torch.round(x.float() / scale), -QMAX,
                       QMAX).to(torch.int8)


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
_SIG_STORE = ([_P] * 8 + [_I] * 20 + [_P], _I)
_SIG_K7 = ([_P] * 9 + [ctypes.c_longlong] * 2 + [_I] * 2 + [_P], _I)


def _lib():
    return build.load("int8_conv", {"cstp_int8_conv3d": _SIG,
                                    "cstp_int8_conv3d_store": _SIG_STORE})


def _k7_lib():
    return build.load("int8_store", {"cstp_bn_relu_requant": _SIG_K7})


def _check_cuda(*tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"the kernel takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    return dev


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
    dev = _check_cuda(xq, wq, scale)
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


def int8_conv3d_store_cuda(xq, wq, scale, s_mid, stride, pad_lo, pad_hi,
                           observe: bool = True):
    """K6 with the storage epilogue on CUDA tensors: see
    :func:`int8_conv3d_store`."""
    global store_launches
    _check_args(xq, wq, scale, stride, pad_lo, pad_hi, torch.float32)
    dev = _check_cuda(xq, wq, scale, s_mid)
    x = xq.contiguous()
    wp = pack_weight(wq)
    sc = scale.float().contiguous()
    sm = s_mid.float().reshape(()).contiguous()
    shape = out_shape(x.shape, wq.shape, stride, pad_lo, pad_hi)
    hq = torch.empty(shape, dtype=torch.int8, device=dev)
    sums = torch.zeros((2, shape[0], shape[-1]), dtype=torch.int64,
                       device=dev)
    amax = torch.zeros((), dtype=torch.float32, device=dev)
    kt, kh, kw = wq.shape[2:]
    err = _lib().cstp_int8_conv3d_store(
        x.data_ptr(), wp.data_ptr(), sc.data_ptr(), sm.data_ptr(),
        hq.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
        amax.data_ptr(), *x.shape, *shape[1:], kt, kh, kw, *stride,
        *pad_lo, wp.shape[1], int(observe),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "cstp_int8_conv3d_store")
    store_launches += 1
    return hq, sums[0], sums[1], amax


def int8_conv3d_store_plain(xq, wq, scale, s_mid, stride, pad_lo, pad_hi,
                            observe: bool = True):
    """Plain version of K6's storage epilogue: the int8 conv dequantized to
    the f32 mid ``h = acc.f32 * scale``, then ``hq = clip(round(h /
    s_mid))`` as s8, its per-(sample, channel) int64 sums of ``hq`` and
    ``hq^2`` and the f32 ``max |h|`` (0 unless ``observe``)."""
    _check_args(xq, wq, scale, stride, pad_lo, pad_hi, torch.float32)
    h = dequantize(int8_conv3d_acc_plain(xq, wq, stride, pad_lo, pad_hi),
                   scale, torch.float32)
    amax = h.abs().amax() if observe else h.new_zeros(())
    hq = quantize_with_scale(h, s_mid)
    hl = hq.long()
    return hq, hl.sum((1, 2, 3)), hl.square().sum((1, 2, 3)), amax


def int8_conv3d_store(xq, wq, scale, s_mid, stride, pad_lo, pad_hi,
                      observe: bool = True):
    """The int8 conv of ``xq`` (N, T, H, W, Cin) and ``wq`` (Cout, Cin, kt,
    kh, kw) with the storage epilogue: ``(hq, sums, sq_sums, absmax)``,
    ``hq`` (N, To, Ho, Wo, Cout) s8 at the scale ``s_mid`` (0-d f32) of the
    mid ``acc.f32 * scale``, the (N, Cout) int64 sums of ``hq`` and of
    ``hq^2`` over each sample's positions, and the mid's f32 absmax (0
    unless ``observe``). K6 on CUDA tensors (or raises), the plain version
    on the CPU."""
    if xq.device.type == "cpu":
        return int8_conv3d_store_plain(xq, wq, scale, s_mid, stride, pad_lo,
                                       pad_hi, observe)
    return int8_conv3d_store_cuda(xq, wq, scale, s_mid, stride, pad_lo,
                                  pad_hi, observe)


def _bshape(x: torch.Tensor) -> Tuple[int, ...]:
    return (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)


def bn_relu_requant_plain(hq, s_mid, mean_b, inv_b, gamma, beta, s_act,
                          observe: bool = True):
    """Plain version of K7: ``y1 = relu(((hq * s_mid - mean) * inv) *
    gamma + beta)`` in f32 (JAX's order, each operation rounded on its
    own), then ``(yq, max y1)``: ``yq = clip(round(y1 / s_act))`` as s8
    and the f32 maximum of ``y1`` (0 unless ``observe``). ``mean_b`` and
    ``inv_b`` are per (sample, channel), (N, M)."""
    bs = _bshape(hq)
    hh = hq.float() * s_mid
    y1 = torch.relu((hh - mean_b.reshape(bs)) * inv_b.reshape(bs) * gamma
                    + beta)
    amax = y1.amax() if observe else y1.new_zeros(())
    return quantize_with_scale(y1, s_act), amax


def bn_relu_requant_cuda(hq, s_mid, mean_b, inv_b, gamma, beta, s_act,
                         observe: bool = True):
    """K7 (``csrc/int8_store.cu``) on CUDA tensors: see
    :func:`bn_relu_requant_plain`."""
    global bnrelu_launches
    dev = _check_cuda(hq, s_mid, mean_b, inv_b, gamma, beta, s_act)
    n, m = hq.shape[0], hq.shape[-1]
    if hq.dtype != torch.int8 or tuple(mean_b.shape) != (n, m) \
            or tuple(inv_b.shape) != (n, m) or gamma.numel() != m \
            or beta.numel() != m:
        raise ValueError(f"K7 takes s8 hq (N, ..., M) and (N, M) mean and "
                         f"inv, (M,) gamma and beta; got {hq.dtype} "
                         f"{tuple(hq.shape)}, {tuple(mean_b.shape)}, "
                         f"{tuple(inv_b.shape)}, {gamma.numel()}, "
                         f"{beta.numel()}")
    x = hq.contiguous()
    args = [t.float().contiguous() for t in (s_mid.reshape(()), mean_b,
                                             inv_b, gamma, beta,
                                             s_act.reshape(()))]
    yq = torch.empty_like(x)
    amax = torch.zeros((), dtype=torch.float32, device=dev)
    per_row = x.numel() // max(n, 1)
    err = _k7_lib().cstp_bn_relu_requant(
        x.data_ptr(), *(t.data_ptr() for t in args), yq.data_ptr(),
        amax.data_ptr(), x.numel(), per_row, m, int(observe),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "cstp_bn_relu_requant")
    bnrelu_launches += 1
    return yq, amax


def bn_relu_requant(hq, s_mid, mean_b, inv_b, gamma, beta, s_act,
                    observe: bool = True):
    """The chain's normalise/affine/ReLU/requantize pass, s8 -> s8: K7 on
    CUDA tensors (or raises), its plain version on the CPU."""
    if hq.device.type == "cpu":
        return bn_relu_requant_plain(hq, s_mid, mean_b, inv_b, gamma, beta,
                                     s_act, observe)
    return bn_relu_requant_cuda(hq, s_mid, mean_b, inv_b, gamma, beta, s_act,
                                observe)


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
    """-> (out, xq, sx): quantize x at ``act_scale`` and w per channel, the
    int8 conv dequantized by ``sx * sw``."""
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
        dx, dw = _bf16_conv_vjp(xq, sx, w, g, ctx.geometry, need_x, need_w)
        dx = dx.to(ctx.x_dtype) if need_x else None
        dw = dw.to(w.dtype) if need_w else None
        return dx, dw, None, None, None, None, None


def _bf16_conv_vjp(xq, sx, w, g, geometry, need_x=True, need_w=True):
    """The straight-through gradients: ``(dx, dw)`` (bf16; None where not
    needed) of the bf16 conv at the dequantized input ``(xq * sx)`` in
    bf16, the point the forward evaluated, and ``w`` in bf16."""
    xhat = (xq.float() * sx).to(torch.bfloat16).requires_grad_(need_x)
    wb = w.detach().to(torch.bfloat16).requires_grad_(need_w)
    with torch.enable_grad():
        out = _conv_ndhwc(xhat, wb, *geometry)
    wanted = [t for t, n in ((xhat, need_x), (wb, need_w)) if n]
    got = iter(torch.autograd.grad(out, wanted, g.to(torch.bfloat16)))
    return (next(got) if need_x else None), (next(got) if need_w else None)


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
              padding: Sequence, out_dtype=torch.bfloat16, *,
              act_scale) -> torch.Tensor:
    """int8-quantized 3D convolution with a straight-through bf16 backward.

    ``x``: (N, T, H, W, Cin) float; ``w``: (Cout, Cin, kt, kh, kw) float;
    ``stride`` per axis; ``padding`` an int or a ``(lo, hi)`` pair per axis.
    ``act_scale``: the activation scale, a float or a 0-d tensor, which
    gets no gradient: ``activation_absmax_scale`` of the input for the
    dynamic scale (``models/layers.py Conv3d`` takes it over the ranks
    that hold parts of the input), else a static one. Returns
    ``out_dtype``."""
    pad_lo, pad_hi = _pads(padding)
    stride = [int(s) for s in stride]
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Int8Conv.apply(x, w, act_scale, stride, pad_lo, pad_hi,
                               out_dtype)
    return _int8_forward(x, w, act_scale, stride, pad_lo, pad_hi,
                         out_dtype)[0]


# ------------------------------------------------------------ storage chain

def store_moments(sums, sq_sums, count: int, s_mid, groups: int,
                  axis: Optional[str] = None):
    """Per-group ``(G, M)`` mean and biased variance of ``hh = hq * s_mid``
    from the per-(sample, channel) int64 sums of ``hq`` and ``hq^2`` over
    ``count`` positions: the groups' integer sums and positions (summed
    over the ranks of ``axis`` too, ``mesh.stats_axis``: exact), then
    ``mean = s_mid * E[hq]`` and ``var = s_mid^2 (E[hq^2] - E[hq]^2)`` in
    float64, each rounded once to f32. JAX's f32 ``mean(hh)`` and
    ``mean(hh^2) - mean^2`` differ from them only by their own
    rounding."""
    b, m = sums.shape
    both = torch.stack([sums, sq_sums]).reshape(2, groups, b // groups,
                                                m).sum(2)
    n = (b // groups) * count
    if axis is not None and mesh.mesh_axis(axis).size > 1:
        flat = mesh.all_reduce_sum(torch.cat([both.flatten(),
                                              both.new_full((1,), n)]), axis)
        both, n = flat[:-1].view_as(both), int(flat[-1])
    e1, e2 = both.double() / n
    s = s_mid.double()
    return (s * e1).float(), (s * s * (e2 - e1 * e1)).float()


def _chain_observe(obs, axis: Optional[str]):
    """The observations, maxima over the ranks of ``axis``
    (``mesh.scale_axis``; the JAX package's are over the whole sharded
    batch)."""
    return mesh.all_reduce_max(*obs, axis=axis) if axis else tuple(obs)


def _store_chain_forward(x, ws, wt, gamma, beta, s_in, s_mid, s_act,
                         geometry, groups: int, observe: bool,
                         cross_rank: bool, spatial: bool = False, held=None):
    """The chain's forward: ``(out, gmean, gvar, a_in, a_mid, a_act)`` and
    the s8 tensors ``(xq, hq, yq)`` the backward keeps."""
    (stride_s, pad_s), (stride_t, pad_t) = geometry
    xf = x.float()
    a_in = (activation_absmax_scale(x if held is None else held)
            if observe else xf.new_zeros(()))
    xq = quantize_with_scale(xf, s_in)
    wsq, sws = quantize_weight(ws)
    hq, sums, sq_sums, hmax = int8_conv3d_store(
        xq, wsq, s_in * sws, s_mid, stride_s, pad_s, pad_s, observe)
    gmean, gvar = store_moments(sums, sq_sums, hq[0, ..., 0].numel(), s_mid,
                                groups, mesh.stats_axis(cross_rank, spatial))
    b, bs = hq.shape[0], (hq.shape[0], hq.shape[-1])
    inv_b = torch.rsqrt(per_sample(gvar, b, bs) + BN_EPS)
    yq, ymax = bn_relu_requant(hq, s_mid, per_sample(gmean, b, bs), inv_b,
                               gamma.float(), beta.float(), s_act, observe)
    wtq, swt = quantize_weight(wt)
    out = torch.ops.cstp.int8_conv3d(yq, wtq, s_act * swt, stride_t, pad_t,
                                     pad_t, x.dtype)
    if observe:
        a_mid = _true_div(hmax, QMAX) + EPS
        a_act = _true_div(ymax, QMAX) + EPS
        a_in, a_mid, a_act = _chain_observe((a_in, a_mid, a_act),
                                            mesh.scale_axis(spatial))
    else:
        a_mid, a_act = xf.new_zeros(()), xf.new_zeros(())
    return (out, gmean, gvar, a_in, a_mid, a_act), (xq, hq, yq)


class _Int8StoreChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ws, wt, gamma, beta, s_in, s_mid, s_act, geometry,
                groups, observe, cross_rank, spatial, held):
        outs, (xq, hq, yq) = _store_chain_forward(
            x, ws, wt, gamma, beta, s_in, s_mid, s_act, geometry, groups,
            observe, cross_rank, spatial, held)
        gmean, gvar = outs[1:3]
        ctx.save_for_backward(xq, hq, yq, ws, wt, gamma, gmean, gvar, s_in,
                              s_mid, s_act)
        ctx.x_dtype = x.dtype
        ctx.geometry, ctx.groups = geometry, groups
        ctx.axis, ctx.spatial = mesh.stats_axis(cross_rank, spatial), spatial
        ctx.mark_non_differentiable(*outs[1:])
        return outs

    @staticmethod
    def backward(ctx, g_out, *_):
        (xq, hq, yq, ws, wt, gamma, gmean, gvar, s_in, s_mid,
         s_act) = ctx.saved_tensors
        (stride_s, pad_s), (stride_t, pad_t) = ctx.geometry
        need = ctx.needs_input_grad
        # the temporal conv's VJP at the dequantized stored input; the ReLU
        # mask from the stored post-ReLU values (y >= 0; quantization maps
        # ties at 0 to exactly 0)
        dy1, dwt = _bf16_conv_vjp(yq, s_act, wt, g_out,
                                  (stride_t, pad_t, pad_t), True, need[2])
        y_pos = yq > 0
        dpre = dy1.float() * y_pos
        # the grouped batch-BN three-term gradient, from the stored s8 mid
        b, bs = hq.shape[0], _bshape(hq)
        inv_b = torch.rsqrt(per_sample(gvar, b, bs) + BN_EPS)
        xnorm = (hq.float() * s_mid - per_sample(gmean, b, bs)) * inv_b
        spatial = tuple(range(1, hq.dim() - 1))
        dpx = dpre * xnorm
        dgamma = dpx.sum((0,) + spatial)
        dbeta = dpre.sum((0,) + spatial)
        gm1 = group_mean(dpre.mean(spatial), ctx.groups)
        gm2 = group_mean(dpx.mean(spatial), ctx.groups)
        if ctx.axis is not None:
            # over the ranks, each weighted by its positions on H shards
            count = hq[:b // ctx.groups, ..., 0].numel()
            gm1, gm2 = mesh.global_moments(
                gm1, gm2, axis=ctx.axis,
                count=count if ctx.spatial else None)
        dh = (gamma * inv_b) * (dpre - per_sample(gm1, b, bs)
                                - xnorm * per_sample(gm2, b, bs))
        # the spatial conv's VJP at the dequantized stored input
        dx, dws = _bf16_conv_vjp(xq, s_in, ws, dh, (stride_s, pad_s, pad_s),
                                 need[0], need[1])
        return (dx.to(ctx.x_dtype) if need[0] else None,
                dws.to(ws.dtype) if need[1] else None,
                dwt.to(wt.dtype) if need[2] else None,
                dgamma, dbeta) + (None,) * 9


def _geometry(stride_s, pad_s, stride_t, pad_t):
    return (([int(v) for v in stride_s], [int(v) for v in pad_s]),
            ([int(v) for v in stride_t], [int(v) for v in pad_t]))


def int8_store_chain(x, ws, wt, gamma, beta, s_in, s_mid, s_act,
                     stride_s, pad_s, stride_t, pad_t, groups: int,
                     observe: bool = True, cross_rank: bool = False,
                     spatial: bool = False, held=None):
    """spatial conv -> grouped BN -> ReLU -> temporal conv with s8 storage
    (the JAX package's ``int8_store_chain``).

    ``x``: (B, T, H, W, Cin) float; ``ws``: (M, Cin, 1, kh, kw) and ``wt``:
    (Cout, M, kt, 1, 1), OIDHW; ``gamma``/``beta``: (M,) BN affine;
    ``s_*``: positive 0-d f32 tensors, the delayed activation scales;
    ``stride_*``/``pad_*``: three ints each (symmetric pads); ``groups``:
    BN groups of contiguous rows; ``observe=False`` (``int8_store_fz``)
    skips the absmax observations (zeros); ``cross_rank``: the moments
    over the ranks of a process group (``--sync_bn 1``); ``spatial``: ``x``
    is an H shard with its halo rows (``--shard_spatial``; H padded by
    none), the moments summed over 'model' too and the observations
    maxima over it (``mesh.stats_axis`` / ``scale_axis``); ``held``: the
    rows this rank holds, before the halo, whose absmax is the input's
    observation (the halo of a strided 1 x 1 conv leaves rows out).
    Returns ``(out, gmean, gvar, a_in, a_mid, a_act)``: the output in
    ``x``'s dtype, the ``(G, M)`` batch statistics and the three
    observations ``absmax / 127 + 1e-12``; only ``out`` carries a gradient
    (to x, ws, wt, gamma and beta)."""
    geometry = _geometry(stride_s, pad_s, stride_t, pad_t)
    args = (x, ws, wt, gamma, beta, s_in, s_mid, s_act, geometry, groups,
            observe, cross_rank, spatial, held)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, ws, wt, gamma, beta)):
        return _Int8StoreChain.apply(*args)
    return _store_chain_forward(*args)[0]


def float_store_chain(x, ws, wt, gamma, beta, groups: int, stride_s, pad_s,
                      stride_t, pad_t, train: bool, ra_mean, ra_var,
                      dtype: torch.dtype, cross_rank: bool = False,
                      spatial: bool = False, held=None):
    """The float chain from the same parameters (the JAX package's
    ``float_store_chain``): the ``int8_store_calib`` bootstrap, eval of an
    int8_store model, and the tests' reference. The convs run in
    ``dtype``, the BatchNorm in f32 (train: per-group batch moments, over
    the ranks under ``cross_rank``, and over the H shards under
    ``spatial``, each weighted by its positions, as ``BatchNorm``'s; eval:
    ``ra_mean``/``ra_var``; ``held`` as :func:`int8_store_chain`'s).
    Returns ``(out, gmean, gvar, (a_in, a_mid, a_act))``, gmean/gvar None
    in eval; in train mode the observations are maxima over the ranks
    that hold parts of the batch (``mesh.scale_axis``)."""
    xd = x.to(dtype)
    a_in = activation_absmax_scale(xd if held is None else held.to(dtype))
    hf = _conv_ndhwc(xd, ws.to(dtype), stride_s, pad_s, pad_s).float()
    a_mid = activation_absmax_scale(hf)
    b, bs = hf.shape[0], _bshape(hf)
    if train:
        gmean, gsq = group_moments(hf, groups)
        axis = mesh.stats_axis(cross_rank, spatial)
        if axis is not None:
            count = hf.numel() // (hf.shape[-1] * groups)
            gmean, gsq = mesh.global_moments(
                gmean, gsq, axis=axis, count=count if spatial else None)
        # unclamped also at groups = 1, as the JAX package's chain
        # (BatchNorm clamps it there, as flax's BatchNorm)
        gvar = gsq - gmean.square()
        xnorm = (hf - per_sample(gmean, b, bs)) * torch.rsqrt(
            per_sample(gvar, b, bs) + BN_EPS)
    else:
        gmean = gvar = None
        xnorm = (hf - ra_mean) * torch.rsqrt(ra_var + BN_EPS)
    y1 = torch.relu(xnorm * gamma + beta)
    a_act = _true_div(y1.amax(), QMAX) + EPS
    out = _conv_ndhwc(y1.to(dtype), wt.to(dtype), stride_t, pad_t, pad_t)
    obs = _chain_observe((a_in, a_mid, a_act),
                         mesh.scale_axis(spatial) if train else None)
    return out, gmean, gvar, obs


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
