"""Fused factorized (2+1)D conv block: CUDA kernels and their plain version.

The port of ``cstp_tpu/ops/pallas/conv21d.py``: spatial (1,3,3) conv ->
BatchNorm with batch statistics -> ReLU -> temporal (3,1,1) conv, stride 1,
on NDHWC tensors, as two passes so the wide mid tensor never reaches device
memory in the forward pass:

* ``run_stats`` (pass A, ``csrc/conv21d.cu cstp_conv21d_stats``): per BN
  group ``(G, M)`` mean and biased variance of the bf16-rounded spatial conv;
* ``run_fwd`` (pass B, ``cstp_conv21d_fwd``): recompute the spatial conv,
  normalise, ReLU, round to bf16, temporal conv -> bf16 output.

``fused_st_conv`` is the ``torch.autograd.Function`` around them. Its
forward launches both kernels for CUDA tensors (in bf16, as the TPU kernels
cast) and runs the plain version for CPU tensors, in the input's dtype.
Its backward recomputes the plain chain with the statistics recomputed
inside, so gradients flow through the mean and variance like a plain
BatchNorm; the cotangents of the returned statistics are dropped (they only
feed the running-stat update).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cstp_tpu_torch.ops import build

# launches per wrapper (one per call on CUDA tensors)
launches = {"stats": 0, "fwd": 0}


# ------------------------------------------------------------ plain version

def _spatial_conv(x, ws, dtype):
    """x (B, T, H, W, Cin), ws (kh, kw, Cin, M) -> (B, T, H, W, M) in dtype."""
    w = ws.to(dtype).permute(3, 2, 0, 1).unsqueeze(2)           # (M,Cin,1,kh,kw)
    kh, kw = ws.shape[0], ws.shape[1]
    y = F.conv3d(x.to(dtype).permute(0, 4, 1, 2, 3), w,
                 padding=(0, (kh - 1) // 2, (kw - 1) // 2))
    return y.permute(0, 2, 3, 4, 1)


def reference_stats(x, ws, bn_groups: int, dtype=torch.bfloat16):
    """Per-group ``(G, M)`` mean / biased variance of the spatial conv,
    rounded to ``dtype``, by partial moments (``reference_stats``)."""
    b = x.shape[0]
    g = bn_groups
    mid = _spatial_conv(x, ws, dtype).float()
    pmean = mid.mean(dim=(1, 2, 3))                             # (B, M)
    psq = mid.square().mean(dim=(1, 2, 3))
    m = pmean.reshape(g, b // g, -1).mean(dim=1)
    v = psq.reshape(g, b // g, -1).mean(dim=1) - m.square()
    return m, v


def reference_chain(x, ws, wt, scale, bias, gmean, gvar, bn_groups: int,
                    eps: float = 1e-5, dtype=torch.bfloat16):
    """The unfused spatial -> BN(given group stats) -> ReLU -> temporal
    chain in ``dtype``; ``wt`` is (3, M, Cout)."""
    b = x.shape[0]
    g = bn_groups
    mid = _spatial_conv(x, ws, dtype)
    mean_b = gmean.repeat_interleave(b // g, dim=0)[:, None, None, None, :]
    rstd_b = torch.rsqrt(gvar.repeat_interleave(b // g, dim=0)
                         + eps)[:, None, None, None, :]
    y = (mid.float() - mean_b) * rstd_b * scale + bias
    y = torch.relu(y).to(dtype)
    wt_o = wt.to(dtype).permute(2, 1, 0)[:, :, :, None, None]   # (Cout,M,3,1,1)
    out = F.conv3d(y.permute(0, 4, 1, 2, 3), wt_o, padding=(1, 0, 0))
    return out.permute(0, 2, 3, 4, 1)


def fused_st_conv_plain(x, ws, wt, scale, bias, bn_groups: int = 1,
                        eps: float = 1e-5, dtype=torch.bfloat16):
    """Plain version of the two kernels: ``(out, gmean, gvar)``. With
    ``dtype=bfloat16`` it rounds where the kernels round (x, weights, the
    spatial-conv output, the post-ReLU mid, the output)."""
    gmean, gvar = reference_stats(x, ws, bn_groups, dtype)
    out = reference_chain(x, ws, wt, scale, bias, gmean, gvar, bn_groups,
                          eps, dtype)
    return out, gmean, gvar


# ------------------------------------------------------------ CUDA kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "cstp_conv21d_stats": ([_P] * 6 + [_I] * 7 + [_P], _I),
    "cstp_conv21d_fwd": ([_P] * 8 + [_I] * 8 + [_P], _I),
}


def _lib():
    return build.load("conv21d", _SIGNATURES)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"conv21d: {name} on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"conv21d: {name} must be {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"conv21d: {name} must be contiguous and 16-byte "
                         "aligned")


def _check_dims(cin, m, cout):
    if cin % 32 or m % 16 or cout % 16:
        raise ValueError(f"conv21d kernels need Cin % 32 == 0, M % 16 == 0, "
                         f"Cout % 16 == 0; got {cin}, {m}, {cout}")


def run_stats(x, ws2, bn_groups: int):
    """Pass A on CUDA: x (B, T, H, W, Cin) bf16, ws2 (9*Cin, M) bf16 ->
    gmean, gvar (G, M) f32."""
    b, t, h, w, cin = x.shape
    m = ws2.shape[1]
    _check_dims(cin, m, 16)
    if b % bn_groups:
        raise ValueError(f"batch {b} not divisible by {bn_groups} BN groups")
    dev = x.device
    _check("x", x, torch.bfloat16, (b, t, h, w, cin), dev)
    _check("ws", ws2, torch.bfloat16, (9 * cin, m), dev)
    psum = torch.empty((b * t, m), dtype=torch.float32, device=dev)
    psq = torch.empty_like(psum)
    gmean = torch.empty((bn_groups, m), dtype=torch.float32, device=dev)
    gvar = torch.empty_like(gmean)
    err = _lib().cstp_conv21d_stats(
        x.data_ptr(), ws2.data_ptr(), psum.data_ptr(), psq.data_ptr(),
        gmean.data_ptr(), gvar.data_ptr(), b, t, h, w, cin, m, bn_groups,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "cstp_conv21d_stats")
    launches["stats"] += 1
    return gmean, gvar


def run_fwd(x, ws2, wt, gmean, gvar, scale, bias, bn_groups: int,
            eps: float = 1e-5):
    """Pass B on CUDA: -> (B, T, H, W, Cout) bf16."""
    b, t, h, w, cin = x.shape
    m = ws2.shape[1]
    cout = wt.shape[2]
    _check_dims(cin, m, cout)
    if b % bn_groups:
        raise ValueError(f"batch {b} not divisible by {bn_groups} BN groups")
    dev = x.device
    rstd = torch.rsqrt(gvar + eps)
    _check("x", x, torch.bfloat16, (b, t, h, w, cin), dev)
    _check("ws", ws2, torch.bfloat16, (9 * cin, m), dev)
    _check("wt", wt, torch.bfloat16, (3, m, cout), dev)
    _check("gmean", gmean, torch.float32, (bn_groups, m), dev)
    _check("rstd", rstd, torch.float32, (bn_groups, m), dev)
    _check("scale", scale, torch.float32, (m,), dev)
    _check("bias", bias, torch.float32, (m,), dev)
    out = torch.empty((b, t, h, w, cout), dtype=torch.bfloat16, device=dev)
    err = _lib().cstp_conv21d_fwd(
        x.data_ptr(), ws2.data_ptr(), wt.data_ptr(), gmean.data_ptr(),
        rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, t, h, w, cin, m, cout, bn_groups,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "cstp_conv21d_fwd")
    launches["fwd"] += 1
    return out


def fused_st_conv_cuda(x, ws, wt, scale, bias, bn_groups: int = 1,
                       eps: float = 1e-5):
    """Both kernels on CUDA tensors, with the TPU kernels' bf16 casts."""
    kh, kw, cin, m = ws.shape
    if (kh, kw) != (3, 3) or wt.shape[0] != 3:
        raise ValueError(f"conv21d kernels take ws (3, 3, Cin, M) and wt "
                         f"(3, M, Cout); got {tuple(ws.shape)}, "
                         f"{tuple(wt.shape)}")
    xb = x.to(torch.bfloat16).contiguous()
    ws2 = ws.to(torch.bfloat16).reshape(9 * cin, m).contiguous()
    gmean, gvar = run_stats(xb, ws2, bn_groups)
    out = run_fwd(xb, ws2, wt.to(torch.bfloat16).contiguous(), gmean, gvar,
                  scale.float().contiguous(), bias.float().contiguous(),
                  bn_groups, eps)
    return out, gmean, gvar


# ------------------------------------------------------------ autograd op

class FusedSTConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ws, wt, scale, bias, bn_groups, eps):
        if x.device.type == "cuda":
            out, gmean, gvar = fused_st_conv_cuda(x, ws, wt, scale, bias,
                                                  bn_groups, eps)
            ctx.dtype = torch.bfloat16
        else:
            ctx.dtype = x.dtype
            out, gmean, gvar = fused_st_conv_plain(x, ws, wt, scale, bias,
                                                   bn_groups, eps, x.dtype)
        ctx.save_for_backward(x, ws, wt, scale, bias)
        ctx.bn_groups, ctx.eps = bn_groups, eps
        ctx.mark_non_differentiable(gmean, gvar)
        return out, gmean, gvar

    @staticmethod
    def backward(ctx, d_out, _d_gmean, _d_gvar):
        inputs = [t.detach().requires_grad_(True)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            x, ws, wt, scale, bias = inputs
            gm, gv = reference_stats(x, ws, ctx.bn_groups, ctx.dtype)
            out = reference_chain(x, ws, wt, scale, bias, gm, gv,
                                  ctx.bn_groups, ctx.eps, ctx.dtype)
        grads = torch.autograd.grad(out, inputs, d_out.to(out.dtype),
                                    allow_unused=True)
        grads = [None if g is None else g.to(t.dtype)
                 for g, t in zip(grads, ctx.saved_tensors)]
        return (*grads, None, None)


def fused_st_conv(x, ws, wt, scale, bias, bn_groups: int = 1,
                  eps: float = 1e-5):
    """Fused spatial(1,3,3) -> BN(train stats) -> ReLU -> temporal(3,1,1).
    ``x`` (B, T, H, W, Cin) unpadded; ``ws`` (3, 3, Cin, M); ``wt``
    (3, M, Cout); ``scale``/``bias`` (M,). Returns ``(out, gmean, gvar)``
    with ``(G, M)`` group statistics."""
    return FusedSTConv.apply(x, ws, wt, scale, bias, bn_groups, eps)
