"""Shared building blocks for the CSTP backbones, in PyTorch.

The port of ``cstp_tpu/models/layers.py``. Activations are NDHWC (channels
last) at every module boundary, as in the JAX package; convolutions run in
``dtype`` (bfloat16 by default) while BatchNorm statistics and all
parameters stay float32. Conv weights are stored in PyTorch's OIDHW layout
and dense weights as ``(out, in)``; ``models/bridge.py`` converts the JAX
package's DHWIO / ``(in, out)`` leaves.

Initialisation follows the JAX package (reference ``r21d_byol.py:301-329``):
glorot-uniform conv and dense kernels, glorot-uniform BatchNorm scales
(``U(-sqrt(6/C), sqrt(6/C))``), torch-default dense biases.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cstp_tpu_torch.ops.conv21d import fused_st_conv

BN_MOMENTUM = 0.9   # flax convention: running = 0.9 * running + 0.1 * batch
BN_EPS = 1e-5


# ---------------------------------------------------------------- init laws

def bn_glorot_scale_init(t: torch.Tensor, gen: Optional[torch.Generator]):
    """Reference ``_glorot_uniform`` on a 1-D tensor: bound sqrt(6 / C)."""
    bound = math.sqrt(6.0 / float(t.shape[-1]))
    return nn.init.uniform_(t, -bound, bound, generator=gen)


def torch_linear_bias_init(t: torch.Tensor, fan_in: int,
                           gen: Optional[torch.Generator]):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return nn.init.uniform_(t, -bound, bound, generator=gen)


def glorot_init(t: torch.Tensor, gen: Optional[torch.Generator]):
    """Glorot uniform; PyTorch's fans of an OIDHW / (out, in) weight equal
    flax's fans of the DHWIO / (in, out) kernel."""
    return nn.init.xavier_uniform_(t, generator=gen)


# ---------------------------------------------------------------- BatchNorm

class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax semantics: momentum 0.9,
    eps 1e-5, the *biased* batch variance in the running update, f32
    statistics and normalisation, output in the input's dtype.

    ``groups > 1`` splits the batch into contiguous groups along dim 0, each
    normalised with its own statistics (``_GroupedBN``: per-view statistics
    for the concatenated two-view batch); the running statistics take the
    mean of the group statistics. ``groups == 1`` is ``flax.linen.BatchNorm``
    (fast variance, clipped at 0). ``torch.nn.BatchNorm*`` would update the
    running variance with the unbiased estimate, hence this module.
    """

    def __init__(self, channels: int, groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.groups = groups
        self.scale = nn.Parameter(bn_glorot_scale_init(
            torch.empty(channels), gen))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def batch_stats(self, xf: torch.Tensor):
        """Per-group ``(G, C)`` mean and biased variance of f32 ``xf``."""
        c = xf.shape[-1]
        if self.groups == 1:
            flat = xf.reshape(-1, c)
            mean = flat.mean(0)
            var = torch.clamp(flat.square().mean(0) - mean.square(), min=0.0)
            return mean[None], var[None]
        b, g = xf.shape[0], self.groups
        if b % g:
            raise ValueError(f"batch {b} not divisible by {g} BN groups")
        axes = tuple(range(1, xf.dim() - 1))
        pmean = xf.mean(dim=axes) if axes else xf               # (B, C)
        psq = xf.square().mean(dim=axes) if axes else xf.square()
        gmean = pmean.reshape(g, b // g, c).mean(1)
        gvar = psq.reshape(g, b // g, c).mean(1) - gmean.square()
        return gmean, gvar

    @torch.no_grad()
    def update_running(self, gmean: torch.Tensor, gvar: torch.Tensor):
        """running = 0.9 * running + 0.1 * mean over groups."""
        self.mean.copy_(BN_MOMENTUM * self.mean
                        + (1.0 - BN_MOMENTUM) * gmean.detach().mean(0))
        self.var.copy_(BN_MOMENTUM * self.var
                       + (1.0 - BN_MOMENTUM) * gvar.detach().mean(0))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out_dtype = x.dtype if x.is_floating_point() else torch.float32
        xf = x.float()
        if not train:
            y = (xf - self.mean) * torch.rsqrt(self.var + BN_EPS) * self.scale
            return (y + self.bias).to(out_dtype)
        gmean, gvar = self.batch_stats(xf)
        self.update_running(gmean, gvar)
        if self.groups == 1:
            y = (xf - gmean[0]) * (torch.rsqrt(gvar[0] + BN_EPS) * self.scale)
            return (y + self.bias).to(out_dtype)
        b, g = xf.shape[0], self.groups
        shape = (b,) + (1,) * (xf.dim() - 2) + (xf.shape[-1],)
        mean_b = gmean.repeat_interleave(b // g, 0).reshape(shape)
        var_b = gvar.repeat_interleave(b // g, 0).reshape(shape)
        y = (xf - mean_b) * torch.rsqrt(var_b + BN_EPS)
        return (y * self.scale + self.bias).to(out_dtype)


@contextlib.contextmanager
def running_stats_kept(module: nn.Module):
    """Every buffer of ``module`` (the BatchNorm running statistics) back to
    its value on entry when the block exits, also on an exception. The
    recompute of a checkpointed region runs inside it: the region's forward
    already advanced the running statistics once, as the JAX package's
    functional remat does."""
    saved = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


# ---------------------------------------------------------------- convs

def _triple(v) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _pad_pairs(padding) -> Tuple[Tuple[int, int], ...]:
    """Per-axis ``(lo, hi)`` pads of ``padding``: an int, three ints
    (symmetric) or three ``(lo, hi)`` pairs, mixed freely."""
    return tuple((p, p) if isinstance(p, int) else (int(p[0]), int(p[1]))
                 for p in _triple(padding))


def _ndhwc_pad(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """``x`` (N, T, H, W, C) padded by ``pads`` ((lo, hi) for T, H, W)."""
    (tlo, thi), (hlo, hhi), (wlo, whi) = pads
    return F.pad(x, (0, 0, wlo, whi, hlo, hhi, tlo, thi), value=value)


class Conv3d(nn.Module):
    """3D conv on NDHWC, computed in ``dtype``. The NDHWC tensor is handed
    to ``F.conv3d`` as its ``channels_last_3d`` NCDHW view, so no copy is
    made. ``padding`` is symmetric per axis (an int each) or, for the
    TF-SAME backbones, a ``(lo, hi)`` pair per axis: an asymmetric pad is
    written into the NDHWC tensor first (so cuDNN still gets a
    ``channels_last_3d`` view) and the conv then pads nothing.
    ``use_bias`` adds a float32 bias, initialised to zeros, to the
    ``dtype`` output (the JAX package's ``out + bias.astype(dtype)``)."""

    def __init__(self, in_ch: int, features: int, kernel, stride=(1, 1, 1),
                 padding=(0, 0, 0), dtype=torch.bfloat16,
                 gen: Optional[torch.Generator] = None,
                 use_bias: bool = False):
        super().__init__()
        self.kernel = _triple(kernel)
        self.stride = _triple(stride)
        pads = _pad_pairs(padding)
        symmetric = all(lo == hi for lo, hi in pads)
        self.pads = None if symmetric else pads
        self.padding = tuple(lo for lo, _ in pads) if symmetric else (0, 0, 0)
        self.dtype = dtype
        self.weight = nn.Parameter(glorot_init(
            torch.empty(features, in_ch, *self.kernel), gen))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.pads is not None:
            x = _ndhwc_pad(x, self.pads)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                     self.weight.to(self.dtype), stride=self.stride,
                     padding=self.padding).permute(0, 2, 3, 4, 1)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def max_pool_3d(x: torch.Tensor, kernel, stride,
                padding=(0, 0, 0)) -> torch.Tensor:
    """``torch.nn.MaxPool3d`` on NDHWC: symmetric padding that never wins
    (``-inf``), through the ``channels_last_3d`` NCDHW view."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), _triple(kernel),
                     _triple(stride), _triple(padding))
    return y.permute(0, 2, 3, 4, 1)


def same_pads(kernel, stride) -> Tuple[Tuple[int, int], ...]:
    """TF SAME pads (the JAX package's ``_same_pads``): ``max(k - s, 0)``
    per axis, the odd one at the end."""
    pads = []
    for k, s in zip(_triple(kernel), _triple(stride)):
        along = max(k - s, 0)
        pads.append((along // 2, along - along // 2))
    return tuple(pads)


def max_pool_3d_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """TF-SAME max pool on NDHWC (I3D's ``MaxPool3dTFPadding``): pads of
    :func:`same_pads`, ``-inf`` as in the JAX package. ``F.max_pool3d``
    pads symmetrically only, so an asymmetric pad is written out first."""
    pads = same_pads(kernel, stride)
    if all(lo == hi for lo, hi in pads):
        return max_pool_3d(x, kernel, stride, tuple(lo for lo, _ in pads))
    return max_pool_3d(_ndhwc_pad(x, pads, float("-inf")), kernel, stride)


def r21d_intermediate_channels(in_channels: int, out_channels: int,
                               kernel: Tuple[int, int, int]) -> int:
    """Mid-channel count of the factorized (2+1)D conv (paper section 3.5,
    reference ``r21d_byol.py:74-76``)."""
    kt, kh, kw = kernel
    num = kt * kh * kw * in_channels * out_channels
    den = kh * kw * in_channels + kt * out_channels
    return int(math.floor(num / den))


class SpatioTemporalConv(nn.Module):
    """Factorized (2+1)D conv: spatial (1,k,k) conv -> BN -> ReLU ->
    temporal (k,1,1) conv (reference ``r21d_byol.py:38-97``).

    ``fused``: in train mode, an eligible site (stride 1, temporal kernel 3
    with padding 1, "same" spatial padding) runs the whole chain through
    :func:`cstp_tpu_torch.ops.conv21d.fused_st_conv`, which launches the
    CUDA kernels for CUDA tensors and runs their plain version on the CPU.
    The parameters are the same either way.
    """

    def __init__(self, in_ch: int, features: int, kernel, stride=(1, 1, 1),
                 padding=(0, 0, 0), dtype=torch.bfloat16, bn_groups: int = 1,
                 fused: bool = False, gen: Optional[torch.Generator] = None):
        super().__init__()
        kt, kh, kw = self.kernel = _triple(kernel)
        st, sh, sw = self.stride = _triple(stride)
        pt, ph, pw = self.padding = _triple(padding)
        self.dtype = dtype
        self.fused = fused
        mid = r21d_intermediate_channels(in_ch, features, self.kernel)
        self.spatial_conv = Conv3d(in_ch, mid, (1, kh, kw), (1, sh, sw),
                                   (0, ph, pw), dtype, gen)
        self.bn = BatchNorm(mid, bn_groups, gen)
        self.temporal_conv = Conv3d(mid, features, (kt, 1, 1), (st, 1, 1),
                                    (pt, 0, 0), dtype, gen)

    def fused_eligible(self, train: bool) -> bool:
        kt, kh, kw = self.kernel
        _, ph, pw = self.padding
        return (self.fused and train and self.stride == (1, 1, 1)
                and (kt, self.padding[0]) == (3, 1)
                and (ph, pw) == (kh // 2, kw // 2))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.fused_eligible(train):
            ws = self.spatial_conv.weight[:, :, 0].permute(2, 3, 1, 0)
            wt = self.temporal_conv.weight[:, :, :, 0, 0].permute(2, 1, 0)
            out, gmean, gvar = fused_st_conv(
                x.to(self.dtype), ws, wt, self.bn.scale, self.bn.bias,
                self.bn.groups, BN_EPS)
            self.bn.update_running(gmean, gvar)
            return out
        x = self.spatial_conv(x)
        x = self.bn(x, train)
        x = torch.relu(x).to(self.dtype)
        return self.temporal_conv(x)


# ---------------------------------------------------------------- heads

class Dense(nn.Module):
    """``flax.linen.Dense`` with a glorot-uniform kernel and a torch-default
    bias, computed in ``dtype``."""

    def __init__(self, in_dim: int, out_dim: int, dtype=torch.bfloat16,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(glorot_init(torch.empty(out_dim, in_dim),
                                               gen))
        self.bias = nn.Parameter(torch_linear_bias_init(
            torch.empty(out_dim), in_dim, gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class MLPHead(nn.Module):
    """Linear -> BN1d -> ReLU -> Linear (reference Projector / Predictor and
    the pretext heads, ``r21d_byol.py:232-291``)."""

    def __init__(self, in_dim: int, hidden: int, out: int,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(in_dim, hidden, dtype, gen)
        self.bn = BatchNorm(hidden, bn_groups, gen)
        self.fc2 = Dense(hidden, out, dtype, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.bn(self.fc1(x), train)
        return self.fc2(torch.relu(x).to(self.dtype))


# The Inception-v1 plan that S3D-G and I3D share (reference s3dg.py:193-222,
# i3d_byol.py:223-426): block suffix -> out_planes [b0, b1a, b1b, b2a, b2b,
# b3b]; S3D-G names a block Mixed_<suffix>, I3D mixed_<suffix>
INCEPTION_PLAN = (
    ("3b", (64, 96, 128, 16, 32, 32)),
    ("3c", (128, 128, 192, 32, 96, 64)),
    ("4b", (192, 96, 208, 16, 48, 64)),
    ("4c", (160, 112, 224, 24, 64, 64)),
    ("4d", (128, 128, 256, 24, 64, 64)),
    ("4e", (112, 144, 288, 32, 64, 64)),
    ("4f", (256, 160, 320, 32, 128, 128)),
    ("5b", (256, 160, 320, 32, 128, 128)),
    ("5c", (384, 192, 384, 48, 128, 128)),
)


class SelfGating(nn.Module):
    """S3D-G feature gating: ``x * sigmoid(fc(mean of x over T, H, W))``,
    the mean, the float32 ``fc`` (glorot kernel, torch-default bias) and
    the product in float32, the result in ``x``'s dtype."""

    def __init__(self, channels: int, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = Dense(channels, channels, torch.float32, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        w = torch.sigmoid(self.fc(xf.mean(dim=(1, 2, 3))))
        return (xf * w[:, None, None, None, :]).to(x.dtype)


class PretextHead(nn.Module):
    """Pretext classification head: 'mlp' = Linear-BN-ReLU-Linear (the r21d
    family) or 'linear' = one f32 Linear."""

    def __init__(self, style: str, in_dim: int, hidden: int, out: int,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.style = style
        if style == "mlp":
            self.mlp = MLPHead(in_dim, hidden, out, dtype, bn_groups, gen)
        elif style == "linear":
            self.fc = Dense(in_dim, out, torch.float32, gen)
        else:
            raise ValueError(f"unknown pretext head style {style!r}")

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.style == "mlp":
            return self.mlp(x, train)
        return self.fc(x.float())


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize(p=2)`` semantics (clamps the norm, not norm + eps)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)
