"""S3D-G backbone, a separable-Inception video network with self-gating, in
PyTorch.

The port of ``cstp_tpu/models/s3dg.py`` (reference ``models/coclr/s3dg.py``):
``BasicConv3d`` (conv -> BN -> ReLU), ``STConv3d`` (a (1,k,k) spatial conv
-> BN -> ReLU, then a (k,1,1) temporal conv -> BN -> ReLU), ``SepInception``
blocks with an optional ``SelfGating`` per branch, and the stem with
temporal stride 2 (1 with ``slow``). Global average pool in float32 to a
1024-d feature; with ``proj_flag`` a 1024 -> h1024 -> 1024 projector. The
module names are the JAX package's, so ``models/bridge.py`` maps weights by
rename. NDHWC activations, ``dtype`` compute, f32 parameters and BN.

``STConv3d`` is a spatial -> BN -> ReLU -> temporal chain like R(2+1)D's,
but the JAX package never sends it through ``fused_st_conv`` (``fused_conv``
reaches R(2+1)D only), so neither does the port. ``--s2d_stem`` on this
S3D is not ported (``config.check_ported`` refuses it); the space-to-depth
permutation itself, :func:`space_to_depth_stem`, is here, for the legacy
S3D-G (``models/legacy.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from cstp_tpu_torch.models.layers import (
    INCEPTION_PLAN,
    BatchNorm,
    Conv3d,
    MLPHead,
    SelfGating,
    max_pool_3d,
)


def space_to_depth_stem(x: torch.Tensor) -> torch.Tensor:
    """``(B, T, H, W, C)`` -> ``(B, T/2, H/2, W/2, 8C)``: each 2x2x2 cell's
    values in (t, h, w, c) order on the channel axis (reference
    ``pace/s3d_g.py:280-287``)."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, t // 2, h // 2, w // 2, 8 * c)


class BasicConv3d(nn.Module):
    """conv (no bias) -> BN -> ReLU (reference ``s3dg.py:39-59``)."""

    def __init__(self, in_ch: int, features: int, kernel=1, stride=1,
                 padding=0, dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv3d(in_ch, features, kernel, stride, padding, dtype,
                           gen)
        self.bn = BatchNorm(features, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), train)).to(self.dtype)


class STConv3d(nn.Module):
    """Separable conv: (1,k,k) spatial + BN + ReLU, then (k,1,1) temporal +
    BN + ReLU (reference ``s3dg.py:62-97``); ``stride`` is (temporal,
    spatial)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride=(1, 1), padding: int = 0, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None):
        super().__init__()
        k, p = kernel, padding
        ts, ss = stride
        self.dtype = dtype
        self.conv1 = Conv3d(in_ch, features, (1, k, k), (1, ss, ss),
                            (0, p, p), dtype, gen)
        self.bn1 = BatchNorm(features, bn_groups, gen)
        self.conv2 = Conv3d(features, features, (k, 1, 1), (ts, 1, 1),
                            (p, 0, 0), dtype, gen)
        self.bn2 = BatchNorm(features, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x), train)).to(self.dtype)
        return torch.relu(self.bn2(self.conv2(x), train)).to(self.dtype)


class SepInception(nn.Module):
    """4-branch separable Inception block (reference ``s3dg.py:113-163``);
    ``out_planes`` = [b0, b1a, b1b, b2a, b2b, b3b]."""

    def __init__(self, in_ch: int, out_planes: Sequence[int],
                 gating: bool = False, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None):
        super().__init__()
        p0, p1a, p1b, p2a, p2b, p3b = out_planes
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen)
        self.branch0 = BasicConv3d(in_ch, p0, **kw)
        self.branch1_0 = BasicConv3d(in_ch, p1a, **kw)
        self.branch1_1 = STConv3d(p1a, p1b, 3, (1, 1), 1, **kw)
        self.branch2_0 = BasicConv3d(in_ch, p2a, **kw)
        self.branch2_1 = STConv3d(p2a, p2b, 3, (1, 1), 1, **kw)
        self.branch3_1 = BasicConv3d(in_ch, p3b, **kw)
        self.gating = gating
        self.out_ch = p0 + p1b + p2b + p3b
        if gating:
            for i, c in enumerate((p0, p1b, p2b, p3b)):
                setattr(self, f"gating_b{i}", SelfGating(c, gen))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        xs = [self.branch0(x, train),
              self.branch1_1(self.branch1_0(x, train), train),
              self.branch2_1(self.branch2_0(x, train), train),
              self.branch3_1(max_pool_3d(x, 3, 1, 1), train)]
        if self.gating:
            xs = [getattr(self, f"gating_b{i}")(v) for i, v in enumerate(xs)]
        return torch.cat(xs, dim=-1)


# block name -> out_planes
MIXED = tuple((f"Mixed_{k}", plan) for k, plan in INCEPTION_PLAN)
# the max pool ahead of a block: (kernel, stride, padding)
_POOL_BEFORE = {"Mixed_3b": ((1, 3, 3), (1, 2, 2), (0, 1, 1)),
                "Mixed_4b": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
                "Mixed_5b": ((2, 2, 2), (2, 2, 2), (0, 0, 0))}


class S3D(nn.Module):
    """The 1024-d feature extractor (reference ``s3dg.py:166-248``);
    ``gating`` adds S3D-G's self-gating to every branch, ``slow`` keeps the
    stem's temporal stride at 1, ``proj_flag`` returns ``(feat, proj)``."""

    def __init__(self, gating: bool = True, slow: bool = False,
                 proj_flag: bool = False, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen)
        self.Conv_1a = STConv3d(3, 64, 7, (1 if slow else 2, 2), 3, **kw)
        self.Conv_2b = BasicConv3d(64, 64, **kw)
        self.Conv_2c = STConv3d(64, 192, 3, (1, 1), 1, **kw)
        in_ch = 192
        for name, plan in MIXED:
            block = SepInception(in_ch, plan, gating, **kw)
            setattr(self, name, block)
            in_ch = block.out_ch
        self.project = (MLPHead(in_ch, 1024, 1024, dtype, bn_groups, gen)
                        if proj_flag else None)

    def forward(self, x: torch.Tensor, train: bool = True):
        x = self.Conv_1a(x.to(self.dtype), train)
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.Conv_2c(self.Conv_2b(x, train), train)
        for name, _ in MIXED:
            if name in _POOL_BEFORE:
                x = max_pool_3d(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x, train)
        feat = x.float().mean(dim=(1, 2, 3))
        if self.project is not None:
            return feat, self.project(feat, train)
        return feat
