"""R(2+1)D backbone, the flagship CSTP encoder, in PyTorch.

The port of ``cstp_tpu/models/r21d.py`` (reference ``R2Plus1DNet``,
``models/pace/r21d_byol.py:184-229``): a 5-stage ResNet of factorized (2+1)D
convolutions, ``layer_sizes`` blocks per stage, global average pool to a
512-d feature. NDHWC activations, ``dtype`` compute, f32 parameters and BN.
``bn_groups`` and ``fused_conv`` reach every block.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cstp_tpu_torch.models.layers import BatchNorm, MLPHead, SpatioTemporalConv

LAYER_SIZES = {1: (1, 1, 1, 1), 10: (1, 1, 1, 1), 18: (2, 2, 2, 2),
               34: (3, 4, 6, 3)}


class SpatioTemporalResBlock(nn.Module):
    """conv -> BN -> ReLU -> conv -> BN -> (+shortcut) -> ReLU
    (reference ``r21d_byol.py:100-148``)."""

    def __init__(self, in_ch: int, features: int, downsample: bool = False,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 fused_conv: bool = False,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.downsample = downsample
        stride = (2, 2, 2) if downsample else (1, 1, 1)
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen)
        self.conv1 = SpatioTemporalConv(in_ch, features, 3, stride, 1,
                                        fused=fused_conv, **kw)
        self.bn1 = BatchNorm(features, bn_groups, gen)
        self.conv2 = SpatioTemporalConv(features, features, 3, 1, 1,
                                        fused=fused_conv, **kw)
        self.bn2 = BatchNorm(features, bn_groups, gen)
        if downsample:
            self.downsampleconv = SpatioTemporalConv(in_ch, features, 1, 2, 0,
                                                     **kw)
            self.downsamplebn = BatchNorm(features, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        res = self.bn1(self.conv1(x, train), train)
        res = torch.relu(res).to(self.dtype)
        res = self.bn2(self.conv2(res, train), train)
        if self.downsample:
            x = self.downsamplebn(self.downsampleconv(x, train), train)
        return torch.relu(x.float() + res.float()).to(self.dtype)


class SpatioTemporalResLayer(nn.Module):
    """First block (optionally downsampling) + (layer_size - 1) identity
    blocks (reference ``r21d_byol.py:151-181``); blocks are named
    ``block1``, ``block2``, ... as in the JAX package."""

    def __init__(self, in_ch: int, features: int, layer_size: int,
                 downsample: bool = False, dtype=torch.bfloat16,
                 bn_groups: int = 1, fused_conv: bool = False,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, bn_groups=bn_groups, fused_conv=fused_conv,
                  gen=gen)
        self.block1 = SpatioTemporalResBlock(in_ch, features, downsample, **kw)
        for i in range(layer_size - 1):
            setattr(self, f"block{i + 2}",
                    SpatioTemporalResBlock(features, features, False, **kw))
        self.layer_size = layer_size

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        for i in range(self.layer_size):
            x = getattr(self, f"block{i + 1}")(x, train)
        return x


class R2Plus1DNet(nn.Module):
    """Returns the 512-d pooled feature; with ``proj_flag`` also the 512-d
    BYOL projection (reference ``r21d_byol.py:184-229``)."""

    def __init__(self, layer_sizes: Tuple[int, int, int, int] = (1, 1, 1, 1),
                 proj_flag: bool = False, dtype=torch.bfloat16,
                 bn_groups: int = 1, fused_conv: bool = False,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.proj_flag = proj_flag
        self.conv1 = SpatioTemporalConv(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                                        dtype=dtype, bn_groups=bn_groups,
                                        gen=gen)
        self.bn1 = BatchNorm(64, bn_groups, gen)
        kw = dict(dtype=dtype, bn_groups=bn_groups, fused_conv=fused_conv,
                  gen=gen)
        self.conv2 = SpatioTemporalResLayer(64, 64, layer_sizes[0], False, **kw)
        self.conv3 = SpatioTemporalResLayer(64, 128, layer_sizes[1], True, **kw)
        self.conv4 = SpatioTemporalResLayer(128, 256, layer_sizes[2], True,
                                            **kw)
        self.conv5 = SpatioTemporalResLayer(256, 512, layer_sizes[3], True,
                                            **kw)
        if proj_flag:
            self.project = MLPHead(512, 4096, 512, dtype, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True):
        x = self.conv1(x.to(self.dtype), train)
        x = torch.relu(self.bn1(x, train)).to(self.dtype)
        for layer in (self.conv2, self.conv3, self.conv4, self.conv5):
            x = layer(x, train)
        feat = x.float().mean(dim=(1, 2, 3))
        if self.proj_flag:
            return feat, self.project(feat, train)
        return feat
