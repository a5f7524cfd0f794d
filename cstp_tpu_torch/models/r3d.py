"""3D ResNet backbone (depths 10/18/34 basic, 50/101/152/200 bottleneck),
in PyTorch.

The port of ``cstp_tpu/models/r3d.py`` (reference ``models/BE/r3d_byol.py``):
stem conv 7^3 stride (1,2,2) padding 3 -> BN -> ReLU, max pool 3^3 stride 2
padding 1, four stages of ``layers`` blocks (the first of stages 2-4 with
stride 2), global average pool in float32 to ``512 * expansion``. The
shortcut of a block that changes shape is "A" (strided subsample, then the
channels zero-padded; no parameters) or "B" (1x1x1 conv with the stride,
then BN). No projector. ``bn_groups`` reaches every block.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cstp_tpu_torch.models.layers import BatchNorm, Conv3d, max_pool_3d

R3D_LAYERS = {
    10: ("basic", (1, 1, 1, 1), 1),
    18: ("basic", (2, 2, 2, 2), 1),
    34: ("basic", (3, 4, 6, 3), 1),
    50: ("bottleneck", (3, 4, 6, 3), 4),
    101: ("bottleneck", (3, 4, 23, 3), 4),
    152: ("bottleneck", (3, 8, 36, 3), 4),
    200: ("bottleneck", (3, 24, 36, 3), 4),
}


class _Block(nn.Module):
    """The residual sum of both block kinds and their shortcut:
    ``relu(out + shortcut(x))`` in float32, back to ``dtype``."""

    def _init_shortcut(self, in_ch: int, out_ch: int, stride: int,
                       shortcut: str, bn_groups: int, gen):
        self.stride = stride
        self.in_ch, self.out_ch = in_ch, out_ch
        self.shortcut = shortcut
        if shortcut == "B" and (stride != 1 or in_ch != out_ch):
            self.downsample_conv = Conv3d(in_ch, out_ch, 1, stride, 0,
                                          self.dtype, gen)
            self.downsample_bn = BatchNorm(out_ch, bn_groups, gen)

    def _shortcut(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        s = self.stride
        if s == 1 and self.in_ch == self.out_ch:
            return x
        if self.shortcut == "A":
            # F.avg_pool3d(kernel 1, stride s) is a strided subsample
            return F.pad(x[:, ::s, ::s, ::s, :], (0, self.out_ch - self.in_ch))
        return self.downsample_bn(self.downsample_conv(x), train)

    def _residual(self, out, x, train: bool) -> torch.Tensor:
        res = self._shortcut(x, train)
        return torch.relu(out.float() + res.float()).to(self.dtype)


class _BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 shortcut: str = "B", dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv3d(in_ch, planes, 3, stride, 1, dtype, gen)
        self.bn1 = BatchNorm(planes, bn_groups, gen)
        self.conv2 = Conv3d(planes, planes, 3, 1, 1, dtype, gen)
        self.bn2 = BatchNorm(planes, bn_groups, gen)
        self._init_shortcut(in_ch, planes, stride, shortcut, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train)).to(self.dtype)
        out = self.bn2(self.conv2(out), train)
        return self._residual(out, x, train)


class _Bottleneck(_Block):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 shortcut: str = "B", dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv3d(in_ch, planes, 1, 1, 0, dtype, gen)
        self.bn1 = BatchNorm(planes, bn_groups, gen)
        self.conv2 = Conv3d(planes, planes, 3, stride, 1, dtype, gen)
        self.bn2 = BatchNorm(planes, bn_groups, gen)
        self.conv3 = Conv3d(planes, planes * 4, 1, 1, 0, dtype, gen)
        self.bn3 = BatchNorm(planes * 4, bn_groups, gen)
        self._init_shortcut(in_ch, planes * 4, stride, shortcut, bn_groups,
                            gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train)).to(self.dtype)
        out = torch.relu(self.bn2(self.conv2(out), train)).to(self.dtype)
        out = self.bn3(self.conv3(out), train)
        return self._residual(out, x, train)


class ResNet3D(nn.Module):
    """Returns the ``512 * expansion``-d pooled feature (reference
    ``r3d_byol.py:139-207``); blocks are named ``layer{i}_block{j}`` as in
    the JAX package."""

    def __init__(self, block: str = "basic",
                 layers: Tuple[int, int, int, int] = (2, 2, 2, 2),
                 shortcut: str = "B", dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None):
        super().__init__()
        if shortcut not in ("A", "B"):
            raise ValueError(f"--resnet_shortcut must be A or B, got "
                             f"{shortcut!r}")
        self.dtype = dtype
        block_cls = _BasicBlock if block == "basic" else _Bottleneck
        self.conv1 = Conv3d(3, 64, 7, (1, 2, 2), 3, dtype, gen)
        self.bn1 = BatchNorm(64, bn_groups, gen)
        self.names = []
        in_ch = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers)):
            for bi in range(blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                name = f"layer{li + 1}_block{bi + 1}"
                setattr(self, name, block_cls(in_ch, planes, stride, shortcut,
                                              dtype, bn_groups, gen))
                self.names.append(name)
                in_ch = planes * block_cls.expansion

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.conv1(x.to(self.dtype))
        x = torch.relu(self.bn1(x, train)).to(self.dtype)
        x = max_pool_3d(x, 3, 2, 1)
        for name in self.names:
            x = getattr(self, name)(x, train)
        return x.float().mean(dim=(1, 2, 3))
