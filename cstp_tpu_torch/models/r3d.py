"""3D ResNet backbone (depths 10/18/34 basic, 50/101/152/200 bottleneck),
in PyTorch.

The port of ``cstp_tpu/models/r3d.py`` (reference ``models/BE/r3d_byol.py``):
stem conv 7^3 stride (1,2,2) padding 3 -> BN -> ReLU, max pool 3^3 stride 2
padding 1, four stages of ``layers`` blocks (the first of stages 2-4 with
stride 2), global average pool in float32 to ``512 * expansion``. The
shortcut of a block that changes shape is "A" (strided subsample, then the
channels zero-padded; no parameters) or "B" (1x1x1 conv with the stride,
then BN). No projector. ``bn_groups`` reaches every block and ``quant``
(``--quant``) every conv. Under ``--shard_spatial``
(``models/sharded.py``) its H sites are the stem, the pool, each block's
3x3x3 convs and its shortcut (the 1x1x1 conv of "B", the subsample of
"A"); the 1x1x1 stride-1 convs of the bottleneck need no other rows.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cstp_tpu_torch.models.layers import (
    BatchNorm,
    Conv3d,
    MaxPool3d,
    Subsample,
)
from cstp_tpu_torch.models.sharded import ShardedTower

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
        self.identity = stride == 1 and in_ch == out_ch
        if self.identity:
            return
        if shortcut == "B":
            self.downsample_conv = Conv3d(in_ch, out_ch, 1, stride, 0,
                                          self.dtype, gen, quant=self.quant)
            self.downsample_bn = BatchNorm(out_ch, bn_groups, gen)
        else:
            self.subsample = Subsample(stride)

    def _shortcut_sites(self, stride: int):
        if self.identity:
            return []
        return [(self.subsample if self.shortcut == "A"
                 else self.downsample_conv, stride)]

    def _shortcut(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.identity:
            return x
        if self.shortcut == "A":
            return F.pad(self.subsample(x), (0, self.out_ch - self.in_ch))
        return self.downsample_bn(self.downsample_conv(x), train)

    def _residual(self, out, x, train: bool) -> torch.Tensor:
        res = self._shortcut(x, train)
        return torch.relu(out.float() + res.float()).to(self.dtype)


class _BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 shortcut: str = "B", dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None, quant: str = ""):
        super().__init__()
        self.dtype, self.quant = dtype, quant
        self.conv1 = Conv3d(in_ch, planes, 3, stride, 1, dtype, gen,
                            quant=quant)
        self.bn1 = BatchNorm(planes, bn_groups, gen)
        self.conv2 = Conv3d(planes, planes, 3, 1, 1, dtype, gen, quant=quant)
        self.bn2 = BatchNorm(planes, bn_groups, gen)
        self._init_shortcut(in_ch, planes, stride, shortcut, bn_groups, gen)

    def h_sites(self, stride: int):
        """Its H sites on input rows of total stride ``stride``."""
        return ([(self.conv1, stride), (self.conv2, stride * self.stride)]
                + self._shortcut_sites(stride))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train)).to(self.dtype)
        out = self.bn2(self.conv2(out), train)
        return self._residual(out, x, train)


class _Bottleneck(_Block):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 shortcut: str = "B", dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None, quant: str = ""):
        super().__init__()
        self.dtype, self.quant = dtype, quant
        self.conv1 = Conv3d(in_ch, planes, 1, 1, 0, dtype, gen, quant=quant)
        self.bn1 = BatchNorm(planes, bn_groups, gen)
        self.conv2 = Conv3d(planes, planes, 3, stride, 1, dtype, gen,
                            quant=quant)
        self.bn2 = BatchNorm(planes, bn_groups, gen)
        self.conv3 = Conv3d(planes, planes * 4, 1, 1, 0, dtype, gen,
                            quant=quant)
        self.bn3 = BatchNorm(planes * 4, bn_groups, gen)
        self._init_shortcut(in_ch, planes * 4, stride, shortcut, bn_groups,
                            gen)

    def h_sites(self, stride: int):
        """Its H sites on input rows of total stride ``stride``."""
        return ([(self.conv1, stride), (self.conv2, stride),
                 (self.conv3, stride * self.stride)]
                + self._shortcut_sites(stride))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train)).to(self.dtype)
        out = torch.relu(self.bn2(self.conv2(out), train)).to(self.dtype)
        out = self.bn3(self.conv3(out), train)
        return self._residual(out, x, train)


class ResNet3D(ShardedTower, nn.Module):
    """Returns the ``512 * expansion``-d pooled feature (reference
    ``r3d_byol.py:139-207``); blocks are named ``layer{i}_block{j}`` as in
    the JAX package."""

    def __init__(self, block: str = "basic",
                 layers: Tuple[int, int, int, int] = (2, 2, 2, 2),
                 shortcut: str = "B", dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None,
                 quant: str = ""):
        super().__init__()
        if shortcut not in ("A", "B"):
            raise ValueError(f"--resnet_shortcut must be A or B, got "
                             f"{shortcut!r}")
        self.dtype = dtype
        block_cls = _BasicBlock if block == "basic" else _Bottleneck
        self.conv1 = Conv3d(3, 64, 7, (1, 2, 2), 3, dtype, gen, quant=quant)
        self.bn1 = BatchNorm(64, bn_groups, gen)
        self.pool = MaxPool3d(3, 2, 1)
        self.names = []
        in_ch = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers)):
            for bi in range(blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                name = f"layer{li + 1}_block{bi + 1}"
                setattr(self, name, block_cls(in_ch, planes, stride, shortcut,
                                              dtype, bn_groups, gen, quant))
                self.names.append(name)
                in_ch = planes * block_cls.expansion

    def h_sites(self) -> List[Tuple[nn.Module, int]]:
        sites, stride = [(self.conv1, 1), (self.pool, 2)], 4
        for name in self.names:
            block = getattr(self, name)
            sites += block.h_sites(stride)
            stride *= block.stride
        return sites

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.spatial:
            x = self.own_rows(x)
        x = self.conv1(x.to(self.dtype))
        x = torch.relu(self.bn1(x, train)).to(self.dtype)
        x = self.pool(x)
        for name in self.names:
            x = getattr(self, name)(x, train)
        return self.pooled(x)
