"""C3D backbone, a plain 5-stage 3D convnet, in PyTorch.

The port of ``cstp_tpu/models/c3d.py`` (reference ``models/pace/c3d_byol.py``):
conv (with bias) -> BN -> ReLU stages, max pools (1,2,2) then (2,2,2) x 3,
global average pool in float32 to a 512-d feature. No projector. NDHWC
activations, ``dtype`` compute, f32 parameters and BN; ``quant``
(``--quant``) reaches every conv. Under ``--shard_spatial``
(``models/sharded.py``) its H sites are the eight convs and the four
VALID pools, which take ``floor(h / 2)`` rows (7 rows pool to 3).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from cstp_tpu_torch.models.layers import BatchNorm, Conv3d, MaxPool3d
from cstp_tpu_torch.models.sharded import ShardedTower

# (stage name, output channels, pool after it or None)
STAGES = (("conv1", 64, (1, 2, 2)), ("conv2", 128, (2, 2, 2)),
          ("conv3a", 256, None), ("conv3b", 256, (2, 2, 2)),
          ("conv4a", 512, None), ("conv4b", 512, (2, 2, 2)),
          ("conv5a", 512, None), ("conv5b", 512, None))


class _ConvBNReLU(nn.Module):
    """3x3x3 conv (stride 1, padding 1, with bias) -> BN -> ReLU."""

    def __init__(self, in_ch: int, features: int, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None,
                 quant: str = ""):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv3d(in_ch, features, 3, 1, 1, dtype, gen,
                           use_bias=True, quant=quant)
        self.bn = BatchNorm(features, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), train)).to(self.dtype)


class C3D(ShardedTower, nn.Module):
    """Returns the 512-d pooled feature (reference ``c3d_byol.py:70-107``);
    the pool after stage ``name`` is ``{name}_pool``."""

    def __init__(self, dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None, quant: str = ""):
        super().__init__()
        self.dtype = dtype
        in_ch = 3
        for name, ch, pool in STAGES:
            setattr(self, name, _ConvBNReLU(in_ch, ch, dtype, bn_groups, gen,
                                            quant))
            if pool is not None:
                setattr(self, f"{name}_pool", MaxPool3d(pool, pool))
            in_ch = ch

    def h_sites(self) -> List[Tuple[nn.Module, int]]:
        sites, stride = [], 1
        for name, _, pool in STAGES:
            sites.append((getattr(self, name).conv, stride))
            if pool is not None:
                sites.append((getattr(self, f"{name}_pool"), stride))
                stride *= pool[1]
        return sites

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.spatial:
            x = self.own_rows(x)
        x = x.to(self.dtype)
        for name, _, pool in STAGES:
            x = getattr(self, name)(x, train)
            if pool is not None:
                x = getattr(self, f"{name}_pool")(x)
        return self.pooled(x)
