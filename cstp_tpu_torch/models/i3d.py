"""I3D backbone, Inception-3D with TF-style SAME padding, in PyTorch.

The port of ``cstp_tpu/models/i3d.py`` (reference ``models/BE/i3d_byol.py``):
``Unit3D`` (conv with TF-SAME pads, no bias -> BN -> ReLU), TF-SAME max
pools, ``Mixed`` Inception blocks, global average pool in float32 to a
1024-d feature (the BYOL engine L2-normalises it: ``BackboneSpec.l2_feat``).
The module names are the JAX package's, so ``models/bridge.py`` maps
weights by rename. NDHWC activations, ``dtype`` compute, f32 parameters
and BN. ``quant`` (``--quant``) reaches every conv but the conv head's, as
in the JAX package.

TF SAME pads are bottom-heavy: the stem's 7^3 stride-2 conv pads (2, 3)
per axis, which ``Conv3d`` writes into the NDHWC tensor before the conv.
The SAME pools pad ``max(k - s, 0)``, whatever the input's size, so a
stride-2 pool floors at an odd height.

Under ``--shard_spatial`` (``models/sharded.py``) its H sites are the stem
(H pads (2, 3)), the 3^3 convs of ``conv3d_2c_3x3`` and each block (pads
(1, 1)), the four SAME pools between the stages ((1,3,3)/(1,2,2) and
(3,3,3)/2 pad H by (0, 1), (2,2,2)/2 by none) and each block's stride-1
branch-3 pool. The conv head stays whole (``whole``): on H shards its
(2,7,7) mean is a sum over 'model', and the head runs on the same map on
every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cstp_tpu_torch.models.layers import (
    INCEPTION_PLAN,
    BatchNorm,
    Conv3d,
    same_pads,
    same_pool,
)
from cstp_tpu_torch.models.sharded import ShardedTower
from cstp_tpu_torch.parallel.mesh import reduce_to_replicated


class Unit3D(nn.Module):
    """conv (TF SAME, no bias) -> BN -> ReLU (reference ``Unit3Dpy``,
    ``i3d_byol.py:99-168``); ``use_bn`` / ``activation`` switch the BN and
    the ReLU off (the conv head's last unit)."""

    def __init__(self, in_ch: int, features: int, kernel=1, stride=1,
                 use_bn: bool = True, activation: bool = True,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None, quant: str = ""):
        super().__init__()
        self.dtype = dtype
        self.activation = activation
        self.conv = Conv3d(in_ch, features, kernel, stride,
                           same_pads(kernel, stride), dtype, gen, quant=quant)
        self.bn = BatchNorm(features, bn_groups, gen) if use_bn else None

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, train)
        if self.activation:
            x = torch.relu(x)
        return x.to(self.dtype)


class Mixed(nn.Module):
    """4-branch Inception block (reference ``i3d_byol.py:186-221``);
    ``out_channels`` = [b0, b1a, b1b, b2a, b2b, b3]."""

    def __init__(self, in_ch: int, out_channels: Sequence[int],
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None, quant: str = ""):
        super().__init__()
        c = out_channels
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen, quant=quant)
        self.branch_0 = Unit3D(in_ch, c[0], **kw)
        self.branch_1_0 = Unit3D(in_ch, c[1], **kw)
        self.branch_1_1 = Unit3D(c[1], c[2], 3, **kw)
        self.branch_2_0 = Unit3D(in_ch, c[3], **kw)
        self.branch_2_1 = Unit3D(c[3], c[4], 3, **kw)
        self.branch_3_0 = same_pool(3, 1)
        self.branch_3_1 = Unit3D(in_ch, c[5], **kw)
        self.out_ch = c[0] + c[2] + c[4] + c[5]

    def h_sites(self, stride: int):
        """Its H sites on input rows of total stride ``stride``."""
        return [(self.branch_1_1.conv, stride), (self.branch_2_1.conv, stride),
                (self.branch_3_0, stride)]

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return torch.cat([
            self.branch_0(x, train),
            self.branch_1_1(self.branch_1_0(x, train), train),
            self.branch_2_1(self.branch_2_0(x, train), train),
            self.branch_3_1(self.branch_3_0(x), train)], dim=-1)


# the stem's units, then block name -> out_planes
STEM = ("conv3d_1a_7x7", "conv3d_2b_1x1", "conv3d_2c_3x3")
MIXED = tuple((f"mixed_{k}", plan) for k, plan in INCEPTION_PLAN)
# the TF-SAME max pools: name -> (kernel, stride), and the block each
# stands before (maxPool3d_2a_3x3 after the stem)
POOLS = {"maxPool3d_2a_3x3": ((1, 3, 3), (1, 2, 2)),
         "maxPool3d_3a_3x3": ((1, 3, 3), (1, 2, 2)),
         "maxPool3d_4a_3x3": ((3, 3, 3), (2, 2, 2)),
         "maxPool3d_5a_2x2": ((2, 2, 2), (2, 2, 2))}
_POOL_BEFORE = {"mixed_3b": "maxPool3d_3a_3x3",
                "mixed_4b": "maxPool3d_4a_3x3",
                "mixed_5b": "maxPool3d_5a_2x2"}
HEAD_MAP = 7            # the conv head's (2, 7, 7) window: 224^2 inputs


class I3D(ShardedTower, nn.Module):
    """The 1024-d pooled feature extractor (reference ``i3d_byol.py:223-426``,
    RGB modality).

    ``conv_head`` builds the reference finetune classifier inside the
    backbone (``i3d_byol.py:295-306``, forward ``405-412``): AvgPool3d
    ((2,7,7), stride 1; the mean taken in float32) ->
    ``conv3d_0c_1x1_custom``, a (7,1,1) SAME conv 1024 -> ``num_classes``
    without BN or ReLU -> float32 mean over T, H, W; it returns the
    logits. The (2,7,7) window needs a (T>=2, 7, 7) final
    map, i.e. 224^2 inputs of 16 frames or more; any other raises
    ``ValueError``, as in the JAX package. On H shards the map's rows are
    the frame's (the check reads the global rows), its window mean is the
    sum over this rank's rows and over 'model' (``reduce_to_replicated``:
    all after it is alike on every rank), and the head is whole."""

    whole = ("project", "conv3d_0c_1x1_custom")

    def __init__(self, dtype=torch.bfloat16, bn_groups: int = 1,
                 conv_head: bool = False, num_classes: int = 0,
                 gen: Optional[torch.Generator] = None, quant: str = ""):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen, quant=quant)
        self.conv3d_1a_7x7 = Unit3D(3, 64, 7, 2, **kw)
        self.conv3d_2b_1x1 = Unit3D(64, 64, **kw)
        self.conv3d_2c_3x3 = Unit3D(64, 192, 3, **kw)
        in_ch = 192
        for name, plan in MIXED:
            block = Mixed(in_ch, plan, **kw)
            setattr(self, name, block)
            in_ch = block.out_ch
        self.conv_head = conv_head
        if conv_head:
            self.conv3d_0c_1x1_custom = Unit3D(
                in_ch, num_classes, (7, 1, 1), use_bn=False,
                activation=False, dtype=dtype, gen=gen)
        for name, pool in POOLS.items():
            setattr(self, name, same_pool(*pool))

    def h_sites(self):
        sites = [(self.conv3d_1a_7x7.conv, 1), (self.maxPool3d_2a_3x3, 2),
                 (self.conv3d_2c_3x3.conv, 4)]
        stride = 4
        for name, _ in MIXED:
            if name in _POOL_BEFORE:
                pool = getattr(self, _POOL_BEFORE[name])
                sites.append((pool, stride))
                stride *= pool.stride[1]
            sites += getattr(self, name).h_sites(stride)
        return sites

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.spatial:
            x = self.own_rows(x)
        x = self.conv3d_1a_7x7(x.to(self.dtype), train)
        x = self.maxPool3d_2a_3x3(x)
        x = self.conv3d_2c_3x3(self.conv3d_2b_1x1(x, train), train)
        for name, _ in MIXED:
            if name in _POOL_BEFORE:
                x = getattr(self, _POOL_BEFORE[name])(x)
            x = getattr(self, name)(x, train)
        if self.conv_head:
            return self.head(x, train)
        return self.pooled(x)

    def head(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """The conv head's logits from the final map ``x`` (N, T, h, W, C),
        this rank's rows of it on H shards."""
        rows = self._pool_rows if self.spatial else x.shape[2]
        if x.shape[1] < 2 or rows != HEAD_MAP or x.shape[3] != HEAD_MAP:
            raise ValueError(
                "i3d conv_head (the reference classifier) requires a "
                "(T>=2, 7, 7) final feature map, i.e. sample_size 224 "
                "and sample_duration >= 16; got map "
                f"{(x.shape[1], rows, x.shape[3])}. Use the generic head "
                "(--i3d_conv_head 0) for other input sizes.")
        if self.spatial:
            # the (2, 7, 7) window holds the whole map: a T-window mean of
            # the frame's sums, which a sum over 'model' completes
            s = reduce_to_replicated(x.float().sum(dim=(2, 3)), "model")
            x = ((s[:, :-1] + s[:, 1:]) / (2 * HEAD_MAP * HEAD_MAP))
            x = x[:, :, None, None].to(self.dtype)
        else:
            # the window's mean in float32, back to dtype for the conv
            x = F.avg_pool3d(x.float().permute(0, 4, 1, 2, 3), (2, 7, 7),
                             1).permute(0, 2, 3, 4, 1).to(self.dtype)
        x = self.conv3d_0c_1x1_custom(x, train)
        return x.float().mean(dim=(1, 2, 3))
