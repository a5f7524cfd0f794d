"""S3D-G backbone, a separable-Inception video network with self-gating, in
PyTorch.

The port of ``cstp_tpu/models/s3dg.py`` (reference ``models/coclr/s3dg.py``):
``BasicConv3d`` (conv -> BN -> ReLU), ``STConv3d`` (a (1,k,k) spatial conv
-> BN -> ReLU, then a (k,1,1) temporal conv -> BN -> ReLU), ``SepInception``
blocks with an optional ``SelfGating`` per branch, and the stem with
temporal stride 2 (1 with ``slow``). Global average pool in float32 to a
1024-d feature; with ``proj_flag`` a 1024 -> h1024 -> 1024 projector. The
module names are the JAX package's, so ``models/bridge.py`` maps weights by
rename. NDHWC activations, ``dtype`` compute, f32 parameters and BN;
``quant`` (``--quant``) reaches every conv.

``STConv3d`` is a spatial -> BN -> ReLU -> temporal chain like R(2+1)D's,
but the JAX package never sends it through ``fused_st_conv`` (``fused_conv``
reaches R(2+1)D only), so neither does the port.

Under ``--shard_spatial`` (``models/sharded.py``) its H sites are the
stem's (1,7,7) stride-2 conv (or the space-to-depth stem, below), every
(1,3,3) conv of ``STConv3d``, the four max pools between the stages and
each block's stride-1 branch-3 pool; its gates take their means over
'model' (``layers.py SelfGating``); the projector stays whole.

``s2d_stem`` (``--s2d_stem``) is the reference's legacy stem (``pace/
s3d_g.py:229-231, 280-299``), as in the JAX package: the space-to-depth
permutation :func:`space_to_depth_stem` (T, H and W halved, 24 channels),
then ``Conv_1a`` a ``BasicConv3d`` with a (2, 4, 4) kernel of stride 1 and
padding (1, 2, 2), then the first plane on T, H and W trimmed off. Its
parameters differ in shape from the separable stem's: ``Conv_1a.conv``
``(64, 24, 2, 4, 4)``, one BatchNorm ``Conv_1a.bn``. The legacy S3D-G
(``models/legacy.py``) uses the same permutation.

On H shards (:class:`S2DStem`, the stem around ``Conv_1a``; no
parameter of its own) the permutation is an H site of window
(2, 2, 0) and the conv reads one row above and two below the rows its
trimmed output keeps; the BatchNorm's moments take the trimmed plane, row
and column too, as in the whole frame, so rank 0 computes the frame's row
0 of the conv as well and drops it after the ReLU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cstp_tpu_torch.models.layers import (
    INCEPTION_PLAN,
    BatchNorm,
    Conv3d,
    MaxPool3d,
    MLPHead,
    SelfGating,
)
from cstp_tpu_torch.models.sharded import ShardedTower
from cstp_tpu_torch.parallel.mesh import SpatialShard, halo_rows


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
                 gen: Optional[torch.Generator] = None, quant: str = ""):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv3d(in_ch, features, kernel, stride, padding, dtype,
                           gen, quant=quant)
        self.bn = BatchNorm(features, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), train)).to(self.dtype)


class S2DStem(nn.Module):
    """The space-to-depth stem around ``Conv_1a`` (``--s2d_stem``):
    :func:`space_to_depth_stem`, then the unit (a ``BasicConv3d``: a (2,
    4, 4) conv of padding (1, 2, 2) -> BN -> ReLU), then the first plane
    on T, H and W trimmed off. It holds no parameter: the unit is the
    tower's ``Conv_1a``, handed to each call.

    ``shard`` (``--shard_spatial``; set by the tower): ``(SpatialShard,
    stride)``. The permutation is then an H site of window (2, 2, 0): a
    rank whose rows end on an odd row takes the next one from below. The
    conv's kept rows are the next stage's rows of the rank (trimmed row
    ``r`` is the conv's row ``r + 1``, which reads the permuted rows ``r -
    1`` to ``r + 2``: a window of 4 with pads (1, 2)); rank 0 also
    computes the conv's row 0 (one more zero row above), so that the
    BatchNorm's moments, like the whole frame's, take it, and drops it
    after the ReLU. Every rank trims T and W. Its H window is the
    permutation's, (2, 2, 0): the stem keeps the stride-2 stage's rows."""

    shard: Optional[Tuple[SpatialShard, int]] = None
    h_window = (2, 2, 0)

    def forward(self, x: torch.Tensor, unit: BasicConv3d,
                train: bool = True) -> torch.Tensor:
        if self.shard is None:
            y = unit.conv(space_to_depth_stem(x))
            first = 1
        else:
            shard, stride = self.shard
            held = space_to_depth_stem(halo_rows(x, shard, stride,
                                                 *self.h_window))
            x = halo_rows(held, shard, 2 * stride, 4, 1, (1, 2))
            first = int(shard.rows(2 * stride)[0] == 0)
            if first:                    # the frame's row 0 reads row -2
                x = F.pad(x, (0, 0, 0, 0, 1, 0))
            y = unit.conv(x, h_halo=True, held=held)
        y = torch.relu(unit.bn(y, train)).to(unit.dtype)
        return y[:, 1:, first:, 1:]


class STConv3d(nn.Module):
    """Separable conv: (1,k,k) spatial + BN + ReLU, then (k,1,1) temporal +
    BN + ReLU (reference ``s3dg.py:62-97``); ``stride`` is (temporal,
    spatial)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride=(1, 1), padding: int = 0, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None,
                 quant: str = ""):
        super().__init__()
        k, p = kernel, padding
        ts, ss = stride
        self.dtype = dtype
        self.conv1 = Conv3d(in_ch, features, (1, k, k), (1, ss, ss),
                            (0, p, p), dtype, gen, quant=quant)
        self.bn1 = BatchNorm(features, bn_groups, gen)
        self.conv2 = Conv3d(features, features, (k, 1, 1), (ts, 1, 1),
                            (p, 0, 0), dtype, gen, quant=quant)
        self.bn2 = BatchNorm(features, bn_groups, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x), train)).to(self.dtype)
        return torch.relu(self.bn2(self.conv2(x), train)).to(self.dtype)


class SepInception(nn.Module):
    """4-branch separable Inception block (reference ``s3dg.py:113-163``);
    ``out_planes`` = [b0, b1a, b1b, b2a, b2b, b3b]."""

    def __init__(self, in_ch: int, out_planes: Sequence[int],
                 gating: bool = False, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None,
                 quant: str = ""):
        super().__init__()
        p0, p1a, p1b, p2a, p2b, p3b = out_planes
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen, quant=quant)
        self.branch0 = BasicConv3d(in_ch, p0, **kw)
        self.branch1_0 = BasicConv3d(in_ch, p1a, **kw)
        self.branch1_1 = STConv3d(p1a, p1b, 3, (1, 1), 1, **kw)
        self.branch2_0 = BasicConv3d(in_ch, p2a, **kw)
        self.branch2_1 = STConv3d(p2a, p2b, 3, (1, 1), 1, **kw)
        self.branch3_1 = BasicConv3d(in_ch, p3b, **kw)
        self.branch3_0 = MaxPool3d(3, 1, 1)
        self.gating = gating
        self.out_ch = p0 + p1b + p2b + p3b
        if gating:
            for i, c in enumerate((p0, p1b, p2b, p3b)):
                setattr(self, f"gating_b{i}", SelfGating(c, gen))

    def h_sites(self, stride: int):
        """Its H sites on input rows of total stride ``stride``."""
        return [(self.branch1_1.conv1, stride), (self.branch2_1.conv1, stride),
                (self.branch3_0, stride)]

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        xs = [self.branch0(x, train),
              self.branch1_1(self.branch1_0(x, train), train),
              self.branch2_1(self.branch2_0(x, train), train),
              self.branch3_1(self.branch3_0(x), train)]
        if self.gating:
            xs = [getattr(self, f"gating_b{i}")(v) for i, v in enumerate(xs)]
        return torch.cat(xs, dim=-1)


# block name -> out_planes
MIXED = tuple((f"Mixed_{k}", plan) for k, plan in INCEPTION_PLAN)
# the max pools: name -> (kernel, stride, padding), and the block each
# stands before (MaxPool_2a after the stem)
POOLS = {"MaxPool_2a": ((1, 3, 3), (1, 2, 2), (0, 1, 1)),
         "MaxPool_3a": ((1, 3, 3), (1, 2, 2), (0, 1, 1)),
         "MaxPool_4a": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
         "MaxPool_5a": ((2, 2, 2), (2, 2, 2), (0, 0, 0))}
_POOL_BEFORE = {"Mixed_3b": "MaxPool_3a", "Mixed_4b": "MaxPool_4a",
                "Mixed_5b": "MaxPool_5a"}


class S3D(ShardedTower, nn.Module):
    """The 1024-d feature extractor (reference ``s3dg.py:166-248``);
    ``gating`` adds S3D-G's self-gating to every branch, ``slow`` keeps the
    stem's temporal stride at 1, ``s2d_stem`` takes the space-to-depth stem
    (not with ``slow``), ``proj_flag`` returns ``(feat, proj)``."""

    def __init__(self, gating: bool = True, slow: bool = False,
                 proj_flag: bool = False, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None,
                 quant: str = "", s2d_stem: bool = False):
        super().__init__()
        if s2d_stem and slow:
            raise ValueError("S3D: the space-to-depth stem and the slow "
                             "stem are exclusive")
        self.dtype = dtype
        self.s2d_stem = s2d_stem
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen, quant=quant)
        if s2d_stem:
            self.Conv_1a = BasicConv3d(24, 64, (2, 4, 4), 1, (1, 2, 2), **kw)
            self.Conv_1a_s2d = S2DStem()
        else:
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
        for name, pool in POOLS.items():
            setattr(self, name, MaxPool3d(*pool))

    def h_sites(self) -> List[Tuple[nn.Module, int]]:
        stem = self.Conv_1a_s2d if self.s2d_stem else self.Conv_1a.conv1
        sites = [(stem, 1), (self.MaxPool_2a, 2), (self.Conv_2c.conv1, 4)]
        stride = 4
        for name, _ in MIXED:
            if name in _POOL_BEFORE:
                pool = getattr(self, _POOL_BEFORE[name])
                sites.append((pool, stride))
                stride *= pool.stride[1]
            sites += getattr(self, name).h_sites(stride)
        return sites

    def forward(self, x: torch.Tensor, train: bool = True):
        if self.spatial:
            x = self.own_rows(x)
        x = x.to(self.dtype)
        if self.s2d_stem:
            x = self.Conv_1a_s2d(x, self.Conv_1a, train)
        else:
            x = self.Conv_1a(x, train)
        x = self.MaxPool_2a(x)
        x = self.Conv_2c(self.Conv_2b(x, train), train)
        for name, _ in MIXED:
            if name in _POOL_BEFORE:
                x = getattr(self, _POOL_BEFORE[name])(x)
            x = getattr(self, name)(x, train)
        feat = self.pooled(x)
        if self.project is not None:
            return feat, self.project(feat, train)
        return feat
