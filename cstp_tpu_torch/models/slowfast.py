"""SlowFast two-pathway video network, in PyTorch.

The port of ``cstp_tpu/models/slowfast.py`` (SlowFast networks,
Feichtenhofer et al., arXiv:1812.03982; the reference's ``slowfast_fb``).
The module takes only the FAST clip ``(B, T, H, W, 3)``; the slow pathway
runs on ``x[:, ::alpha]``, so both see the same time span and the loaders
need no second clip (their frame stride is ``tau // alpha``,
``Config.clip_stride``). ``T`` must be a multiple of ``alpha``.

Stems: slow 1x7x7 to 64 channels, fast 5x7x7 to 8 (the paper's beta 1/8),
each with BN, ReLU and a (1,3,3) max pool. Four stages of basic (depth
18/34) or bottleneck (50/101) blocks with spatial-only strides; the slow
pathway's temporal kernels are (1, 1, 3, 3) by stage, the fast pathway's
3. A lateral ``(5,1,1)`` conv with temporal stride ``alpha`` (pad 2) takes
the fast pathway to ``T / alpha`` frames and twice its width, and is
concatenated onto the slow pathway after the stem and after each of the
first three stages. The Flax modules infer their input widths; here they
are written out. With the laterals the slow stages take 80 / 80 / 160 /
320 (basic) or 80 / 320 / 640 / 1280 (bottleneck) channels, so the first
block of every stage has a projection shortcut, stride 1 or not. Both
pathways are pooled in float32 and concatenated slow first: ``576``
features at depth 18/34, ``2304`` at 50/101.

Blocks sum their residual and take the ReLU in float32, then cast to
``dtype``. ``bn_groups`` reaches every BatchNorm, the laterals' too, and
``quant`` (``--quant``) every conv of both pathways and the laterals. The
module names are the JAX package's (``slow_conv1``, ``fast_bn1``,
``lateral_pool1``, ``slow_layer{i}_block{j}``, ``lateral_res{i}``), so
``models/bridge.py`` maps weights by rename; ``_Lateral``'s norm is itself
named ``bn``, its Flax leaves sit at ``lateral_pool1/bn/bn/*``.

Under ``--shard_spatial`` (``models/sharded.py``) both pathways split H
over 'model' on one ``SpatialShard``: their spatial strides agree at every
point (both stems and both stem pools stride 2, each stage's first block
2), so one list of stage heights serves both. The H sites are the two
stems, the two stem pools (``MaxPool3d`` modules, no parameters: the
state-dict names are unchanged) and each block's (k, 3, 3) convs and
strided projection; the laterals are (5,1,1) convs, no H site, and join
rows of the same shard. Their BatchNorms and int8 scales, like every
other, are taken over the shards.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from cstp_tpu_torch.models.layers import BatchNorm, Conv3d, MaxPool3d
from cstp_tpu_torch.models.sharded import ShardedTower

# depth -> (block, per-stage block counts, expansion); the 3D-ResNet table
SLOWFAST_LAYERS = {
    18: ("basic", (2, 2, 2, 2), 1),
    34: ("basic", (3, 4, 6, 3), 1),
    50: ("bottleneck", (3, 4, 6, 3), 4),
    101: ("bottleneck", (3, 4, 23, 3), 4),
}
SLOW_T_KERNELS = (1, 1, 3, 3)   # by stage; the fast pathway's are all 3
FAST_WIDTH = 8                  # the fast stem's width: 64 * beta, beta 1/8


def slowfast_feat_dim(depth: int) -> int:
    _, _, expansion = SLOWFAST_LAYERS.get(depth, SLOWFAST_LAYERS[18])
    return (512 + 8 * FAST_WIDTH) * expansion


class _SFBlock(nn.Module):
    """The shortcut and residual sum of both block kinds: a projection
    (1x1x1 conv with the spatial stride, then BN) when the stride or the
    width changes, ``relu(out + shortcut)`` in float32, back to ``dtype``."""

    def _init_shortcut(self, in_ch: int, out_ch: int, stride: int,
                       bn_groups: int, gen):
        self.stride = stride
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            self.downsample_conv = Conv3d(in_ch, out_ch, 1,
                                          (1, stride, stride), 0, self.dtype,
                                          gen, quant=self.quant)
            self.downsample_bn = BatchNorm(out_ch, bn_groups, gen)

    def _shortcut_sites(self, stride: int):
        return [(self.downsample_conv, stride)] if self.project else []

    def _residual(self, out, x, train: bool) -> torch.Tensor:
        res = (self.downsample_bn(self.downsample_conv(x), train)
               if self.project else x)
        return torch.relu(out.float() + res.float()).to(self.dtype)


class _SFBasic(_SFBlock):
    """Basic block: (kt,3,3) conv with the spatial stride, then (1,3,3)."""

    expansion = 1

    def __init__(self, in_ch: int, planes: int, t_kernel: int = 1,
                 stride: int = 1, dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None, quant: str = ""):
        super().__init__()
        self.dtype, self.quant = dtype, quant
        kt, pt = t_kernel, t_kernel // 2
        self.conv1 = Conv3d(in_ch, planes, (kt, 3, 3), (1, stride, stride),
                            (pt, 1, 1), dtype, gen, quant=quant)
        self.bn1 = BatchNorm(planes, bn_groups, gen)
        self.conv2 = Conv3d(planes, planes, (1, 3, 3), 1, (0, 1, 1), dtype,
                            gen, quant=quant)
        self.bn2 = BatchNorm(planes, bn_groups, gen)
        self._init_shortcut(in_ch, planes, stride, bn_groups, gen)

    def h_sites(self, stride: int):
        """Its H sites on input rows of total stride ``stride``."""
        return ([(self.conv1, stride), (self.conv2, stride * self.stride)]
                + self._shortcut_sites(stride))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train)).to(self.dtype)
        out = self.bn2(self.conv2(out), train)
        return self._residual(out, x, train)


class _SFBottleneck(_SFBlock):
    """Bottleneck block; the temporal kernel is on the first 1x1 conv."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, t_kernel: int = 1,
                 stride: int = 1, dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None, quant: str = ""):
        super().__init__()
        self.dtype, self.quant = dtype, quant
        kt, pt = t_kernel, t_kernel // 2
        self.conv1 = Conv3d(in_ch, planes, (kt, 1, 1), 1, (pt, 0, 0), dtype,
                            gen, quant=quant)
        self.bn1 = BatchNorm(planes, bn_groups, gen)
        self.conv2 = Conv3d(planes, planes, (1, 3, 3), (1, stride, stride),
                            (0, 1, 1), dtype, gen, quant=quant)
        self.bn2 = BatchNorm(planes, bn_groups, gen)
        self.conv3 = Conv3d(planes, planes * 4, 1, 1, 0, dtype, gen,
                            quant=quant)
        self.bn3 = BatchNorm(planes * 4, bn_groups, gen)
        self._init_shortcut(in_ch, planes * 4, stride, bn_groups, gen)

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


class _Lateral(nn.Module):
    """Fast -> slow lateral: a (5,1,1) conv with temporal stride ``alpha``
    (pad 2) to twice the fast width, BN, ReLU."""

    def __init__(self, fast_ch: int, alpha: int, dtype=torch.bfloat16,
                 bn_groups: int = 1, gen: Optional[torch.Generator] = None,
                 quant: str = ""):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv3d(fast_ch, 2 * fast_ch, (5, 1, 1), (alpha, 1, 1),
                           (2, 0, 0), dtype, gen, quant=quant)
        self.bn = BatchNorm(2 * fast_ch, bn_groups, gen)

    def forward(self, fast: torch.Tensor, train: bool = True) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(fast), train)).to(self.dtype)


class SlowFastNet(ShardedTower, nn.Module):
    """Returns the concatenated pooled features of both pathways,
    ``slowfast_feat_dim(depth)`` of them. A depth without a layout builds
    depth 18. The shortcuts are projections only (the registry ignores
    ``--resnet_shortcut`` here, as the JAX package does)."""

    def __init__(self, depth: int = 18, alpha: int = 4,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 gen: Optional[torch.Generator] = None, quant: str = ""):
        super().__init__()
        block, counts, _ = SLOWFAST_LAYERS.get(depth, SLOWFAST_LAYERS[18])
        block_cls = _SFBasic if block == "basic" else _SFBottleneck
        self.alpha = alpha
        self.dtype = dtype
        cf = FAST_WIDTH
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen, quant=quant)
        self.slow_conv1 = Conv3d(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                                 dtype, gen, quant=quant)
        self.slow_bn1 = BatchNorm(64, bn_groups, gen)
        self.fast_conv1 = Conv3d(3, cf, (5, 7, 7), (1, 2, 2), (2, 3, 3),
                                 dtype, gen, quant=quant)
        self.fast_bn1 = BatchNorm(cf, bn_groups, gen)
        self.slow_pool = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.fast_pool = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.lateral_pool1 = _Lateral(cf, alpha, **kw)
        slow_ch, fast_ch = 64 + 2 * cf, cf
        self.stages = []
        for li, blocks in enumerate(counts):
            names = []
            planes_s, planes_f = 64 * 2 ** li, cf * 2 ** li
            for bi in range(blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                s_name = f"slow_layer{li + 1}_block{bi + 1}"
                f_name = f"fast_layer{li + 1}_block{bi + 1}"
                setattr(self, s_name, block_cls(
                    slow_ch, planes_s, SLOW_T_KERNELS[li], stride, **kw))
                setattr(self, f_name, block_cls(fast_ch, planes_f, 3, stride,
                                                **kw))
                slow_ch = planes_s * block_cls.expansion
                fast_ch = planes_f * block_cls.expansion
                names.append((s_name, f_name))
            lateral = None
            if li < len(counts) - 1:     # no lateral after the last stage
                lateral = f"lateral_res{li + 2}"
                setattr(self, lateral, _Lateral(fast_ch, alpha, **kw))
                slow_ch += 2 * fast_ch
            self.stages.append((names, lateral))

    def h_sites(self) -> List[Tuple[nn.Module, int]]:
        """Both pathways' sites, each stage's slow block before its fast
        block; the strides agree, so the heights do."""
        sites = [(self.slow_conv1, 1), (self.fast_conv1, 1),
                 (self.slow_pool, 2), (self.fast_pool, 2)]
        stride = 4
        for names, _ in self.stages:
            for s_name, f_name in names:
                slow, fast = getattr(self, s_name), getattr(self, f_name)
                sites += slow.h_sites(stride) + fast.h_sites(stride)
                stride *= slow.stride
        return sites

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if x.shape[1] % self.alpha:
            raise ValueError(f"fast-path length {x.shape[1]} not divisible "
                             f"by alpha={self.alpha}")
        if self.spatial:
            x = self.own_rows(x)
        x = x.to(self.dtype)
        slow, fast = x[:, ::self.alpha], x
        slow = torch.relu(self.slow_bn1(self.slow_conv1(slow), train)
                          ).to(self.dtype)
        slow = self.slow_pool(slow)
        fast = torch.relu(self.fast_bn1(self.fast_conv1(fast), train)
                          ).to(self.dtype)
        fast = self.fast_pool(fast)
        slow = torch.cat([slow, self.lateral_pool1(fast, train)], dim=-1)
        for names, lateral in self.stages:
            for s_name, f_name in names:
                slow = getattr(self, s_name)(slow, train)
                fast = getattr(self, f_name)(fast, train)
            if lateral is not None:
                slow = torch.cat([slow, getattr(self, lateral)(fast, train)],
                                 dim=-1)
        return torch.cat([self.pooled(slow), self.pooled(fast)], dim=-1)
