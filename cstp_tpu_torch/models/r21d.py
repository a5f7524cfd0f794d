"""R(2+1)D backbone, the flagship CSTP encoder, in PyTorch.

The port of ``cstp_tpu/models/r21d.py`` (reference ``R2Plus1DNet``,
``models/pace/r21d_byol.py:184-229``): a 5-stage ResNet of factorized (2+1)D
convolutions, ``layer_sizes`` blocks per stage, global average pool to a
512-d feature. NDHWC activations, ``dtype`` compute, f32 parameters and BN.
``bn_groups``, ``fused_conv``, ``quant`` (``--quant``, every conv site,
the stem's too, as in the JAX package), ``mid_round`` (``--mid_round``) and
``t_fold`` (``--t_fold``) reach every block; ``s2d_stem`` (``--s2d_stem``)
the stem's spatial conv alone (``models/layers.py SpatioTemporalConv``).

``remat`` recomputes the residual stages ``conv2`` .. ``conv5`` (not the
stem) in the backward pass instead of keeping their activations, as the JAX
package's ``nn.remat``: "full" recomputes everything, "bnrelu" keeps every
convolution's output and recomputes the BatchNorm/ReLU tensors between them
(``save_anything_except_these_names("bnrelu")``). A fused (2+1)D site is one
``autograd.Function`` whose kernels write through ctypes, so no policy can
name its output: under "bnrelu" it recomputes like the rest, launching its
kernels again.

``shard_spatially`` (``--shard_spatial``, the JAX package's
``spatial_constraint_fn``; ``models/sharded.py``) splits H over the 'model'
ranks: each rank keeps its rows of the input (``parallel.SpatialShard``),
each (2+1)D site fetches its neighbours' rows, the BatchNorms sum their
moments over the shards, and the pool is a sum over 'model' divided by
the global count, so the feature (and all after it) is the same on every
'model' rank.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from cstp_tpu_torch.models.layers import (
    BatchNorm,
    MLPHead,
    SpatioTemporalConv,
    running_stats_kept,
)
from cstp_tpu_torch.models.sharded import ShardedTower

LAYER_SIZES = {1: (1, 1, 1, 1), 10: (1, 1, 1, 1), 18: (2, 2, 2, 2),
               34: (3, 4, 6, 3)}


class SpatioTemporalResBlock(nn.Module):
    """conv -> BN -> ReLU -> conv -> BN -> (+shortcut) -> ReLU
    (reference ``r21d_byol.py:100-148``)."""

    def __init__(self, in_ch: int, features: int, downsample: bool = False,
                 dtype=torch.bfloat16, bn_groups: int = 1,
                 fused_conv: bool = False,
                 gen: Optional[torch.Generator] = None, quant: str = "",
                 mid_round: int = 1, t_fold: bool = False):
        super().__init__()
        self.dtype = dtype
        self.downsample = downsample
        stride = (2, 2, 2) if downsample else (1, 1, 1)
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen, quant=quant,
                  mid_round=mid_round, t_fold=t_fold)
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
                 gen: Optional[torch.Generator] = None, quant: str = "",
                 mid_round: int = 1, t_fold: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, bn_groups=bn_groups, fused_conv=fused_conv,
                  gen=gen, quant=quant, mid_round=mid_round, t_fold=t_fold)
        self.block1 = SpatioTemporalResBlock(in_ch, features, downsample, **kw)
        for i in range(layer_size - 1):
            setattr(self, f"block{i + 2}",
                    SpatioTemporalResBlock(features, features, False, **kw))
        self.layer_size = layer_size

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        for i in range(self.layer_size):
            x = getattr(self, f"block{i + 1}")(x, train)
        return x


REMAT_MODES = ("", "full", "bnrelu")


def chain_sites(n: int, t: int, s: int,
                layer_sizes: Tuple[int, int, int, int] = (1, 1, 1, 1),
                mid_round: int = 1):
    """The (2+1)D sites of one R(2+1)D tower on ``n`` clips of ``t x s^2``,
    in forward order: ``(name, input shape (N, T, H, W, Cin), Cout,
    kernel, stride, padding)`` each, the shapes the storage chain's
    kernels see (for their benchmarks and card checks), read off a tower
    that runs on the meta device; its mid widths those of
    ``--mid_round``."""
    with torch.device("meta"):
        model = R2Plus1DNet(layer_sizes, dtype=torch.float32,
                            mid_round=mid_round)
    sites = []
    for name, m in model.named_modules():
        if isinstance(m, SpatioTemporalConv):
            m.register_forward_pre_hook(
                lambda m, a, name=name: sites.append((
                    name, tuple(a[0].shape), m.temporal_conv.weight.shape[0],
                    m.kernel, m.stride, m.padding)))
    with torch.no_grad():
        model(torch.zeros(n, t, s, s, 3, device="meta"), True)
    return sites


def remat_mode(remat: bool, remat_policy: str) -> str:
    """The JAX package's precedence: ``--remat`` (full) over
    ``--remat_policy``."""
    return "full" if remat else remat_policy


def checkpointed(layer: nn.Module, x: torch.Tensor, train: bool,
                 mode: str) -> torch.Tensor:
    """``layer(x, train)`` under non-reentrant checkpointing (the steps take
    gradients with ``torch.autograd.grad``, which reentrant checkpointing
    does not support). The recompute starts from the storage chain's
    ``act_scale_*`` buffers as the forward found them (the delayed scales
    quantize it; the BatchNorms read batch statistics, not their buffers)
    and restores every buffer after, so the BN running statistics and the
    scales advance once per forward, as without remat and as in the JAX
    package's functional remat."""
    scales = [b for n, b in layer.named_buffers()
              if n.rsplit(".", 1)[-1].startswith("act_scale_")]
    entry = []

    @contextlib.contextmanager
    def forwarding(inner):
        entry[:] = [b.clone() for b in scales]
        with inner:
            yield

    @contextlib.contextmanager
    def recomputing(inner):
        with running_stats_kept(layer):
            with torch.no_grad():
                for b, v in zip(scales, entry):
                    b.copy_(v)
            with inner:
                yield

    def contexts():
        if mode == "bnrelu":
            fwd, inner = create_selective_checkpoint_contexts(
                [torch.ops.aten.convolution.default])
        else:
            fwd, inner = contextlib.nullcontext(), contextlib.nullcontext()
        return forwarding(fwd), recomputing(inner)

    return checkpoint(lambda y: layer(y, train), x, use_reentrant=False,
                      context_fn=contexts)


class R2Plus1DNet(ShardedTower, nn.Module):
    """Returns the 512-d pooled feature; with ``proj_flag`` also the 512-d
    BYOL projection (reference ``r21d_byol.py:184-229``)."""

    def __init__(self, layer_sizes: Tuple[int, int, int, int] = (1, 1, 1, 1),
                 proj_flag: bool = False, dtype=torch.bfloat16,
                 bn_groups: int = 1, fused_conv: bool = False,
                 gen: Optional[torch.Generator] = None, remat: str = "",
                 quant: str = "", s2d_stem: bool = False,
                 mid_round: int = 1, t_fold: bool = False):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"remat {remat!r} not in {REMAT_MODES}")
        self.dtype = dtype
        self.proj_flag = proj_flag
        self.remat = remat
        kw = dict(dtype=dtype, bn_groups=bn_groups, gen=gen, quant=quant,
                  mid_round=mid_round, t_fold=t_fold)
        self.conv1 = SpatioTemporalConv(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                                        s2d=s2d_stem, **kw)
        self.bn1 = BatchNorm(64, bn_groups, gen)
        kw["fused_conv"] = fused_conv
        self.conv2 = SpatioTemporalResLayer(64, 64, layer_sizes[0], False, **kw)
        self.conv3 = SpatioTemporalResLayer(64, 128, layer_sizes[1], True, **kw)
        self.conv4 = SpatioTemporalResLayer(128, 256, layer_sizes[2], True,
                                            **kw)
        self.conv5 = SpatioTemporalResLayer(256, 512, layer_sizes[3], True,
                                            **kw)
        if proj_flag:
            self.project = MLPHead(512, 4096, 512, dtype, bn_groups, gen)

    def h_sites(self) -> List[Tuple[nn.Module, int]]:
        """Every (2+1)D site and its input stride (``--shard_spatial``)."""
        sites, stride = [(self.conv1, 1)], self.conv1.stride[1]
        for layer in (self.conv2, self.conv3, self.conv4, self.conv5):
            for i in range(layer.layer_size):
                block = getattr(layer, f"block{i + 1}")
                out = stride * block.conv1.stride[1]
                sites.append((block.conv1, stride))
                sites.append((block.conv2, out))
                if block.downsample:
                    sites.append((block.downsampleconv, stride))
                stride = out
        return sites

    def forward(self, x: torch.Tensor, train: bool = True):
        if self.spatial:
            x = self.own_rows(x)
        x = self.conv1(x.to(self.dtype), train)
        x = torch.relu(self.bn1(x, train)).to(self.dtype)
        # a forward without autograd (the target tower, eval) keeps nothing
        remat = self.remat if torch.is_grad_enabled() else ""
        for layer in (self.conv2, self.conv3, self.conv4, self.conv5):
            if remat:
                x = checkpointed(layer, x, train, remat)
            else:
                x = layer(x, train)
        feat = self.pooled(x)
        if self.proj_flag:
            return feat, self.project(feat, train)
        return feat
