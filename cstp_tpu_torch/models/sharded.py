"""``--shard_spatial`` on a backbone tower: its H split over the 'model'
ranks, shared by R(2+1)D, C3D and the 3D-ResNets.

The JAX package's ``--shard_spatial`` is one sharding constraint on the
5-D views (``spatial_constraint_fn``) that XLA carries through every conv
and pool. The port splits the tower by hand: each rank keeps its rows of
the input (``parallel.SpatialShard``), each H site (a conv or max pool
whose window spans H or strides it) fetches its neighbours' rows
(``parallel.halo_rows``), the BatchNorms and int8 scales take their
moments and maxima over the shards, and the global pool is a sum over
'model' divided by the global count, so the feature (and all after it) is
the same on every 'model' rank.

A tower lists its H sites (:meth:`ShardedTower.h_sites`): each a module
with ``h_window``, its ``(kernel, stride, padding)`` in H, and a ``shard``
attribute, and the total stride of its input rows, in forward order. The
base derives every stage's global rows from them (a VALID pool's
``floor(h / 2)`` as well as a SAME conv's ``ceil(h / 2)``), hands each site
``(SpatialShard, stride)`` at every forward, and names the parameters
whose gradient each shard holds a part of.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from cstp_tpu_torch.models.layers import BatchNorm, Conv3d
from cstp_tpu_torch.parallel.mesh import (
    SpatialShard,
    mesh_axis,
    reduce_to_replicated,
)


class ShardedTower:
    """Mixin of a backbone ``nn.Module`` whose H splits over 'model'
    under ``--shard_spatial`` (:meth:`shard_spatially`); its forward takes
    its rows by :meth:`own_rows` and pools by :meth:`pooled`."""

    spatial = False

    def h_sites(self) -> List[Tuple[nn.Module, int]]:
        """``(site, total stride of its input rows)`` of every conv and
        pool of the tower, in forward order; sites whose H window is
        ``(1, 1, 0)`` are left out by the base."""
        raise NotImplementedError

    def shard_spatially(self) -> None:
        """Split H over 'model' from the next forward on: records the H
        sites and marks the tower's BatchNorms and convs (a projector's
        BatchNorm stays whole: it runs on the pooled feature, the same on
        every rank)."""
        self._sites = [(m, st) for m, st in self.h_sites()
                       if tuple(m.h_window) != (1, 1, 0)]
        for name, m in self.named_modules():
            if isinstance(m, (BatchNorm, Conv3d)) \
                    and not name.startswith("project"):
                m.spatial = True
        self.spatial = True

    def stage_heights(self, height: int) -> dict:
        """``{total stride: global rows}`` of every stage on frames of
        ``height`` rows."""
        heights = {1: height}
        for site, st in self._sites:
            k, s, p = site.h_window
            h = (heights[st] + 2 * p - k) // s + 1
            if heights.setdefault(st * s, h) != h:
                raise ValueError(f"{type(self).__name__}: two sites give "
                                 f"stride {st * s} {heights[st * s]} and "
                                 f"{h} rows")
        return heights

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This 'model' rank's rows of the input ``x`` (N, T, H, W, C);
        the split is handed to every site for this forward."""
        ax = mesh_axis("model")
        heights = self.stage_heights(x.shape[2])
        shard = SpatialShard(x.shape[2], ax.index, ax.size,
                             tuple(sorted(heights.items())))
        shard.check(sorted(heights))
        for site, stride in self._sites:
            site.shard = (shard, stride)
        self._pool_rows = heights[max(heights)]
        lo, hi = shard.rows()
        return x[:, :, lo:hi]

    def pooled(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 mean of ``x`` (N, T, h, W, C) over T, H and W: on
        H shards the sum over 'model' divided by the global count."""
        if not self.spatial:
            return x.float().mean(dim=(1, 2, 3))
        count = x.shape[1] * self._pool_rows * x.shape[3]
        return reduce_to_replicated(x.float().sum(dim=(1, 2, 3)),
                                    "model") / count


def shard_spatially(module: nn.Module) -> nn.Module:
    """Every tower of ``module`` split over H from its next forward on
    (``--shard_spatial``); a module without one (S3D-G, I3D, SlowFast)
    raises ``NotImplementedError`` (ROADMAP item 17c-ii parts d and e)."""
    towers = [m for m in module.modules() if isinstance(m, ShardedTower)]
    if not towers:
        raise NotImplementedError(
            f"--shard_spatial on {type(module).__name__}: the port splits H "
            "over 'model' in the R(2+1)D, C3D and 3D-ResNet towers; S3D-G "
            "and I3D (TF-SAME pads, self-gating) and SlowFast (laterals) "
            "are ROADMAP item 17c-ii parts d and e")
    for tower in towers:
        tower.shard_spatially()
    return module


def spatially_partial_names(module: nn.Module):
    """The names of ``module``'s parameters whose gradient each H shard
    holds a part of (every split tower's, its projector's excepted): the
    step sums them over 'model'."""
    names = set()
    for prefix, m in module.named_modules():
        if isinstance(m, ShardedTower) and m.spatial:
            names.update(f"{prefix}.{n}" if prefix else n
                         for n, _ in m.named_parameters()
                         if not n.startswith("project."))
    return names
