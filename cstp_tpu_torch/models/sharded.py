"""``--shard_spatial`` on a backbone tower: its H split over the 'model'
ranks, shared by every family: R(2+1)D, C3D, the 3D-ResNets, S3D-G, I3D
and SlowFast (both pathways on one split).

The JAX package's ``--shard_spatial`` is one sharding constraint on the
5-D views (``spatial_constraint_fn``) that XLA carries through every conv
and pool. The port splits the tower by hand: each rank keeps its rows of
the input (``parallel.SpatialShard``), each H site (a conv or max pool
whose window spans H or strides it) fetches its neighbours' rows
(``parallel.halo_rows``), the BatchNorms and int8 scales take their
moments and maxima over the shards, S3D-G's gates their means over
'model' (``layers.py SelfGating``), and the global pool is a sum over
'model' divided by the global count, so the feature (and all after it) is
the same on every 'model' rank.

A tower lists its H sites (:meth:`ShardedTower.h_sites`): each a module
with ``h_window``, its ``(kernel, stride, padding)`` in H (the padding an
int, or a TF-SAME ``(lo, hi)`` pair), and a ``shard`` attribute, and the
total stride of its input rows, in forward order. The base derives every
stage's global rows from them, ``(h + lo + hi - k) // s + 1`` (a VALID
pool's ``floor(h / 2)``, a SAME conv's ``ceil(h / 2)``, and a SAME pool's
``max(k - s, 0)`` pad, which floors at an odd height: I3D's 7 rows pool to
3), hands each site ``(SpatialShard, stride)`` at every forward, and names
the parameters whose gradient each shard holds a part of. The submodules
a tower names in ``whole`` (the projector, I3D's conv head) run on a
tensor reduced over 'model', alike on every rank: they stay whole, and
each rank's gradient of theirs is the whole one.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from cstp_tpu_torch.models.layers import BatchNorm, Conv3d, SelfGating
from cstp_tpu_torch.parallel.mesh import (
    SpatialShard,
    mesh_axis,
    pad_pair,
    reduce_to_replicated,
)


class ShardedTower:
    """Mixin of a backbone ``nn.Module`` whose H splits over 'model'
    under ``--shard_spatial`` (:meth:`shard_spatially`); its forward takes
    its rows by :meth:`own_rows` and pools by :meth:`pooled`."""

    spatial = False
    # the top-level submodules that stay whole on every rank
    whole: Tuple[str, ...] = ("project",)

    def is_whole(self, name: str) -> bool:
        """Whether the submodule or parameter ``name`` (relative to the
        tower) lies in one of ``whole``."""
        return name.split(".", 1)[0] in self.whole

    def h_sites(self) -> List[Tuple[nn.Module, int]]:
        """``(site, total stride of its input rows)`` of every conv and
        pool of the tower, in forward order; sites whose H window is
        ``(1, 1, 0)`` are left out by the base."""
        raise NotImplementedError

    def shard_spatially(self) -> None:
        """Split H over 'model' from the next forward on: records the H
        sites and marks the tower's BatchNorms, convs and gates (those of
        ``whole`` stay whole: they run on the pooled feature or a map
        summed over 'model', the same on every rank)."""
        self._sites = [(m, st) for m, st in self.h_sites()
                       if tuple(m.h_window) != (1, 1, 0)]
        for name, m in self.named_modules():
            if isinstance(m, (BatchNorm, Conv3d, SelfGating)) \
                    and not self.is_whole(name):
                m.spatial = True
        self.spatial = True

    def stage_heights(self, height: int) -> dict:
        """``{total stride: global rows}`` of every stage on frames of
        ``height`` rows."""
        heights = {1: height}
        for site, st in self._sites:
            k, s, p = site.h_window
            lo, hi = pad_pair(p)
            h = (heights[st] + lo + hi - k) // s + 1
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
    (``--shard_spatial``); a module without one (the r3d and s3d_g of
    ``models/legacy.py``'s zoo) raises ``NotImplementedError``."""
    towers = [m for m in module.modules() if isinstance(m, ShardedTower)]
    if not towers:
        raise NotImplementedError(
            f"--shard_spatial on {type(module).__name__}: it holds no tower "
            "that splits H over 'model' (models/sharded.py ShardedTower)")
    for tower in towers:
        tower.shard_spatially()
    return module


def spatially_partial_names(module: nn.Module):
    """The names of ``module``'s parameters whose gradient each H shard
    holds a part of (every split tower's, those of its ``whole``
    submodules excepted): the step sums them over 'model'."""
    names = set()
    for prefix, m in module.named_modules():
        if isinstance(m, ShardedTower) and m.spatial:
            names.update(f"{prefix}.{n}" if prefix else n
                         for n, _ in m.named_parameters()
                         if not m.is_whole(n))
    return names
