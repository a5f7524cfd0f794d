"""Grouped batch-norm helpers shared by ``models/layers.py BatchNorm``, the
fused (2+1)D chain's reference (``ops/conv21d.py``) and the s8 storage
chain (``ops/quant.py``): groups are contiguous rows of the batch."""

from __future__ import annotations

import torch

BN_EPS = 1e-5


def group_mean(p: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, C) per-sample values -> (G, C) means over each group's rows."""
    b, c = p.shape
    return p.reshape(groups, b // groups, c).mean(1)


def group_moments(xf: torch.Tensor, groups: int):
    """Per-group ``(G, C)`` means of ``xf`` and ``xf^2`` ((B, ..., C)) over
    each group's rows and every axis between the first and the last."""
    axes = tuple(range(1, xf.dim() - 1))
    pmean = xf.mean(dim=axes) if axes else xf
    psq = xf.square().mean(dim=axes) if axes else xf.square()
    return group_mean(pmean, groups), group_mean(psq, groups)


def per_sample(g: torch.Tensor, b: int, shape) -> torch.Tensor:
    """(G, C) group values broadcast to ``b`` rows, reshaped to ``shape``
    ((B, C) or (B, 1, .., C))."""
    return g.repeat_interleave(b // g.shape[0], 0).reshape(shape)
