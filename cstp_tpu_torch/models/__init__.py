"""Backbone registry of the port (``cstp_tpu/models/__init__.py``).

Only R(2+1)D is ported; any other family raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from cstp_tpu_torch.config import base_model_name


@dataclass(frozen=True)
class BackboneSpec:
    feat_dim: int
    proj_dim: Optional[int]   # None = no projector (BYOL on raw features)
    proj_hidden: int
    pred_dim: int
    pred_hidden: int
    head_style: str           # 'mlp' (Linear-BN-ReLU-Linear) | 'linear'
    n_spa: int = 5
    n_tem: int = 5
    n_pb: int = 5
    n_rot: int = 5
    l2_feat: bool = False


def _check_r21d(arch: str) -> None:
    if base_model_name(arch) != "r21d":
        raise NotImplementedError(
            f"cstp_tpu_torch ports the r21d backbone only, not {arch!r}")


def backbone_spec(arch: str, depth: int = 1) -> BackboneSpec:
    _check_r21d(arch)
    return BackboneSpec(512, 512, 4096, 512, 4096, "mlp")


def make_backbone(arch: str, depth: int = 1, *, dtype=torch.bfloat16,
                  proj_flag: bool = False, bn_groups: int = 1,
                  fused_conv: bool = False,
                  gen: Optional[torch.Generator] = None,
                  remat: bool = False, remat_policy: str = ""):
    """The R(2+1)D module for ``arch`` ('r21d', 'r21d_byol', ...);
    ``remat`` / ``remat_policy`` are ``--remat`` / ``--remat_policy``."""
    from cstp_tpu_torch.models.r21d import (
        LAYER_SIZES,
        R2Plus1DNet,
        remat_mode,
    )

    _check_r21d(arch)
    return R2Plus1DNet(LAYER_SIZES.get(depth, (1, 1, 1, 1)), proj_flag, dtype,
                       bn_groups, fused_conv, gen,
                       remat_mode(remat, remat_policy))
