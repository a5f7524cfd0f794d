"""Backbone registry of the port (``cstp_tpu/models/__init__.py``), every
family the JAX package registers:

| backbone | feat            | projector   | predictor    | pretext heads   |
|----------|-----------------|-------------|--------------|-----------------|
| r21d     | 512             | 512 (h4096) | 512 (h4096)  | MLP, 5/5/5/5    |
| c3d      | 512             | -           | 512 (h4096)  | Linear, 5/5/4/4 |
| r3d      | 512 * expansion | -           | feat (h4096) | Linear, 5/5/4/4 |
| s3d      | 1024            | 1024 (h1024)| 1024 (h4096) | MLP, 5/5/5/5    |
| i3d      | 1024, L2-normed | -           | 1024 (h4096) | Linear, 5/5/4/4 |
| slowfast | 576 / 2304      | -           | feat (h4096) | Linear, 5/5/4/4 |

``slowfast_fb`` (the reference's name) is ``slowfast``; its feature is 576
at depth 18/34 and 2304 at 50/101 (another depth builds 18). Any other
family raises ``ValueError``. ``fused_conv``, ``remat`` and
``remat_policy`` reach R(2+1)D only, ``shortcut`` the 3D ResNet only,
``gating`` / ``slow`` S3D only, ``conv_head`` / ``num_classes`` (the
``--i3d_conv_head`` classifier) I3D only and ``alpha`` (``--alpha``)
SlowFast only; the other families accept them and do nothing, as in the
JAX package. The legacy pace-era models, which no model name reaches, are
built by ``make_legacy_model`` (``models/legacy.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from cstp_tpu_torch.config import PORTED_FAMILIES, base_model_name


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


def _family(arch: str) -> str:
    base = base_model_name(arch)
    if base not in PORTED_FAMILIES:
        raise ValueError(f"unknown backbone {arch!r}; have "
                         f"{sorted(PORTED_FAMILIES)}")
    return base


def backbone_spec(arch: str, depth: int = 1) -> BackboneSpec:
    base = _family(arch)
    if base == "r21d":
        return BackboneSpec(512, 512, 4096, 512, 4096, "mlp")
    if base == "s3d":
        return BackboneSpec(1024, 1024, 1024, 1024, 4096, "mlp")
    if base == "i3d":
        return BackboneSpec(1024, None, 0, 1024, 4096, "linear", n_pb=4,
                            n_rot=4, l2_feat=True)
    if base.startswith("slowfast"):
        from cstp_tpu_torch.models.slowfast import slowfast_feat_dim

        f = slowfast_feat_dim(depth)
        return BackboneSpec(f, None, 0, f, 4096, "linear", n_pb=4, n_rot=4)
    f = 512
    if base == "r3d":   # an unknown depth: expansion 1 (JAX's fallback)
        from cstp_tpu_torch.models.r3d import R3D_LAYERS

        f *= R3D_LAYERS.get(depth, (None, None, 1))[2]
    return BackboneSpec(f, None, 0, f, 4096, "linear", n_pb=4, n_rot=4)


def make_backbone(arch: str, depth: int = 1, *, dtype=torch.bfloat16,
                  proj_flag: bool = False, bn_groups: int = 1,
                  fused_conv: bool = False,
                  gen: Optional[torch.Generator] = None,
                  remat: bool = False, remat_policy: str = "",
                  shortcut: str = "B", gating: bool = True,
                  slow: bool = False, conv_head: bool = False,
                  num_classes: int = 0, alpha: int = 4):
    """The backbone module for ``arch`` ('r21d_byol', 'c3d', 'r3d_classify',
    ...); ``remat`` / ``remat_policy`` are ``--remat`` / ``--remat_policy``
    and ``shortcut`` is ``--resnet_shortcut``. An r3d or slowfast depth
    without a layout builds depth 18 (the JAX package's fallback:
    ``--model_depth`` defaults to 1). S3D is built with self-gating
    (``gating``, as the reference's ``s3d_byol``) and the stem's temporal
    stride 2 unless ``slow``; ``conv_head`` gives I3D the reference
    classifier of ``num_classes`` outputs; ``alpha`` is SlowFast's
    fast/slow frame-rate ratio."""
    base = _family(arch)
    if base.startswith("slowfast"):
        from cstp_tpu_torch.models.slowfast import SlowFastNet

        return SlowFastNet(depth, alpha, dtype=dtype, bn_groups=bn_groups,
                           gen=gen)
    if base == "s3d":
        from cstp_tpu_torch.models.s3dg import S3D

        return S3D(gating, slow, proj_flag, dtype, bn_groups, gen)
    if base == "i3d":
        from cstp_tpu_torch.models.i3d import I3D

        return I3D(dtype, bn_groups, conv_head, num_classes, gen)
    if base == "c3d":
        from cstp_tpu_torch.models.c3d import C3D

        return C3D(dtype, bn_groups, gen)
    if base == "r3d":
        from cstp_tpu_torch.models.r3d import R3D_LAYERS, ResNet3D

        block, layers, _ = R3D_LAYERS.get(depth, R3D_LAYERS[18])
        return ResNet3D(block, layers, shortcut, dtype, bn_groups, gen)
    from cstp_tpu_torch.models.r21d import (
        LAYER_SIZES,
        R2Plus1DNet,
        remat_mode,
    )

    return R2Plus1DNet(LAYER_SIZES.get(depth, (1, 1, 1, 1)), proj_flag, dtype,
                       bn_groups, fused_conv, gen,
                       remat_mode(remat, remat_policy))


def __getattr__(name):
    # the legacy pace-era zoo is not in the registry (no model name reaches
    # it) but is exported, as in the JAX package
    if name == "make_legacy_model":
        from cstp_tpu_torch.models.legacy import make_legacy_model

        return make_legacy_model
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
