"""BYOL engine: online/target towers, EMA momentum update, pretext heads,
and the finetune/test model.

The port of ``cstp_tpu/ssl/byol.py``. Two call patterns, both per-view in
their statistics: ``concat_views=1`` runs both views through each tower as
one 2B batch, with the towers', predictor's, ``pb_cls``' and
``rotate_cls``' BN groups doubled; ``concat_views=0`` is the reference's
own pattern, one call per view (online x1, online x2, predictor x1,
predictor x2, target x1, target x2, then the heads per view), so the
running statistics advance once per call, in that order. The target tower
runs under ``torch.no_grad()`` (the JAX package's ``stop_gradient``); it
still runs in train mode, so its BN running statistics update, as in JAX.

``CSTPClassify`` is the finetune/test model: the online backbone's feature
(L2-normalised for I3D, ``feat_and_proj``), then the ``linear`` head
(L2-normalise -> ``cls_bn`` -> float32 ``classify``) or the ``mlp`` head
(``model_name`` ``*_classify``: Linear-BN-ReLU-Linear on the feature); or,
with ``head_style="i3d_conv"`` (``--i3d_conv_head``), the reference I3D
classifier inside the backbone; or, with ``head_style="pace_project"``
(``--legacy_pace`` on bare ``r21d``), the legacy pace projector whose 512
outputs are the logits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cstp_tpu_torch.models import backbone_spec, make_backbone
from cstp_tpu_torch.models.layers import (
    BatchNorm,
    Dense,
    MLPHead,
    PretextHead,
    l2_normalize,
)


def byol_regression_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2 - 2 cos(x, y) per sample (reference ``_loss_fn``)."""
    x = l2_normalize(x.float())
    y = l2_normalize(y.float())
    return 2.0 - 2.0 * (x * y).sum(dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  reduce: bool = True) -> torch.Tensor:
    """Softmax cross entropy with integer labels: the mean, or with
    ``reduce=False`` the per-sample ``(B,)`` losses (the mask-weighted
    eval sums)."""
    return F.cross_entropy(logits.float(), labels.long(),
                           reduction="mean" if reduce else "none")


def feat_and_proj(out, spec):
    """A backbone's output as ``(feature, BYOL embedding)``: a family without
    a projector (c3d, r3d) regresses its feature itself (the JAX package's
    ``_feat_and_proj``)."""
    if isinstance(out, tuple):
        feat, proj = out
    else:
        feat = proj = out
    if spec.l2_feat:
        feat = l2_normalize(feat)
        proj = feat if not isinstance(out, tuple) else proj
    return feat, proj


@torch.no_grad()
def ema_update(target: nn.Module, online: nn.Module, momentum: float) -> None:
    """target <- m * target + (1 - m) * online, over parameters only (BN
    running statistics are buffers and are not averaged), in place."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_(t * momentum + o.to(t.dtype) * (1.0 - momentum))


class CSTPPretrain(nn.Module):
    """Pretraining model: BYOL towers + 4 pretext heads.

    ``fused_conv``: 1 = fused (2+1)D blocks in both towers, 2 = in the
    target tower only, 0 = none. ``concat_views``: 1 = one 2B call per
    tower, 0 = one call per view. ``remat`` / ``remat_policy``: the
    towers' ``--remat`` / ``--remat_policy`` (``models/r21d.py``).
    ``shortcut``: ``--resnet_shortcut`` of the 3D ResNet; ``alpha``:
    SlowFast's ``--alpha``. ``s2d_stem``, ``mid_round`` and ``t_fold``:
    ``--s2d_stem``, ``--mid_round`` and ``--t_fold`` of both towers
    (``make_backbone``). ``quant`` (``--quant`` int8 or int8_fixed)
    reaches the target tower's conv sites always and the online tower's
    under ``quant_scope`` 'all' (``--quant_scope target``: the EMA tower
    alone). The predictor takes the projection, or the feature where the
    family has no projector.
    """

    def __init__(self, backbone: str = "r21d", depth: int = 1,
                 dtype=torch.bfloat16, bn_groups: int = 1, fused_conv: int = 0,
                 gen: Optional[torch.Generator] = None,
                 concat_views: bool = True, remat: bool = False,
                 remat_policy: str = "", shortcut: str = "B",
                 alpha: int = 4, quant: str = "", quant_scope: str = "all",
                 s2d_stem: bool = False, mid_round: int = 1,
                 t_fold: bool = False):
        super().__init__()
        spec = self.spec = backbone_spec(backbone, depth)
        self.concat_views = bool(concat_views)
        g2 = 2 * bn_groups if self.concat_views else bn_groups
        use_proj = spec.proj_dim is not None
        tower = dict(dtype=dtype, proj_flag=use_proj, bn_groups=g2, gen=gen,
                     remat=remat, remat_policy=remat_policy,
                     shortcut=shortcut, alpha=alpha, s2d_stem=s2d_stem,
                     mid_round=mid_round, t_fold=t_fold)
        self.online_net = make_backbone(
            backbone, depth, fused_conv=fused_conv == 1,
            quant=quant if quant_scope == "all" else "", **tower)
        self.target_net = make_backbone(backbone, depth,
                                        fused_conv=fused_conv >= 1,
                                        quant=quant, **tower)
        self.predictor = MLPHead(spec.proj_dim or spec.feat_dim,
                                 spec.pred_hidden,
                                 spec.pred_dim, dtype, g2, gen)
        f, style = spec.feat_dim, spec.head_style
        self.overlap_spa = PretextHead(style, 2 * f, 2 * f, spec.n_spa, dtype,
                                       bn_groups, gen)
        self.overlap_tem = PretextHead(style, 2 * f, 2 * f, spec.n_tem, dtype,
                                       bn_groups, gen)
        self.pb_cls = PretextHead(style, f, f, spec.n_pb, dtype, g2, gen)
        self.rotate_cls = PretextHead(style, f, f, spec.n_rot, dtype, g2, gen)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, train: bool = True,
                with_proj: bool = False):
        """``o_type='loss_com'`` forward: returns ``(byol_loss_mean,
        (pred_spa, pred_tem, pb1, pb2, rot1, rot2))``; with ``with_proj``
        also the two views' online projections ``(emb1, emb2)``, the input
        of the NT-Xent term (``ssl/ntxent.py``)."""
        spec = self.spec
        if self.concat_views:
            x12 = torch.cat([x1, x2], dim=0)
            feats, embs = feat_and_proj(self.online_net(x12, train), spec)
            pred1, pred2 = self.predictor(embs, train).chunk(2, dim=0)
            emb1, emb2 = embs.chunk(2, dim=0)
            feat1, feat2 = feats.chunk(2, dim=0)
            with torch.no_grad():
                _, tembs = feat_and_proj(self.target_net(x12, train), spec)
            temb1, temb2 = tembs.chunk(2, dim=0)
        else:
            feat1, emb1 = feat_and_proj(self.online_net(x1, train), spec)
            feat2, emb2 = feat_and_proj(self.online_net(x2, train), spec)
            pred1 = self.predictor(emb1, train)
            pred2 = self.predictor(emb2, train)
            with torch.no_grad():
                _, temb1 = feat_and_proj(self.target_net(x1, train), spec)
                _, temb2 = feat_and_proj(self.target_net(x2, train), spec)
        loss = (byol_regression_loss(pred1, temb2)
                + byol_regression_loss(pred2, temb1))
        feat_cat = torch.cat([feat1, feat2], dim=-1)
        if self.concat_views:
            pb1, pb2 = self.pb_cls(feats, train).chunk(2, dim=0)
            rot1, rot2 = self.rotate_cls(feats, train).chunk(2, dim=0)
        else:
            pb1, pb2 = self.pb_cls(feat1, train), self.pb_cls(feat2, train)
            rot1 = self.rotate_cls(feat1, train)
            rot2 = self.rotate_cls(feat2, train)
        out = (self.overlap_spa(feat_cat, train),
               self.overlap_tem(feat_cat, train), pb1, pb2, rot1, rot2)
        if with_proj:
            return loss.mean(), out, (emb1, emb2)
        return loss.mean(), out


class CSTPClassify(nn.Module):
    """Finetune/test model (the JAX package's ``CSTPClassify``).

    ``head_style`` 'linear': L2-normalise -> ``cls_bn`` (running statistics
    in eval; left out with ``use_cls_bn=False``) -> float32 ``classify``
    (glorot kernel, torch-default bias). 'mlp': ``classify`` is
    Linear-BN-ReLU-Linear on the feature. 'i3d_conv': I3D's own
    ``conv_head`` classifier (224^2 only); no ``classify`` or ``cls_bn``
    module, and no pre-head feature. 'pace_project' (``--legacy_pace``):
    ``classify`` is Linear(feat, 4096)-BN-ReLU-Linear(4096, 512), then the
    BatchNorm ``pace_bn`` and a ReLU; its 512 outputs are the logits
    whatever ``num_classes`` is (the reference's live behaviour), returned
    in float32. The feature is the backbone's through ``feat_and_proj``
    (I3D's is L2-normalised there). ``fused_conv`` reaches the backbone's
    stride-1 (2+1)D sites, which fuse in train mode only; ``shortcut`` is
    the 3D ResNet's ``--resnet_shortcut`` and ``alpha`` SlowFast's
    ``--alpha``; ``quant`` (``--quant``) reaches the backbone's conv sites;
    ``s2d_stem``, ``mid_round`` and ``t_fold`` the backbone
    (``make_backbone``).
    """

    def __init__(self, backbone: str = "r21d", depth: int = 1,
                 num_classes: int = 101, use_cls_bn: bool = True,
                 head_style: str = "linear", dtype=torch.bfloat16,
                 bn_groups: int = 1, fused_conv: bool = False,
                 gen: Optional[torch.Generator] = None, shortcut: str = "B",
                 alpha: int = 4, quant: str = "", s2d_stem: bool = False,
                 mid_round: int = 1, t_fold: bool = False):
        super().__init__()
        spec = self.spec = backbone_spec(backbone, depth)
        self.backbone, self.depth, self.quant = backbone, depth, quant
        self.head_style = head_style
        head = {}
        if head_style == "i3d_conv":
            if not backbone.startswith("i3d"):
                raise ValueError(f"head 'i3d_conv' needs an i3d backbone, "
                                 f"not {backbone!r}")
            head = dict(conv_head=True, num_classes=num_classes)
        self.online_net = make_backbone(backbone, depth, dtype=dtype,
                                        proj_flag=False, bn_groups=bn_groups,
                                        fused_conv=fused_conv, gen=gen,
                                        shortcut=shortcut, alpha=alpha,
                                        quant=quant, s2d_stem=s2d_stem,
                                        mid_round=mid_round, t_fold=t_fold,
                                        **head)
        f = spec.feat_dim
        if head_style == "mlp":
            self.classify = MLPHead(f, f, num_classes, dtype, bn_groups, gen)
        elif head_style == "linear":
            self.cls_bn = BatchNorm(f, bn_groups, gen) if use_cls_bn else None
            self.classify = Dense(f, num_classes, torch.float32, gen)
        elif head_style == "pace_project":
            self.classify = MLPHead(f, 4096, 512, dtype, bn_groups, gen)
            self.pace_bn = BatchNorm(512, bn_groups, gen)
        elif head_style != "i3d_conv":
            raise ValueError(f"unknown finetune head {head_style!r}")

    def features(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The backbone's float32 feature vector (before the head)."""
        if self.head_style == "i3d_conv":
            raise ValueError("retrieval features need a pre-head backbone "
                             "output; the 'i3d_conv' head has none")
        feat, _ = feat_and_proj(self.online_net(x, train), self.spec)
        return feat.float()

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.head_style == "i3d_conv":
            return self.online_net(x, train)   # the internal head's logits
        feat, _ = feat_and_proj(self.online_net(x, train), self.spec)
        if self.head_style == "mlp":
            return self.classify(feat, train).float()
        if self.head_style == "pace_project":
            p = self.pace_bn(self.classify(feat, train), train)
            return torch.relu(p).float()
        feat = l2_normalize(feat)
        if self.cls_bn is not None:
            feat = self.cls_bn(feat, train)
        return self.classify(feat.float())
