"""BYOL engine: online/target towers, EMA momentum update, pretext heads.

The port of ``cstp_tpu/ssl/byol.py`` for the concatenated-views call
pattern (``concat_views=1``): both views run through each tower as one 2B
batch, with the towers', predictor's, ``pb_cls``' and ``rotate_cls``' BN
groups doubled so the statistics stay per view. The target tower runs
under ``torch.no_grad()`` (the JAX package's ``stop_gradient``); it still
runs in train mode, so its BN running statistics update, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cstp_tpu_torch.models import backbone_spec, make_backbone
from cstp_tpu_torch.models.layers import PretextHead, MLPHead, l2_normalize


def byol_regression_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2 - 2 cos(x, y) per sample (reference ``_loss_fn``)."""
    x = l2_normalize(x.float())
    y = l2_normalize(y.float())
    return 2.0 - 2.0 * (x * y).sum(dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels."""
    return F.cross_entropy(logits.float(), labels.long())


@torch.no_grad()
def ema_update(target: nn.Module, online: nn.Module, momentum: float) -> None:
    """target <- m * target + (1 - m) * online, over parameters only (BN
    running statistics are buffers and are not averaged), in place."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_(t * momentum + o.to(t.dtype) * (1.0 - momentum))


class CSTPPretrain(nn.Module):
    """Pretraining model: BYOL towers + 4 pretext heads.

    ``fused_conv``: 1 = fused (2+1)D blocks in both towers, 2 = in the
    target tower only, 0 = none.
    """

    def __init__(self, backbone: str = "r21d", depth: int = 1,
                 dtype=torch.bfloat16, bn_groups: int = 1, fused_conv: int = 0,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        spec = self.spec = backbone_spec(backbone, depth)
        g2 = 2 * bn_groups
        use_proj = spec.proj_dim is not None
        self.online_net = make_backbone(backbone, depth, dtype=dtype,
                                        proj_flag=use_proj, bn_groups=g2,
                                        fused_conv=fused_conv == 1, gen=gen)
        self.target_net = make_backbone(backbone, depth, dtype=dtype,
                                        proj_flag=use_proj, bn_groups=g2,
                                        fused_conv=fused_conv >= 1, gen=gen)
        self.predictor = MLPHead(spec.proj_dim, spec.pred_hidden,
                                 spec.pred_dim, dtype, g2, gen)
        f, style = spec.feat_dim, spec.head_style
        self.overlap_spa = PretextHead(style, 2 * f, 2 * f, spec.n_spa, dtype,
                                       bn_groups, gen)
        self.overlap_tem = PretextHead(style, 2 * f, 2 * f, spec.n_tem, dtype,
                                       bn_groups, gen)
        self.pb_cls = PretextHead(style, f, f, spec.n_pb, dtype, g2, gen)
        self.rotate_cls = PretextHead(style, f, f, spec.n_rot, dtype, g2, gen)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, train: bool = True):
        """``o_type='loss_com'`` forward: returns ``(byol_loss_mean,
        (pred_spa, pred_tem, pb1, pb2, rot1, rot2))``."""
        x12 = torch.cat([x1, x2], dim=0)
        feats, embs = self.online_net(x12, train)
        pred1, pred2 = self.predictor(embs, train).chunk(2, dim=0)
        feat1, feat2 = feats.chunk(2, dim=0)
        with torch.no_grad():
            _, tembs = self.target_net(x12, train)
        temb1, temb2 = tembs.chunk(2, dim=0)
        loss = (byol_regression_loss(pred1, temb2)
                + byol_regression_loss(pred2, temb1))
        feat_cat = torch.cat([feat1, feat2], dim=-1)
        pb1, pb2 = self.pb_cls(feats, train).chunk(2, dim=0)
        rot1, rot2 = self.rotate_cls(feats, train).chunk(2, dim=0)
        out = (self.overlap_spa(feat_cat, train),
               self.overlap_tem(feat_cat, train), pb1, pb2, rot1, rot2)
        return loss.mean(), out
