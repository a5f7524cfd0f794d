"""Import DeepMind kinetics-i3d (Sonnet) TensorFlow checkpoints into the
port's I3D (``--tf_i3d_ckpt``).

The port of ``cstp_tpu/models/i3d_tf_import.py``, with its own copy of the
name map. The checkpoint is read by ``models/tf_checkpoint.py`` (numpy and
the standard library: no TensorFlow, no protobuf). For each conv + BN unit:

  <scope>/conv_3d/w (DHWIO)                  -> <unit>.conv.weight (OIDHW)
  <scope>/batch_norm/beta                    -> <unit>.bn.bias
  (Sonnet's BN has no gamma)                 -> <unit>.bn.scale = 1
  <scope>/batch_norm/moving_mean|_variance   -> <unit>.bn.mean|var

with the scopes

  RGB/inception_i3d/Conv3d_1a_7x7            -> conv3d_1a_7x7
  .../Mixed_3b/Branch_0/Conv3d_0a_1x1        -> mixed_3b.branch_0
  .../Mixed_3b/Branch_1/Conv3d_0a_1x1 / 0b_3x3  -> branch_1_0 / branch_1_1
  .../Mixed_3b/Branch_2/Conv3d_0a_1x1 / 0b_3x3  -> branch_2_0 / branch_2_1
  .../Mixed_3b/Branch_3/Conv3d_0b_1x1        -> branch_3_1

The public checkpoint names ``Mixed_5b/Branch_2``'s 3x3 unit
``Conv3d_0a_3x3`` (a typo the reference loader fixes with
``fix_typo=True``); the map carries it. The classifier
(``Logits/Conv3d_0c_1x1``) has no counterpart in the backbone and is
skipped.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from cstp_tpu_torch.models.i3d import MIXED, STEM
from cstp_tpu_torch.models.tf_checkpoint import load_checkpoint

_BRANCHES = {
    "branch_0": "Branch_0/Conv3d_0a_1x1",
    "branch_1_0": "Branch_1/Conv3d_0a_1x1",
    "branch_1_1": "Branch_1/Conv3d_0b_3x3",
    "branch_2_0": "Branch_2/Conv3d_0a_1x1",
    "branch_2_1": "Branch_2/Conv3d_0b_3x3",
    "branch_3_1": "Branch_3/Conv3d_0b_1x1",
}
_LEAVES = ("conv_3d/w", "batch_norm/beta", "batch_norm/moving_mean",
           "batch_norm/moving_variance")


def sonnet_name_map(modality: str = "rgb") -> Dict[str, Tuple[str, ...]]:
    """``{tf_scope: module path of the Unit3D}`` for every conv + BN unit
    (the JAX package's map, module paths as tuples)."""
    prefix = {"rgb": "RGB/inception_i3d", "flow": "Flow/inception_i3d"}[modality]
    out = {}
    for name in STEM:
        out[f"{prefix}/Conv3d_{name[len('conv3d_'):]}"] = (name,)
    for m, _ in MIXED:
        sm = "Mixed_" + m[len("mixed_"):]
        for ours, theirs in _BRANCHES.items():
            if m == "mixed_5b" and ours == "branch_2_1":
                theirs = "Branch_2/Conv3d_0a_3x3"     # the public typo
            out[f"{prefix}/{sm}/{theirs}"] = (m, ours)
    return out


@torch.no_grad()
def load_tf_i3d(backbone: nn.Module, ckpt_path: str, modality: str = "rgb",
                strict: bool = True) -> int:
    """Lay a kinetics-i3d V2 checkpoint over ``backbone`` (an ``I3D``, e.g.
    ``model.online_net``), in place; returns the units loaded. ``strict``:
    a scope missing from the checkpoint raises ``KeyError``; otherwise it is
    skipped, but at least one unit must load. A kernel of another shape
    than the unit's raises ``ValueError``."""
    reader = load_checkpoint(ckpt_path)
    loaded = 0
    for scope, path in sonnet_name_map(modality).items():
        try:
            w, beta, mean, var = [reader.get_tensor(f"{scope}/{leaf}")
                                  for leaf in _LEAVES]
        except KeyError:
            if strict:
                raise KeyError(f"missing {scope} in {ckpt_path}") from None
            continue
        unit = backbone.get_submodule(".".join(path))
        want = tuple(unit.conv.weight.permute(2, 3, 4, 1, 0).shape)
        if w.shape != want:
            raise ValueError(f"{scope}: kernel {w.shape}, the unit takes "
                             f"{want} (DHWIO)")
        unit.conv.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2), np.float32)))
        bn = unit.bn
        for t, v in ((bn.bias, beta), (bn.mean, mean), (bn.var, var)):
            t.copy_(torch.from_numpy(np.asarray(v, np.float32).reshape(-1)))
        bn.scale.fill_(1.0)
        loaded += 1
    if not loaded:
        raise ValueError(f"no I3D unit loaded from {ckpt_path}")
    return loaded
