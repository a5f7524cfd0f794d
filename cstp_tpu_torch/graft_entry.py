"""Entry point for a single-device check of the port: the counterpart of
the JAX package's ``__graft_entry__.entry``.

    fn, args = entry()          # on the card
    byol, logits = fn(*args)

``fn(model, x1, x2)`` is the flagship forward: R(2+1)D depth 1 pretraining
(``r21d_byol``, task ``loss_com``), 8 x 112^2 clips, bf16, in train mode,
so the BatchNorm running statistics are updated. It returns the BYOL loss
and the six pretext logits ``(spa, tem, pb1, pb2, rot1, rot2)``.
"""

from __future__ import annotations

import torch

from cstp_tpu_torch import resolve_device
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.train.pretrain import create_pretrain_model


def entry(device=None):
    """``(fn, example_args)``: the forward and ``(model, x, x)``, with the
    model's weights drawn from seed 0 and ``x`` two zero clips in bf16, on
    CUDA unless ``device="cpu"`` is asked for."""
    dev = resolve_device(device)
    cfg = Config(model_name="r21d", model_depth=1, sample_duration=8,
                 sample_size=112, compute_dtype="bfloat16").finalize()
    model = create_pretrain_model(cfg, device=dev)
    x = torch.zeros((2, cfg.sample_duration, cfg.sample_size,
                     cfg.sample_size, 3), dtype=torch.bfloat16, device=dev)

    def fwd(model, x1, x2):
        return model(x1, x2, train=True)

    return fwd, (model, x, x)
