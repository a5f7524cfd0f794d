"""The SGD update and the finetune learning-rate schedule.

The port of ``make_optimizer``'s SGD chain (``cstp_tpu/train/optim.py``,
torch ``optim.SGD(momentum, weight_decay)`` with ``clip_grad_norm_(18)`` in
front), in its order:

1. global-norm clip over the trainable parameters only (skipped with
   ``clip_grad_norm=None``, as the finetune step runs);
2. ``g + weight_decay * p`` (decayed weights);
3. momentum trace ``buf = g + momentum * buf`` (dampening 0, the first step
   seeds ``buf = g``).

The learning rate is applied outside, ``p -= lr * buf``, by
:func:`apply_lr`. Frozen parameters (the target tower in pretraining, the
frozen prefixes of a finetune run: the JAX package's ``param_labels`` with
``optax.set_to_zero``) have ``requires_grad`` off (:func:`freeze`) and are
not handed to the optimizer (:func:`trainable`): they get no gradient, no
update, no weight decay and no momentum trace, and stay out of the norm.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


def is_frozen(name: str, frozen_prefixes: Sequence[str]) -> bool:
    """Whether the parameter ``name`` (dotted port name) lies under one of
    the module paths ``frozen_prefixes``, matched by whole path parts."""
    parts = name.split(".")
    return any(parts[:len(p.split("."))] == p.split(".")
               for p in frozen_prefixes)


def freeze(model: nn.Module, frozen_prefixes: Sequence[str]) -> None:
    """``requires_grad`` off for the parameters under ``frozen_prefixes``
    and on for the others."""
    for n, p in model.named_parameters():
        p.requires_grad_(not is_frozen(n, frozen_prefixes))


def trainable(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters the optimizer updates: those ``freeze`` left on."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


class SGD:
    """Lr-less SGD update rule; state is ``{"trace": {name: buf}}`` over
    the trainable parameters."""

    def __init__(self, momentum: float = 0.9, weight_decay: float = 1e-4,
                 clip_grad_norm: Optional[float] = 18.0):
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_grad_norm = clip_grad_norm

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict,
               params: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
        names: List[str] = list(grads)
        g = [grads[n] for n in names]
        if self.clip_grad_norm:
            norm = torch.sqrt(sum(x.float().square().sum() for x in g))
            clip = norm >= self.clip_grad_norm
            g = [torch.where(clip, (x / norm) * self.clip_grad_norm, x)
                 for x in g]
        if self.weight_decay:
            g = [x + self.weight_decay * params[n] for x, n in zip(g, names)]
        trace = {n: x + self.momentum * state["trace"][n]
                 for x, n in zip(g, names)}
        return trace, {"trace": trace}


def make_optimizer(name: str, *, momentum: float = 0.9,
                   weight_decay: float = 1e-4, dampening: float = 0.0,
                   nesterov: bool = False,
                   clip_grad_norm: Optional[float] = 18.0) -> SGD:
    if name != "sgd" or dampening or nesterov:
        raise NotImplementedError(
            "cstp_tpu_torch ports plain SGD (dampening 0, no nesterov) only")
    return SGD(momentum, weight_decay, clip_grad_norm)


@torch.no_grad()
def apply_lr(params: Dict[str, torch.Tensor],
             updates: Dict[str, torch.Tensor], lr) -> None:
    """``p -= lr * u`` in place (torch's ``p -= lr * buf``)."""
    for n, u in updates.items():
        params[n].sub_(lr * u)


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch ReduceLROnPlateau (mode='min', defaults) as checkpointable
    state: the finetune schedule."""

    lr: float
    patience: int = 10
    factor: float = 0.1
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = math.inf
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: Dict[str, Any]) -> "ReduceLROnPlateau":
        return cls(**d)
