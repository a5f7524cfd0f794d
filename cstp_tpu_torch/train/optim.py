"""The SGD update of the pretrain step.

The port of ``make_optimizer``'s SGD chain (``cstp_tpu/train/optim.py``,
torch ``optim.SGD(momentum, weight_decay)`` with ``clip_grad_norm_(18)`` in
front), in its order:

1. global-norm clip over the trainable parameters only;
2. ``g + weight_decay * p`` (decayed weights);
3. momentum trace ``buf = g + momentum * buf`` (dampening 0, the first step
   seeds ``buf = g``).

The learning rate is applied outside, ``p -= lr * buf``, by
:func:`apply_lr`. Frozen parameters (the target tower) are simply not
handed to the optimizer: they get zero updates and stay out of the norm.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


class SGD:
    """Lr-less SGD update rule; state is ``{"trace": {name: buf}}``."""

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
