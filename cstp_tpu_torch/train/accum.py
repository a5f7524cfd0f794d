"""Gradient accumulation shared by the pretrain and finetune steps.

The port of the JAX package's ``_microbatches`` and the accumulation loop
of its train programs (``cstp_tpu/train/pretrain.py``,
``cstp_tpu/train/finetune.py``) as a Python loop: each microbatch runs
forward and backward in turn, so only one microbatch's activations are live,
and its BatchNorm layers normalise by its own batch statistics and advance
their running statistics once, in order.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch


def microbatches(tensors: Sequence[torch.Tensor], accum: int):
    """Split every ``(B, ...)`` tensor into ``accum`` contiguous
    ``(B // accum, ...)`` slices; returns one tuple per microbatch. (The
    JAX package's split with one data shard.)"""
    b = tensors[0].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} not divisible by grad_accum {accum}")
    return list(zip(*(t.split(b // accum) for t in tensors)))


def accumulated_grads(loss_fn: Callable, batches,
                      params: Dict[str, torch.Tensor]):
    """``(grads, metrics)``: forward and backward of ``loss_fn(mb) ->
    (total, metrics)`` once per microbatch, in order, the gradients with
    respect to ``params`` summed and divided by the count, the metrics
    averaged. A parameter the loss does not reach gets a zero gradient."""
    gsum, msum = None, None
    for mb in batches:
        total, metrics = loss_fn(mb)
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), grads)]
        if gsum is None:
            gsum, msum = grads, dict(metrics)
        else:
            torch._foreach_add_(gsum, grads)
            msum = {k: msum[k] + v for k, v in metrics.items()}
        del total, grads
    n = len(batches)
    if n > 1:
        torch._foreach_div_(gsum, float(n))
        msum = {k: v / n for k, v in msum.items()}
    return dict(zip(params, gsum)), msum
