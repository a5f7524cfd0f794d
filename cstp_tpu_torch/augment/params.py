"""Per-clip augmentation parameters, batched over clips.

The port of ``cstp_tpu/augment/params.py``: every stochastic decision of
the base-or-null augmentation, with 'off' encoded as identity-valued
parameters (angle 0, unit jitter factors, identity gray mix, sigma 0), so
the pixel chain (ops path or CUDA kernel) is branch-free.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BASE_PROB = 0.3
JITTER_PROB = 0.8
GRAY_PROB = 0.2
BLUR_PROB = 0.5
FLIP_PROB = 0.5
ROT_DEG = 10.0
JITTER_STRENGTH = (0.4, 0.4, 0.4, 0.1)  # b, c, s, hue


class ClipAugParams(NamedTuple):
    angle: torch.Tensor     # (N,) f32 degrees; 0 = no rotation
    factors: torch.Tensor   # (N, 4) f32 brightness/contrast/saturation/hue
    graymix: torch.Tensor   # (N, T, 3, 3) f32 channel-mixing matrices
    sigma: torch.Tensor     # (N,) f32 blur sigma; 0 = no blur
    flip: torch.Tensor      # (N,) bool


def _bernoulli(gen, p, n, device):
    return torch.rand((n,), generator=gen, device=device) < p


def _uniform(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand((n,), generator=gen, device=device)


def sample_clip_aug_params(gen: torch.Generator, n: int, t: int,
                           device) -> ClipAugParams:
    """Parameters for ``n`` clips of ``t`` frames, with the JAX sampler's
    probabilities and ranges."""
    use_base = _bernoulli(gen, BASE_PROB, n, device)
    angle = _uniform(gen, n, -ROT_DEG, ROT_DEG, device)
    angle = torch.where(use_base, angle, torch.zeros_like(angle))

    b, c, s, h = JITTER_STRENGTH
    factors = torch.stack([
        _uniform(gen, n, 1.0 - b, 1.0 + b, device),
        _uniform(gen, n, 1.0 - c, 1.0 + c, device),
        _uniform(gen, n, 1.0 - s, 1.0 + s, device),
        _uniform(gen, n, -h, h, device),
    ], dim=1)
    jit_on = use_base & _bernoulli(gen, JITTER_PROB, n, device)
    ident = torch.tensor([1.0, 1.0, 1.0, 0.0], device=device)
    factors = torch.where(jit_on[:, None], factors, ident)

    gray_on = use_base & _bernoulli(gen, GRAY_PROB, n, device)
    channels = torch.randint(0, 3, (n, t), generator=gen, device=device)
    onehot = torch.nn.functional.one_hot(channels, 3).to(torch.float32)
    graymix = onehot[:, :, None, :].expand(n, t, 3, 3)
    eye = torch.eye(3, device=device)
    graymix = torch.where(gray_on[:, None, None, None], graymix, eye)

    blur_on = use_base & _bernoulli(gen, BLUR_PROB, n, device)
    sigma = _uniform(gen, n, 0.1, 2.0, device)
    sigma = torch.where(blur_on, sigma, torch.zeros_like(sigma))

    flip = _bernoulli(gen, FLIP_PROB, n, device)
    return ClipAugParams(angle, factors, graymix.contiguous(), sigma, flip)


def concat_params(p1: ClipAugParams, p2: ClipAugParams) -> ClipAugParams:
    return ClipAugParams(*(torch.cat([a, b], dim=0) for a, b in zip(p1, p2)))
