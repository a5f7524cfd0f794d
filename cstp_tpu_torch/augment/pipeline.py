"""The pretrain augmentation programs (``cstp_tpu/augment/pipeline.py``).

uint8 frames -> pair crop boxes and the spatial-overlap label
(``pretext/boxes.py``) -> crop/resize, rot90, small rotation, jitter, gray,
blur, flip, normalize. The randomness is sampled once for the batch by
:func:`sample_pretrain_aug_params`; both programs consume the same sampled
parameters, so from one generator state they see the same draws:

* :func:`pretrain_augment_batch_fused`: one ``fused_augment_clips`` call
  over the 2B concatenated clips (the CUDA kernel for CUDA tensors);
* :func:`pretrain_augment_batch`: the ops path of ``augment/ops.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cstp_tpu_torch.augment import ops
from cstp_tpu_torch.augment.params import (
    ClipAugParams,
    concat_params,
    sample_clip_aug_params,
)
from cstp_tpu_torch.pretext.boxes import sample_pair_boxes


def apply_clip_aug(clip: torch.Tensor, p: ClipAugParams) -> torch.Tensor:
    """rotate(angle) -> jitter(factors) -> gray(mix) -> blur(sigma) -> flip
    on ``(N, T, S, S, 3)`` clips in [0, 255], each op selected per clip as
    in the JAX package's ``apply_clip_aug``; 'off' states are identity."""
    def per_clip(mask, new, old):
        return torch.where(mask.view(-1, 1, 1, 1, 1), new, old)

    clip = per_clip(p.angle != 0.0, ops.rotate_small_clip(clip, p.angle), clip)
    jit_on = (p.factors[:, 0] != 1.0) | (p.factors[:, 3] != 0.0)
    clip = per_clip(jit_on, ops.color_jitter_clip(clip, p.factors), clip)
    clip = ops.gray_mix_clip(clip, p.graymix)
    clip = per_clip(p.sigma > 0.0, ops.gaussian_blur_clip(clip, p.sigma), clip)
    return per_clip(p.flip, ops.hflip_clip(clip), clip)


def sample_pretrain_aug_params(gen: torch.Generator, batch: int, t: int,
                               w0: float, h0: float, rot1: torch.Tensor,
                               rot2: torch.Tensor):
    """``(box1, box2, spa, p1, p2)`` for the whole batch."""
    box1, box2, spa = sample_pair_boxes(gen, rot1, rot2, w0, h0)
    p1 = sample_clip_aug_params(gen, batch, t, rot1.device)
    p2 = sample_clip_aug_params(gen, batch, t, rot1.device)
    return box1, box2, spa, p1, p2


def apply_pretrain_aug_fused(frames1, frames2, rot1, rot2, sampled,
                             sample_size: int = 112, norm_method: str = "tf",
                             out_dtype=torch.bfloat16):
    """Views of both clips from sampled parameters ``(box1, box2, spa, p1,
    p2)`` by one ``fused_augment_clips`` call over the 2B clips."""
    from cstp_tpu_torch.ops.augment import fused_augment_clips

    box1, box2, _, p1, p2 = sampled
    b = frames1.shape[0]
    views = fused_augment_clips(
        torch.cat([frames1, frames2]), torch.cat([box1, box2]),
        torch.cat([rot1, rot2]), *concat_params(p1, p2),
        sample_size=sample_size, norm_method=norm_method, out_dtype=out_dtype)
    return views[:b], views[b:]


def apply_pretrain_aug(frames1, frames2, rot1, rot2, sampled,
                       sample_size: int = 112, norm_method: str = "tf"):
    """The ops path: float32 views of both clips from sampled parameters."""
    box1, box2, _, p1, p2 = sampled

    def view(frames, box, rot, p):
        v = ops.crop_resize_clip(frames.float(), box, sample_size)
        v = apply_clip_aug(ops.rot90_clip(v, rot), p)
        return ops.normalize_clip(v, norm_method)

    return view(frames1, box1, rot1, p1), view(frames2, box2, rot2, p2)


def _sample(gen, frames1, rot1, rot2):
    b, t, h0, w0, _ = frames1.shape
    return sample_pretrain_aug_params(gen, b, t, float(w0), float(h0), rot1,
                                      rot2)


def pretrain_augment_batch_fused(gen, frames1, frames2, rot1, rot2,
                                 sample_size: int = 112,
                                 norm_method: str = "tf",
                                 out_dtype=torch.bfloat16
                                 ) -> Tuple[torch.Tensor, ...]:
    """Sample, then one fused augment call; ``(view1, view2, spa)`` with
    views in ``out_dtype``."""
    sampled = _sample(gen, frames1, rot1, rot2)
    v1, v2 = apply_pretrain_aug_fused(frames1, frames2, rot1, rot2, sampled,
                                      sample_size, norm_method, out_dtype)
    return v1, v2, sampled[2]


def pretrain_augment_batch(gen, frames1, frames2, rot1, rot2,
                           sample_size: int = 112, norm_method: str = "tf"):
    """Sample, then the ops path; ``(view1, view2, spa)`` with float32
    views."""
    sampled = _sample(gen, frames1, rot1, rot2)
    v1, v2 = apply_pretrain_aug(frames1, frames2, rot1, rot2, sampled,
                                sample_size, norm_method)
    return v1, v2, sampled[2]
