"""The augmentation programs (``cstp_tpu/augment/pipeline.py``).

Finetune and eval (plain PyTorch ops, as the JAX package computes them
outside any kernel):

* :func:`sample_finetune_aug_params` + :func:`apply_finetune_aug`
  (:func:`finetune_train_augment_batch`): per clip a random-sized crop box,
  a colour jitter switched on with p 0.3, tf normalisation;
* :func:`eval_augment_batch`: one deterministic scale-and-centre box for
  the batch.

Pretrain:

uint8 frames -> pair crop boxes and the spatial-overlap label
(``pretext/boxes.py``) -> crop/resize, rot90, small rotation, jitter, gray,
blur, flip, normalize. The randomness is sampled once for the batch by
:func:`sample_pretrain_aug_params`; both programs consume the same sampled
parameters, so from one generator state they see the same draws:

* :func:`pretrain_augment_batch_fused`: one ``fused_augment_clips`` call
  over the 2B concatenated clips (the CUDA kernel for CUDA tensors);
* :func:`pretrain_augment_batch`: the ops path of ``augment/ops.py``.

Under data parallelism (``shard=(rank, world)``) each rank draws the
parameters of the whole global batch from the same generator state, as the
JAX package draws the global batch's from one key, and keeps its own rows;
every row's draw depends on that row alone, so the ranks' views,
concatenated, are the one-process views of the global batch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from cstp_tpu_torch.augment import ops
from cstp_tpu_torch.augment.params import (
    JITTER_STRENGTH,
    ClipAugParams,
    concat_params,
    sample_clip_aug_params,
)
from cstp_tpu_torch.pretext.boxes import (
    sample_first_crop_box,
    sample_pair_boxes,
)

FT_JITTER_PROB = 0.3
EVAL_SHORT_SIDE = 128   # the eval transform's short side before the crop


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


def _spread(x: torch.Tensor, shard) -> torch.Tensor:
    """This rank's ``(b, ...)`` rows placed at rows ``[r b, (r+1) b)`` of a
    zero ``(N b, ...)`` global batch."""
    r, n = shard
    b = x.shape[0]
    out = x.new_zeros((n * b,) + tuple(x.shape[1:]))
    out[r * b:(r + 1) * b] = x
    return out


def _own_rows(x, shard, b: int):
    """Rows ``[r b, (r+1) b)`` of a global batch's tensor or parameter
    tuple."""
    if isinstance(x, tuple):
        return type(x)(*(_own_rows(v, shard, b) for v in x))
    r = shard[0]
    return x[r * b:(r + 1) * b]


def _sample(gen, frames1, rot1, rot2, shard=(0, 1)):
    b, t, h0, w0, _ = frames1.shape
    n = shard[1]
    if n == 1:
        return sample_pretrain_aug_params(gen, b, t, float(w0), float(h0),
                                          rot1, rot2)
    # the other ranks' labels are unknown here and only steer their rows
    sampled = sample_pretrain_aug_params(
        gen, n * b, t, float(w0), float(h0), _spread(rot1, shard),
        _spread(rot2, shard))
    return tuple(_own_rows(x, shard, b) for x in sampled)


def pretrain_augment_batch_fused(gen, frames1, frames2, rot1, rot2,
                                 sample_size: int = 112,
                                 norm_method: str = "tf",
                                 out_dtype=torch.bfloat16, shard=(0, 1)
                                 ) -> Tuple[torch.Tensor, ...]:
    """Sample, then one fused augment call; ``(view1, view2, spa)`` with
    views in ``out_dtype``. ``shard``: ``(rank, world)`` of a rank's rows
    (module docstring)."""
    sampled = _sample(gen, frames1, rot1, rot2, shard)
    v1, v2 = apply_pretrain_aug_fused(frames1, frames2, rot1, rot2, sampled,
                                      sample_size, norm_method, out_dtype)
    return v1, v2, sampled[2]


def pretrain_augment_batch(gen, frames1, frames2, rot1, rot2,
                           sample_size: int = 112, norm_method: str = "tf",
                           shard=(0, 1)):
    """Sample, then the ops path; ``(view1, view2, spa)`` with float32
    views. ``shard``: ``(rank, world)`` of a rank's rows."""
    sampled = _sample(gen, frames1, rot1, rot2, shard)
    v1, v2 = apply_pretrain_aug(frames1, frames2, rot1, rot2, sampled,
                                sample_size, norm_method)
    return v1, v2, sampled[2]


class FinetuneAugParams(NamedTuple):
    box: torch.Tensor       # (B, 4) f32 (x, y, w, h) crop boxes in pixels
    jit_on: torch.Tensor    # (B,) bool: colour jitter applied
    factors: torch.Tensor   # (B, 4) f32 brightness/contrast/saturation/hue


def sample_finetune_aug_params(gen: torch.Generator, batch: int, h0: int,
                               w0: int, device) -> FinetuneAugParams:
    """Per clip: the first crop box (``bottom_area=0.2``), the jitter-on
    flag (p 0.3) and four jitter factors (``JITTER_STRENGTH``)."""
    full = torch.ones(batch, device=device)
    box = sample_first_crop_box(gen, full * float(w0), full * float(h0),
                                bottom_area=0.2)
    jit_on = torch.rand((batch,), generator=gen, device=device) < FT_JITTER_PROB
    u = torch.rand((batch, 4), generator=gen, device=device)
    b, c, s, h = JITTER_STRENGTH
    lo = torch.tensor([1.0 - b, 1.0 - c, 1.0 - s, -h], device=device)
    hi = torch.tensor([1.0 + b, 1.0 + c, 1.0 + s, h], device=device)
    return FinetuneAugParams(box, jit_on, lo + (hi - lo) * u)


def apply_finetune_aug(frames: torch.Tensor, p: FinetuneAugParams,
                       sample_size: int = 112, norm_method: str = "tf"):
    """Crop/resize each clip to its box, jitter where on, normalise:
    ``(B, T, H0, W0, 3)`` uint8 -> ``(B, T, S, S, 3)`` float32."""
    clip = ops.crop_resize_clip(frames.float(), p.box, sample_size)
    jittered = ops.color_jitter_clip(clip, p.factors)
    clip = torch.where(p.jit_on.view(-1, 1, 1, 1, 1), jittered, clip)
    return ops.normalize_clip(clip, norm_method)


def finetune_train_augment_batch(gen: torch.Generator, frames: torch.Tensor,
                                 sample_size: int = 112,
                                 norm_method: str = "tf",
                                 shard=(0, 1)) -> torch.Tensor:
    """Sample, then apply: ``(B, T, H0, W0, 3)`` uint8 -> ``(B, T, S, S, 3)``
    float32 in [-1, 1] ('tf'). ``shard``: ``(rank, world)`` of a rank's
    rows: the global batch's parameters are drawn, this rank's kept."""
    b, _, h0, w0, _ = frames.shape
    p = sample_finetune_aug_params(gen, shard[1] * b, h0, w0, frames.device)
    if shard[1] > 1:
        p = _own_rows(p, shard, b)
    return apply_finetune_aug(frames, p, sample_size, norm_method)


def eval_augment_batch(frames: torch.Tensor, sample_size: int = 112,
                       norm_method: str = "tf") -> torch.Tensor:
    """Scale the short side to ``EVAL_SHORT_SIDE``, centre crop
    ``sample_size``, normalise, as one box ``side = S / EVAL_SHORT_SIDE *
    min(H0, W0)`` centred in the frame for the whole batch.
    Deterministic."""
    b, _, h0, w0, _ = frames.shape
    side = sample_size / EVAL_SHORT_SIDE * min(h0, w0)
    box = torch.tensor([(w0 - side) / 2.0, (h0 - side) / 2.0, side, side],
                       dtype=torch.float32, device=frames.device)
    clip = ops.crop_resize_clip(frames.float(), box.expand(b, 4), sample_size)
    return ops.normalize_clip(clip, norm_method)
