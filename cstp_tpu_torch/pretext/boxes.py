"""Spatial-overlap crop-box sampling, batched over clips.

The port of ``cstp_tpu/pretext/boxes.py``: the same closed-form laws
(first box by 10 random-resized-crop attempts with a centred-square
fallback; second box from the exact stationary law of the reference's
rejection loop), written on ``(N,)`` tensors with an explicit
``torch.Generator`` in place of ``vmap`` and ``jax.random`` keys. The two
generators give different numbers; the laws are held equal by distribution
tests.

Boxes are ``(N, 4)`` float32 ``(x, y, w, h)`` in pixels.
"""

from __future__ import annotations

import torch

from cstp_tpu_torch.pretext.sampling import OVERLAP_SPA_RATE


def _uniform(gen, shape, lo, hi, device):
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


def _randint(gen, minval, maxval_inclusive):
    """Uniform integer in [minval, maxval_inclusive] (float tensors carrying
    ints), python ``random.randint`` semantics."""
    u = torch.rand(minval.shape, generator=gen, device=minval.device)
    n = torch.clamp(maxval_inclusive - minval + 1.0, min=1.0)
    return minval + torch.minimum(torch.clamp(torch.floor(u * n), min=0.0),
                                  n - 1.0)


def sample_first_crop_box(gen, img_w, img_h, bottom_area: float = 0.2,
                          attempts: int = 10):
    """flag=0 crop: ``img_w``/``img_h`` are (N,) float tensors."""
    n, dev = img_w.shape[0], img_w.device
    area = (img_w * img_h)[:, None]
    frac = _uniform(gen, (n, attempts), bottom_area, 1.0, dev)
    target_area = frac * area
    ar = _uniform(gen, (n, attempts), 3.0 / 4.0, 4.0 / 3.0, dev)
    w = torch.round(torch.sqrt(target_area * ar))
    h = torch.round(torch.sqrt(target_area / ar))
    swap = torch.rand((n, attempts), generator=gen, device=dev) < 0.5
    w, h = torch.where(swap, h, w), torch.where(swap, w, h)
    valid = (w <= img_w[:, None]) & (h <= img_h[:, None])
    any_valid = valid.any(dim=1)
    first = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)
    side = torch.minimum(img_w, img_h)
    w_pick = torch.where(any_valid, w.gather(1, first)[:, 0], side)
    h_pick = torch.where(any_valid, h.gather(1, first)[:, 0], side)
    zero = torch.zeros_like(img_w)
    x1 = torch.where(any_valid, _randint(gen, zero, img_w - w_pick),
                     torch.round((img_w - w_pick) / 2.0))
    y1 = torch.where(any_valid, _randint(gen, zero, img_h - h_pick),
                     torch.round((img_h - h_pick) / 2.0))
    return torch.stack([x1, y1, w_pick, h_pick], dim=1)


def sample_second_crop_box(gen, box1, img_w, img_h):
    """flag=1 crop: same-size box overlapping ``box1`` by
    ``OVERLAP_SPA_RATE[spa]`` of its area, anchored at one of 4 corners.
    Returns ``(box2 (N, 4), spa (N,) int64)``."""
    p_x, p_y, p_w, p_h = (box1[:, i:i + 1] for i in range(4))   # (N, 1)
    iw, ih = img_w[:, None], img_h[:, None]
    rates = torch.tensor(OVERLAP_SPA_RATE, dtype=torch.float32,
                         device=box1.device)[None, :]           # (1, 5)
    s_w_lo = torch.floor(rates * p_w)                           # (N, 5)
    n_range = p_w - s_w_lo + 1.0
    a_c = torch.cat([p_w - p_x, p_x + 2 * p_w - iw,
                     p_w - p_x, p_x + 2 * p_w - iw], dim=1)     # (N, 4)
    b_c = torch.cat([p_h - p_y, p_h - p_y,
                     p_y + 2 * p_h - ih, p_y + 2 * p_h - ih], dim=1)
    area1 = rates * p_w * p_h                                   # (N, 5)
    hi_b = torch.where(
        b_c[:, None, :] >= 1.0,
        torch.floor(area1[:, :, None]
                    / torch.clamp(b_c[:, None, :], min=1.0)),
        torch.full_like(area1[:, :, None].expand(-1, -1, 4), float("inf")))
    lo = torch.maximum(s_w_lo[:, :, None], torch.ceil(a_c[:, None, :]))
    hi = torch.minimum(p_w[:, :, None], hi_b)                    # (N, 5, 4)
    n_valid = torch.clamp(hi - lo + 1.0, min=0.0)
    weight = (n_valid / n_range[:, :, None]).reshape(-1, 20)
    choice = torch.multinomial(weight, 1, generator=gen)[:, 0]   # (N,)
    spa = torch.div(choice, 4, rounding_mode="floor")
    corner = choice % 4
    lo_c = lo.reshape(-1, 20).gather(1, choice[:, None])[:, 0]
    hi_c = hi.reshape(-1, 20).gather(1, choice[:, None])[:, 0]
    s_w = _randint(gen, lo_c, hi_c)
    s_h = torch.floor(area1.gather(1, spa[:, None])[:, 0] / s_w)
    p_x, p_y, p_w, p_h = (box1[:, i] for i in range(4))
    is_right = (corner == 1) | (corner == 3)
    is_bottom = (corner == 2) | (corner == 3)
    e_w = torch.where(is_right, p_x + 2 * p_w - s_w, p_x + s_w)
    e_h = torch.where(is_bottom, p_y + 2 * p_h - s_h, p_y + s_h)
    box2 = torch.stack([e_w - p_w, e_h - p_h, p_w, p_h], dim=1)
    return box2, spa


def rot90_box_to_original(box, k, img_w0: float, img_h0: float):
    """Map (N, 4) boxes from rot90^k(image) coordinates back to the
    original frame (``k`` counts 90-degree CCW turns)."""
    a, b, w, h = (box[:, i] for i in range(4))
    cands = torch.stack([
        torch.stack([a, b, w, h], 1),
        torch.stack([img_w0 - b - h, a, h, w], 1),
        torch.stack([img_w0 - a - w, img_h0 - b - h, w, h], 1),
        torch.stack([b, img_h0 - a - w, h, w], 1),
    ], dim=1)                                                   # (N, 4, 4)
    idx = (k.long() % 4)[:, None, None].expand(-1, 1, 4)
    return cands.gather(1, idx)[:, 0]


def rotated_dims(k, img_w0: float, img_h0: float):
    """(w, h) of rot90^k(image), as (N,) float tensors."""
    odd = (k % 2) == 1
    w0 = torch.full(k.shape, float(img_w0), device=k.device)
    h0 = torch.full(k.shape, float(img_h0), device=k.device)
    return torch.where(odd, h0, w0), torch.where(odd, w0, h0)


def sample_pair_boxes(gen, rot1, rot2, img_w0: float, img_h0: float,
                      bottom_area: float = 0.2):
    """Both clips' crop boxes in ORIGINAL coordinates plus the spa label;
    ``rot1``/``rot2`` are (N,) integer tensors."""
    w1, h1 = rotated_dims(rot1, img_w0, img_h0)
    w2, h2 = rotated_dims(rot2, img_w0, img_h0)
    box1_rot = sample_first_crop_box(gen, w1, h1, bottom_area)
    box2_rot, spa = sample_second_crop_box(gen, box1_rot, w2, h2)
    box1 = rot90_box_to_original(box1_rot, rot1, img_w0, img_h0)
    box2 = rot90_box_to_original(box2_rot, rot2, img_w0, img_h0)
    return box1, box2, spa
