"""Clip augmentation pixel ops, batched over clips.

The port of ``cstp_tpu/augment/ops.py`` as used by the pretrain chain. Clips
are float32 ``(N, T, H, W, C)`` in [0, 255] until the final normalize; every
per-clip parameter is an ``(N, ...)`` tensor, so one call covers the batch
(the JAX package ``vmap``s a per-clip function instead). Resampling (crop +
resize, shears, blur) is written as per-clip band matrices contracted with
``einsum``, exactly the JAX formulation. Together these ops are the plain
version of the fused augment kernel (``cstp_tpu_torch/ops/augment.py``).
"""

from __future__ import annotations

import math

import torch

_LUMA = (0.299, 0.587, 0.114)  # PIL "L" weights
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _kernel_cubic(d):
    """Catmull-Rom (a = -0.5), the PIL BICUBIC kernel."""
    a = -0.5
    ad = d.abs()
    ad2, ad3 = ad * ad, ad * ad * ad
    inner = (a + 2.0) * ad3 - (a + 3.0) * ad2 + 1.0
    outer = a * ad3 - 5.0 * a * ad2 + 8.0 * a * ad - 4.0 * a
    zero = torch.zeros_like(ad)
    return torch.where(ad <= 1.0, inner, torch.where(ad < 2.0, outer, zero))


def resample_weights(in_size: int, out_size: int, start, size):
    """``(N, out_size, in_size)`` row-stochastic bicubic crop+resize matrices
    for one axis; ``start``/``size`` are ``(N,)`` crop windows in input
    pixels (PIL half-pixel centres, antialiased on downscale). Taps outside
    the window are masked and rows renormalised; a row with no tap is 0."""
    dev = start.device
    scale = size / out_size                                     # (N,)
    fscale = torch.clamp(scale, min=1.0)
    out_i = torch.arange(out_size, dtype=torch.float32, device=dev)
    taps = torch.arange(in_size, dtype=torch.float32, device=dev) + 0.5
    centers = start[:, None] + (out_i[None, :] + 0.5) * scale[:, None]
    d = (taps[None, None, :] - centers[:, :, None]) / fscale[:, None, None]
    w = _kernel_cubic(d)
    inside = ((taps[None, None, :] >= torch.floor(start)[:, None, None])
              & (taps[None, None, :]
                 <= torch.ceil(start + size)[:, None, None]))
    w = torch.where(inside, w, torch.zeros_like(w))
    denom = w.sum(dim=2, keepdim=True)
    return torch.where(denom > 1e-6, w / torch.clamp(denom, min=1e-6),
                       torch.zeros_like(w))


def crop_resize_clip(frames, box, out_size: int):
    """Crop ``box`` (N, 4) = (x, y, w, h) from every frame of the
    ``(N, T, H, W, C)`` float clips and resize to (out_size, out_size)."""
    _, _, h_in, w_in, _ = frames.shape
    wy = resample_weights(h_in, out_size, box[:, 1], box[:, 3])   # (N,S,H)
    wx = resample_weights(w_in, out_size, box[:, 0], box[:, 2])   # (N,S,W)
    out = torch.einsum("nyh,nthwc->ntywc", wy, frames)
    return torch.einsum("nxw,ntywc->ntyxc", wx, out)


def rot90_clip(clip, k):
    """``rot90^k`` (counter-clockwise, ``np.rot90`` on the (H, W) axes) of
    square ``(N, T, S, S, C)`` clips, ``k`` an ``(N,)`` integer tensor."""
    rots = torch.stack([torch.rot90(clip, i, dims=(2, 3)) for i in range(4)])
    idx = (k.long() % 4).view(1, -1, 1, 1, 1, 1).expand(1, *clip.shape)
    return rots.gather(0, idx)[0]


def _shear_weights(s: int, shift):
    """``(N, S_rows, S_out, S_in)`` linear-interp band matrices: row r of
    clip n resamples a length-S axis at ``x_in = x_out + shift[n, r]`` with
    zero fill."""
    idx = torch.arange(s, dtype=torch.float32, device=shift.device)
    src = idx[None, None, :, None] + shift[:, :, None, None]
    w = torch.clamp(1.0 - (idx[None, None, None, :] - src).abs(), min=0.0)
    inside = (src >= 0.0) & (src <= s - 1)
    return torch.where(inside, w, torch.zeros_like(w))


def rotate_small_clip(clip, angle_deg):
    """Rotate square clips by small angles (degrees, CCW) about the centre
    with black fill, as three shears:
    ``shear_x(-tan θ/2) · shear_y(sin θ) · shear_x(-tan θ/2)``."""
    s = clip.shape[2]
    theta = angle_deg * math.pi / 180.0
    rows = torch.arange(s, dtype=torch.float32, device=clip.device) - (s - 1) / 2.0
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    wx = _shear_weights(s, a[:, None] * rows[None, :])
    wy = _shear_weights(s, b[:, None] * rows[None, :])
    out = torch.einsum("nyxw,ntywc->ntyxc", wx, clip)
    out = torch.einsum("nxyh,nthxc->ntyxc", wy, out)
    return torch.einsum("nyxw,ntywc->ntyxc", wx, out)


def _luma(clip):
    return (_LUMA[0] * clip[..., 0] + _LUMA[1] * clip[..., 1]
            + _LUMA[2] * clip[..., 2])


def _bcast(v, clip):
    """(N,) per-clip scalar -> broadcastable against (N, T, H, W, C)."""
    return v.view(-1, *([1] * (clip.dim() - 1)))


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.amax(dim=-1)
    mn = rgb.amin(dim=-1)
    diff = mx - mn
    safe = torch.where(diff == 0, torch.ones_like(diff), diff)
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    h = torch.where(diff == 0, torch.zeros_like(h), h / 6.0)
    h = h - torch.floor(h)
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    diff / torch.clamp(mx, min=1e-12))
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.to(torch.int64) % 6
    table = {0: (v, t, p), 1: (q, v, p), 2: (p, v, t),
             3: (p, q, v), 4: (t, p, v), 5: (v, p, q)}
    out = [torch.zeros_like(v) for _ in range(3)]
    for k, vals in table.items():
        sel = i == k
        out = [torch.where(sel, val, o) for val, o in zip(vals, out)]
    return torch.stack(out, dim=-1)


def color_jitter_clip(clip, factors):
    """Brightness -> contrast (per-frame mean luma) -> saturation -> hue,
    clipped to [0, 255]; ``factors`` is (N, 4). The HSV round trip runs
    only for clips whose hue shift is nonzero."""
    clip = clip * _bcast(factors[:, 0], clip)
    fc = _bcast(factors[:, 1], clip)
    mean = _luma(clip).mean(dim=(2, 3))[:, :, None, None, None]
    clip = clip * fc + (1.0 - fc) * mean
    fs = _bcast(factors[:, 2], clip)
    clip = clip * fs + (1.0 - fs) * _luma(clip)[..., None]
    hue = factors[:, 3]
    h, s, v = _rgb_to_hsv(clip / 255.0)
    h = h + _bcast(hue, h)
    shifted = _hsv_to_rgb(h - torch.floor(h), s, v) * 255.0
    clip = torch.where(_bcast(hue != 0.0, clip), shifted, clip)
    return torch.clamp(clip, 0.0, 255.0)


def gray_mix_clip(clip, graymix):
    """Per-frame 3x3 channel mix, ``graymix`` (N, T, 3, 3); identity = off."""
    return torch.einsum("ntcd,nthwd->nthwc", graymix, clip)


def gaussian_blur_clip(clip, sigma, radius: int = 7):
    """Separable Gaussian blur, one sigma per clip, 2*radius+1 taps with
    boundary rows renormalised."""
    s = clip.shape[2]
    dev = clip.device
    idx = torch.arange(s, dtype=torch.float32, device=dev)
    off = idx[None, :] - idx[:, None]                               # (S, S)
    sg = torch.clamp(sigma, min=1e-3)
    g = torch.exp(-(off * off)[None] / (2.0 * sg[:, None, None] ** 2))
    g = torch.where(off.abs()[None] <= radius, g, torch.zeros_like(g))
    band = g / g.sum(dim=2, keepdim=True)                           # (N,S,S)
    out = torch.einsum("nyh,nthwc->ntywc", band, clip)
    return torch.einsum("nxw,ntywc->ntyxc", band, out)


def hflip_clip(clip):
    return clip.flip(3)


def normalize_clip(clip, method: str = "tf"):
    """'tf' = x/255*2-1 clamped to [-1, 1]; 'imagenet' = per-channel
    (x/255 - mean)/std."""
    if method == "tf":
        return torch.clamp(clip / 255.0 * 2.0 - 1.0, -1.0, 1.0)
    if method == "imagenet":
        mean = torch.tensor(_IMAGENET_MEAN, device=clip.device)
        std = torch.tensor(_IMAGENET_STD, device=clip.device)
        return (clip / 255.0 - mean) / std
    raise ValueError(f"unknown norm_method {method!r}")
