"""The port's samplers against the JAX package's, in distribution.

``torch.Generator`` cannot replay JAX's threefry streams, so the port's
``sample_pair_boxes`` and ``sample_clip_aug_params`` are held to JAX's by
their laws: label histograms, rates and ranges over ``N`` draws from each.
A rate ``p`` estimated twice from ``N`` draws differs by
``sqrt(2 p (1 - p) / N)`` in standard deviation; the tests allow five.
"""

import jax
import numpy as np
import pytest
import torch

from cstp_tpu.augment.params import sample_clip_aug_params as jax_aug_params
from cstp_tpu.pretext.boxes import sample_pair_boxes as jax_pair_boxes
from cstp_tpu.pretext.sampling import OVERLAP_SPA_RATE
from cstp_tpu_torch.augment import params as P
from cstp_tpu_torch.pretext import boxes as B

N, T = 20000, 4
W0, H0 = 171.0, 128.0


def _close_rates(a, b, what):
    p = 0.5 * (a + b)
    sigma = np.sqrt(2.0 * p * (1.0 - p) / N) + 1e-12
    assert np.all(np.abs(a - b) <= 5.0 * sigma), (what, a, b)


@pytest.fixture(scope="module")
def boxes():
    rng = np.random.default_rng(0)
    rot1 = rng.integers(0, 4, N).astype(np.int32)
    rot2 = rng.integers(0, 4, N).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    run = jax.jit(jax.vmap(lambda k, a, b: jax_pair_boxes(k, a, b, W0, H0)))
    jb1, jb2, jspa = map(np.asarray, run(keys, rot1, rot2))
    gen = torch.Generator().manual_seed(0)
    pb1, pb2, pspa = B.sample_pair_boxes(gen, torch.from_numpy(rot1),
                                         torch.from_numpy(rot2), W0, H0)
    return dict(jax=(jb1, jb2, jspa), port=(pb1.numpy(), pb2.numpy(),
                                            pspa.numpy()),
                rot1=rot1, rot2=rot2)


def test_spa_label_histogram_matches(boxes):
    hist = {k: np.bincount(boxes[k][2], minlength=5) / N
            for k in ("jax", "port")}
    assert hist["port"].shape == (5,) and (hist["port"] > 0).all()
    _close_rates(hist["port"], hist["jax"], "spa histogram")


def _rotated_frame_stats(b1, rot):
    """Area fraction and aspect of box1 in its rotated frame."""
    odd = rot % 2 == 1
    w, h = b1[:, 2], b1[:, 3]
    rw = np.where(odd, H0, W0)
    rh = np.where(odd, W0, H0)
    # odd rotations swap the box's w/h back when mapped to the original
    bw, bh = np.where(odd, h, w), np.where(odd, w, h)
    return bw * bh / (rw * rh), bw / bh


def test_first_box_area_and_aspect_match(boxes):
    rot = boxes["rot1"]
    jarea, jar = _rotated_frame_stats(boxes["jax"][0], rot)
    parea, par = _rotated_frame_stats(boxes["port"][0], rot)
    for area, ar in ((jarea, jar), (parea, par)):
        assert area.min() >= 0.15 and area.max() <= 1.0 + 1e-6
        assert ar.min() >= 0.5 and ar.max() <= 2.0
    for q in (0.1, 0.5, 0.9):
        # quantiles of a smooth law: 5 sigma of a quantile estimate is
        # well under 0.02 at N draws
        assert abs(np.quantile(parea, q) - np.quantile(jarea, q)) < 0.02, q
        assert abs(np.quantile(par, q) - np.quantile(jar, q)) < 0.03, q


def test_boxes_lie_in_frame_and_overlap_by_label(boxes):
    """Box 1 lies in the frame; box 2 has box 1's area; where both clips
    share a rotation, box 2 overlaps box 1 by the label's rate (to the
    reference's integer slack, as tests/test_boxes.py allows)."""
    same = boxes["rot1"] == boxes["rot2"]
    for b1, b2, spa in (boxes["port"], boxes["jax"]):
        assert (b1[:, :2] >= 0).all()
        assert (b1[:, 0] + b1[:, 2] <= W0 + 1e-3).all()
        assert (b1[:, 1] + b1[:, 3] <= H0 + 1e-3).all()
        np.testing.assert_allclose(b1[:, 2] * b1[:, 3], b2[:, 2] * b2[:, 3])
        lo = np.maximum(b1[same, :2], b2[same, :2])
        hi = np.minimum(b1[same, :2] + b1[same, 2:], b2[same, :2]
                        + b2[same, 2:])
        inter = np.prod(np.clip(hi - lo, 0.0, None), axis=1)
        got = inter / (b1[same, 2] * b1[same, 3])
        assert np.abs(got - np.asarray(OVERLAP_SPA_RATE)[spa[same]]).max() \
            < 0.08


def test_rot90_box_roundtrip():
    """Cropping the rotated image equals rotating the crop of the mapped
    box, for every k (the JAX package's geometry)."""
    img = np.random.default_rng(1).integers(0, 255, (16, 24))
    h0, w0 = img.shape
    a, b, w, h = 3.0, 2.0, 7.0, 5.0
    for k in range(4):
        rot = np.rot90(img, k)
        want = rot[int(b):int(b + h), int(a):int(a + w)]
        box = B.rot90_box_to_original(torch.tensor([[a, b, w, h]]),
                                      torch.tensor([k]), float(w0),
                                      float(h0))[0]
        x0, y0, ww, hh = (int(v) for v in box)
        np.testing.assert_array_equal(
            np.rot90(img[y0:y0 + hh, x0:x0 + ww], k), want)


@pytest.fixture(scope="module")
def aug_params():
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    jp = jax.jit(jax.vmap(lambda k: jax_aug_params(k, T)))(keys)
    jp = P.ClipAugParams(*(np.asarray(a) for a in jp))
    pp = P.sample_clip_aug_params(torch.Generator().manual_seed(1), N, T,
                                  "cpu")
    return dict(jax=jp, port=P.ClipAugParams(*(a.numpy() for a in pp)))


def _rates(p):
    ident = np.float32([1.0, 1.0, 1.0, 0.0])
    eye = np.eye(3, dtype=np.float32)
    return np.array([
        (p.angle != 0).mean(),
        (p.factors != ident).any(1).mean(),
        (p.graymix != eye).any((1, 2, 3)).mean(),
        (p.sigma > 0).mean(),
        p.flip.mean(),
    ])


def test_aug_rates_match(aug_params):
    """Base, jitter, gray, blur and flip rates of the two samplers, and
    both against the rates the constants define."""
    got, want = _rates(aug_params["port"]), _rates(aug_params["jax"])
    _close_rates(got, want, "rates")
    expected = np.array([P.BASE_PROB, P.BASE_PROB * P.JITTER_PROB,
                         P.BASE_PROB * P.GRAY_PROB, P.BASE_PROB * P.BLUR_PROB,
                         P.FLIP_PROB])
    _close_rates(got, expected, "rates vs constants")


def test_aug_ranges_and_encoding(aug_params):
    """Drawn values lie in the JAX ranges; 'off' is identity-valued; a gray
    frame copies one channel to all three."""
    for p in aug_params.values():
        on = p.angle != 0
        assert np.abs(p.angle).max() <= P.ROT_DEG
        jit = (p.factors != np.float32([1, 1, 1, 0])).any(1)
        f = p.factors[jit]
        assert (np.abs(f[:, :3] - 1.0) <= 0.4 + 1e-6).all()
        assert (np.abs(f[:, 3]) <= 0.1 + 1e-6).all()
        assert not (jit & ~on).any()
        s = p.sigma[p.sigma > 0]
        assert s.min() >= 0.1 and s.max() <= 2.0
        g = p.graymix[(p.graymix != np.eye(3)).any((1, 2, 3))]
        assert (g.sum(-1) == 1).all() and (g[:, :, 0] == g[:, :, 1]).all()
    chans = aug_params["port"].graymix.argmax(-1)[..., 0].ravel()
    _close_rates(np.bincount(chans, minlength=3) / chans.size,
                 np.bincount(aug_params["jax"].graymix.argmax(-1)[..., 0]
                             .ravel(), minlength=3) / chans.size,
                 "gray channel histogram")


def test_overlap_rates_constant_is_the_jax_one():
    assert tuple(B.OVERLAP_SPA_RATE) == tuple(OVERLAP_SPA_RATE)
