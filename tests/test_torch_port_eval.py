"""The port's finetune and eval augment, eval/logits/features steps and
video-level test helpers against the JAX package's, on the CPU.

Tolerances:
- finetune augment at the parameter seam (JAX draws the boxes, jitter flags
  and factors with its own key structure; both sides apply them): atol
  1e-4 on [-1, 1] clips: float32 resampling and jitter sums in another
  order, about 2e-6 measured, kept with room for a hue that lands on a
  sector edge of the HSV map on one side only;
- ``eval_augment_batch``: atol 1e-5 (one deterministic box, the resampling
  sums alone);
- eval, logits and features steps (float32, bridged weights): rtol 1e-4,
  atol 1e-5, as the classify forward;
- ``sliding_window_indices``, ``pad_windows_to_bucket`` and
  ``retrieval_recalls`` (on tie-free features): exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.augment.params import JITTER_STRENGTH
from cstp_tpu.augment.pipeline import (
    eval_augment_batch as jax_eval_aug,
    finetune_train_augment_batch as jax_ft_aug,
)
from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.pretext.boxes import sample_first_crop_box
from cstp_tpu.train import finetune as jft
from cstp_tpu.train.finetune import create_finetune_state as jax_create_state
from cstp_tpu_torch.augment.pipeline import (
    FinetuneAugParams,
    apply_finetune_aug,
    eval_augment_batch,
    finetune_train_augment_batch,
)
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models.bridge import load_jax_variables
from cstp_tpu_torch.train import finetune as pft

from _torch_threads import torch_threads  # noqa: F401

B, T, S, H0, W0 = 6, 4, 32, 40, 56
N_CLASSES = 5


def _jax_finetune_params(key, n, h0, w0):
    """The finetune augment's per-clip draws with JAX's key structure
    (``cstp_tpu/augment/pipeline.py _finetune_one_sample``)."""
    boxes, on, factors = [], [], []
    b, c, s, h = JITTER_STRENGTH
    for k in jax.random.split(key, n):
        k_box, k_jit_on, k_jit = jax.random.split(k, 3)
        boxes.append(sample_first_crop_box(k_box, float(w0), float(h0),
                                           bottom_area=0.2))
        on.append(jax.random.bernoulli(k_jit_on, 0.3))
        lims = ((1 - b, 1 + b), (1 - c, 1 + c), (1 - s, 1 + s), (-h, h))
        factors.append(jnp.stack([
            jax.random.uniform(k_jit if i == 0 else jax.random.fold_in(k_jit, i),
                               minval=lo, maxval=hi)
            for i, (lo, hi) in enumerate(lims)]))
    return FinetuneAugParams(*(torch.from_numpy(np.array(jnp.stack(a)))
                               for a in (boxes, on, factors)))


def _frames(seed, n=B, h0=H0, w0=W0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, T, h0, w0, 3)).astype(np.uint8)


def test_finetune_augment_matches_jax_at_param_seam():
    frames = _frames(0)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_ft_aug(key, frames, sample_size=S))
    p = _jax_finetune_params(key, B, H0, W0)
    assert bool(p.jit_on.any()) and not bool(p.jit_on.all())
    got = apply_finetune_aug(torch.from_numpy(frames), p, sample_size=S)
    assert got.dtype == torch.float32 and got.shape == (B, T, S, S, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_finetune_augment_sampler_draws_in_range():
    """The port's own draws: boxes inside the frame and at least 0.2 of its
    area (or the centred-square fallback), the jitter flag with p 0.3 and
    factors within ``JITTER_STRENGTH``; the same generator state gives the
    same clips."""
    from cstp_tpu_torch.augment.pipeline import sample_finetune_aug_params

    n = 4000
    p = sample_finetune_aug_params(torch.Generator().manual_seed(0), n, H0,
                                   W0, "cpu")
    x, y, w, h = p.box.unbind(1)
    assert bool(((x >= 0) & (y >= 0) & (x + w <= W0) & (y + h <= H0)).all())
    assert bool((w * h >= 0.2 * H0 * W0 * 0.9).all())
    assert abs(p.jit_on.float().mean().item() - 0.3) < 0.03
    b, c, s, hue = JITTER_STRENGTH
    lo = torch.tensor([1 - b, 1 - c, 1 - s, -hue])
    hi = torch.tensor([1 + b, 1 + c, 1 + s, hue])
    assert bool(((p.factors >= lo) & (p.factors <= hi)).all())
    frames = torch.from_numpy(_frames(1))
    a = finetune_train_augment_batch(torch.Generator().manual_seed(3), frames,
                                     sample_size=S)
    b2 = finetune_train_augment_batch(torch.Generator().manual_seed(3), frames,
                                      sample_size=S)
    assert torch.equal(a, b2) and float(a.abs().max()) <= 1.0


@pytest.mark.parametrize("hw", [(H0, W0), (56, 40), (32, 32)])
def test_eval_augment_matches_jax(hw):
    frames = _frames(2, h0=hw[0], w0=hw[1])
    want = np.asarray(jax_eval_aug(frames, sample_size=S))
    got = eval_augment_batch(torch.from_numpy(frames), sample_size=S)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def eval_models():
    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              fused_conv=1, task="test", n_finetune_classes=N_CLASSES)
    jcfg = JaxConfig(**kw).finalize()
    jmodel, jstate, _ = jax_create_state(jcfg, jax.random.PRNGKey(1),
                                         N_CLASSES)
    # running statistics away from their (0, 1) init, so eval mode uses them
    _, mutated = jmodel.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jax_eval_aug(_frames(5), sample_size=S), train=True,
        mutable=["batch_stats"])
    jstate = jstate.replace(batch_stats=mutated["batch_stats"])
    cfg = Config(**kw).finalize()
    model, state, _ = pft.create_finetune_state(cfg, N_CLASSES, device="cpu")
    load_jax_variables(model, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    return jmodel, jstate, jcfg, model, state, cfg


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("mask", [None, (1, 1, 0, 1, 0, 0)])
def test_eval_step_matches_jax(eval_models, mask):
    jmodel, jstate, jcfg, model, state, cfg = eval_models
    rng = np.random.default_rng(6)
    batch = {"frames": _frames(6),
             "labels": rng.integers(0, N_CLASSES, (B,)).astype(np.int32)}
    if mask is not None:
        batch["mask"] = np.asarray(mask, np.float32)
    want = jft.make_eval_step(jmodel, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = pft.make_eval_step(model, cfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k].numpy(), want[k])


def test_logits_and_features_steps_match_jax(eval_models):
    jmodel, jstate, jcfg, model, state, cfg = eval_models
    windows = _frames(7, n=3)
    want = jft.make_logits_step(jmodel, jcfg)(jstate, jnp.asarray(windows))
    got = pft.make_logits_step(model, cfg)(state, torch.from_numpy(windows))
    _close(got.numpy(), want)
    want = jft.make_features_step(jmodel, jcfg)(jstate, jnp.asarray(windows))
    got = pft.make_features_step(model, cfg)(state,
                                             torch.from_numpy(windows))
    assert got.shape == (3, 512)
    _close(got.numpy(), want)


def test_sliding_window_indices_match_jax():
    for nframes in range(1, 90):
        for duration in (4, 16):
            for rate in (1, 2, 4):
                for max_windows in (0, 2):
                    got = pft.sliding_window_indices(nframes, duration, rate,
                                                     max_windows)
                    want = jft.sliding_window_indices(nframes, duration, rate,
                                                      max_windows)
                    assert got.dtype == want.dtype
                    np.testing.assert_array_equal(got, want)


def test_pad_windows_to_bucket_matches_jax():
    for n in range(1, 140):
        windows = np.arange(n * 2, dtype=np.int32).reshape(n, 2)
        got, gn = pft.pad_windows_to_bucket(windows)
        want, wn = jft.pad_windows_to_bucket(windows)
        assert gn == wn == n
        np.testing.assert_array_equal(got, want)


def test_retrieval_recalls_match_jax():
    rng = np.random.default_rng(8)

    def feats(n):
        f = rng.normal(size=(n, 16)).astype(np.float32)
        return f / np.linalg.norm(f, axis=1, keepdims=True)

    q, g = feats(37), feats(100)
    ql = rng.integers(0, 6, 37)
    gl = rng.integers(0, 6, 100)
    for topk in ((1, 5, 10, 20, 50), (1, 3, 200)):
        want, whit = jft.retrieval_recalls(q, ql, g, gl, topk=topk, chunk=16,
                                           return_per_query=True)
        got, ghit = pft.retrieval_recalls(q, ql, g, gl, topk=topk, chunk=16,
                                          return_per_query=True,
                                          device="cpu")
        assert got == want
        np.testing.assert_array_equal(ghit, whit)
