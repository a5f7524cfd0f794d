"""``--grad_accum 2`` in the port's pretrain and finetune steps against the
JAX package's, on the CPU in float32, from the same bridged weights.

Each microbatch normalises by its own batch statistics (per view in the
pretrain step), the BN running statistics advance once per microbatch in
order, the gradients are averaged and one update is taken, and the EMA of
the target tower moves once per step. Tolerances are those of
``tests/test_torch_port_pretrain.py``: losses and metrics rtol 1e-4 (atol
1e-5), BN running statistics rtol 1e-4 (atol 1e-5), parameter updates leaf by
leaf in norm, ``|got - want| <= 5e-2 |want| +
1e-4 |all of want|`` (the float32 gradient of BatchNorm over pooled
features is ill conditioned at test sizes). Each BN group of a microbatch
holds four clips that differ in colour offset and contrast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.augment.pipeline import finetune_train_augment_batch as jax_aug
from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.train.finetune import (
    create_finetune_state as jax_create_finetune_state,
    make_finetune_step as jax_make_finetune_step,
)
from cstp_tpu.train.pretrain import (
    create_pretrain_state as jax_create_pretrain_state,
    split_pretrain_step as jax_split_step,
)
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models.bridge import export_jax_variables, load_jax_variables
from cstp_tpu_torch.train.finetune import (
    create_finetune_state,
    make_preaugmented_finetune_step,
)
from cstp_tpu_torch.train.accum import microbatches
from cstp_tpu_torch.train.pretrain import (
    create_pretrain_state,
    make_preaugmented_step,
)

from _torch_threads import torch_threads  # noqa: F401

B, T, S = 8, 4, 32
LR = 3e-4
ACCUM = 2
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _clips(rng, n=B, s=S):
    noise = rng.uniform(-1, 1, (n, T, s, s, 3))
    off = rng.uniform(-0.8, 0.8, (n, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (n, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def _kw(**over):
    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              fused_conv=1, learning_rate=LR, grad_accum=ACCUM,
              mesh_shape=(1, 1))
    kw.update(over)
    return kw


def _assert_close(got, want, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {k}")


def _assert_close_in_norm(got, want, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    floor = 1e-4 * np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                               for v in w.values()))
    for k in w:
        err = np.linalg.norm(g[k] - w[k])
        assert err <= 5e-2 * np.linalg.norm(w[k]) + floor, (
            f"{what} {k}: |got - want| {err:.3e}, |want| "
            f"{np.linalg.norm(w[k]):.3e}")


def _delta(params, p0):
    return jax.tree_util.tree_map(np.subtract, params, p0)


@pytest.fixture(scope="module")
def pretrain_two_steps():
    kw = _kw()
    jcfg = JaxConfig(**kw).finalize()
    jmodel, jstate, jtx = jax_create_pretrain_state(jcfg,
                                                    jax.random.PRNGKey(0))
    params0 = _np_tree(jstate.params)
    model, state, tx = create_pretrain_state(Config(**kw).finalize(),
                                             device="cpu")
    load_jax_variables(model, params0, _np_tree(jstate.batch_stats))
    _, jtrain = jax_split_step(jmodel, jtx, jcfg)
    pstep = make_preaugmented_step(model, tx, Config(**kw).finalize())
    rng = np.random.default_rng(0)
    jm_all, pm_all = [], []
    for _ in range(2):
        batch = {k: rng.integers(0, 5, (B,)).astype(np.int32)
                 for k in ("spa", "tem", "pb")}
        batch.update(rot1=rng.integers(0, 4, (B,)).astype(np.int32),
                     rot2=rng.integers(0, 4, (B,)).astype(np.int32),
                     view1=_clips(rng), view2=_clips(rng))
        jstate, jm = jtrain(jstate, tuple(jnp.asarray(batch[k]) for k in KEYS),
                            jnp.float32(LR))
        state, pm = pstep(state, {k: torch.from_numpy(batch[k])
                                  for k in KEYS}, LR)
        jm_all.append({k: float(v) for k, v in jm.items()})
        pm_all.append({k: float(v) for k, v in pm.items()})
    return dict(jm=jm_all, pm=pm_all, jstate=jstate, state=state,
                params0=params0)


def test_pretrain_accum_losses_and_metrics_match(pretrain_two_steps):
    for jm, pm in zip(pretrain_two_steps["jm"], pretrain_two_steps["pm"]):
        assert pm.keys() == jm.keys()
        for k, v in jm.items():
            np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_pretrain_accum_batch_stats_match(pretrain_two_steps):
    _, stats = export_jax_variables(pretrain_two_steps["state"].model)
    _assert_close(stats, _np_tree(pretrain_two_steps["jstate"].batch_stats),
                  "batch_stats")


def test_pretrain_accum_updates_match(pretrain_two_steps):
    params, _ = export_jax_variables(pretrain_two_steps["state"].model)
    p0 = pretrain_two_steps["params0"]
    _assert_close_in_norm(
        _delta(params, p0),
        _delta(_np_tree(pretrain_two_steps["jstate"].params), p0),
        "params - params0")
    assert pretrain_two_steps["state"].step == 2


def test_microbatches_are_contiguous_slices():
    x = torch.arange(12).reshape(6, 2)
    y = torch.arange(6)
    mbs = microbatches((x, y), 3)
    assert len(mbs) == 3
    for i, (xi, yi) in enumerate(mbs):
        assert torch.equal(xi, x[2 * i:2 * i + 2])
        assert torch.equal(yi, y[2 * i:2 * i + 2])
    with pytest.raises(ValueError, match="not divisible"):
        microbatches((x,), 4)


def test_finetune_accum_step_matches_jax():
    n_classes = 6
    kw = _kw(task="ft_all", n_finetune_classes=n_classes)
    jcfg = JaxConfig(**kw).finalize()
    jmodel, jstate, jtx = jax_create_finetune_state(
        jcfg, jax.random.PRNGKey(0), n_classes)
    params0 = _np_tree(jstate.params)
    cfg = Config(**kw).finalize()
    model, state, tx = create_finetune_state(cfg, n_classes, device="cpu")
    load_jax_variables(model, params0, _np_tree(jstate.batch_stats))
    rng = np.random.default_rng(1)
    frames = np.round((_clips(rng, s=48)[:, :, :40] + 1.0) * 127.5
                      ).astype(np.uint8)
    labels = rng.integers(0, n_classes, (B,)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    clips = np.array(jax_aug(key, frames, sample_size=S))
    jstate, jm = jax_make_finetune_step(jmodel, jtx, jcfg)(
        jstate, key, {"frames": jnp.asarray(frames),
                      "labels": jnp.asarray(labels)}, jnp.float32(LR))
    state, pm = make_preaugmented_finetune_step(model, tx, cfg)(
        state, {"clips": torch.from_numpy(clips),
                "labels": torch.from_numpy(labels)}, LR)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    params, stats = export_jax_variables(model)
    _assert_close(stats, _np_tree(jstate.batch_stats), "batch_stats")
    _assert_close_in_norm(_delta(params, params0),
                          _delta(_np_tree(jstate.params), params0),
                          "params - params0")


def test_config_takes_grad_accum_that_divides_the_batch():
    assert Config(grad_accum=2, batch_size=4).finalize().grad_accum == 2
    with pytest.raises(ValueError, match="not divisible"):
        Config(grad_accum=3, batch_size=4).finalize()
