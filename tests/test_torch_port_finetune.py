"""The port's finetune model and step (cstp_tpu_torch) against the JAX
package's, on the CPU in float32, from the same bridged weights.

``CSTPClassify`` is compared head by head ('linear' with and without
``cls_bn``, 'mlp'), in train and eval mode, with ``fused_conv`` 0 and 1 (on
the CPU JAX's modules take the unfused XLA chain, the port's eligible sites
``fused_st_conv``'s plain version). Logits are held to rtol 1e-4 and atol
1e-5: a float32 forward in another convolution and reduction order agrees
to about 1e-6 relative.

The finetune step runs two steps on each side under ``ft_all``, ``ft_fc``
and ``ft_begin_index=3``. The port's pre-augmented step takes the clips that
JAX's ``finetune_train_augment_batch`` gives for the step's key. Tolerances
are those of ``tests/test_torch_port_pretrain.py``: losses and accuracies
rtol 1e-4 (atol 1e-5), BN running statistics rtol 1e-4 (atol 1e-5), and
the parameter updates leaf by leaf in norm, ``|got - want| <= 5e-2 |want|
+ 1e-4 |all of want|``, because the float32 gradient of BatchNorm over
pooled features is ill conditioned at test sizes. Frozen leaves must be
bitwise unchanged on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.augment.pipeline import finetune_train_augment_batch as jax_aug
from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.train.finetune import (
    create_finetune_state as jax_create_state,
    finetune_frozen_prefixes as jax_frozen_prefixes,
    make_finetune_step as jax_make_step,
)
from cstp_tpu.train.optim import param_labels as jax_param_labels
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    export_named,
    load_jax_variables,
)
from cstp_tpu_torch.train import optim
from cstp_tpu_torch.train.finetune import (
    create_finetune_state,
    finetune_frozen_prefixes,
    make_preaugmented_finetune_step,
)

from _torch_threads import torch_threads  # noqa: F401

B, T, S, H0, W0 = 8, 4, 32, 40, 48
N_CLASSES = 7
LR = 3e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _kw(**over):
    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              fused_conv=1, task="ft_all", n_finetune_classes=N_CLASSES,
              learning_rate=LR, mesh_shape=(1, 1))
    kw.update(over)
    return kw


def _states(kw):
    """JAX's initial finetune state and the port's, bridged from it."""
    jmodel, jstate, jtx = jax_create_state(JaxConfig(**kw).finalize(),
                                           jax.random.PRNGKey(0), N_CLASSES)
    cfg = Config(**kw).finalize()
    model, state, tx = create_finetune_state(cfg, N_CLASSES, device="cpu")
    load_jax_variables(model, _np_tree(jstate.params),
                       _np_tree(jstate.batch_stats))
    return (jmodel, jstate, jtx), (model, state, tx), cfg


def clips_of_videos(rng, n, t, s):
    """Clips in [-1, 1] whose videos differ in colour offset and contrast."""
    noise = rng.uniform(-1, 1, (n, t, s, s, 3))
    off = rng.uniform(-0.8, 0.8, (n, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (n, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def frames_of_videos(rng, n, t, h0, w0):
    """uint8 frames whose videos differ in colour offset and contrast."""
    x = clips_of_videos(rng, n, t, max(h0, w0))[:, :, :h0, :w0]
    return np.round((x + 1.0) * 127.5).astype(np.uint8)


HEADS = [("r21d", True), ("r21d", False), ("r21d_classify", True)]


@pytest.fixture(scope="module")
def classify_models():
    return {(name, cls_bn, fused): _states(_kw(model_name=name, cls_bn=cls_bn,
                                               fused_conv=fused))
            for name, cls_bn in HEADS for fused in (0, 1)}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("fused", [0, 1])
@pytest.mark.parametrize("head", HEADS, ids=["linear", "linear-no-cls_bn",
                                             "mlp"])
def test_classify_forward_matches_jax(classify_models, head, fused, train):
    (jmodel, jstate, _), (model, state, _), _ = classify_models[
        (*head, fused)]
    x = clips_of_videos(np.random.default_rng(1), B, T, S)
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    load_jax_variables(model, _np_tree(jstate.params),
                       _np_tree(jstate.batch_stats))
    if train:
        want, mutated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    else:
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
    got = model(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32 and got.shape == (B, N_CLASSES)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    if train:
        _, stats = export_jax_variables(model)
        g, w = _flat(stats), _flat(_np_tree(mutated["batch_stats"]))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)


TASKS = {"ft_all": dict(task="ft_all"), "ft_fc": dict(task="ft_fc"),
         "ft_begin_index=3": dict(task="scratch", ft_begin_index=3)}


@pytest.mark.parametrize("over", [dict(task="ft_all"), dict(task="ft_fc")]
                         + [dict(task="scratch", ft_begin_index=i)
                            for i in range(6)])
def test_frozen_prefixes_select_the_same_parameters(classify_models, over):
    """The port's prefixes are JAX's in the port's names, and they freeze
    the same leaves of the same model."""
    cfg = Config(**_kw(**over)).finalize()
    jcfg = JaxConfig(**_kw(**over)).finalize()
    got = finetune_frozen_prefixes(cfg)
    want = jax_frozen_prefixes(jcfg)
    assert got == tuple(p.replace("/", ".") for p in want)
    (_, jstate, _), (model, _, _), _ = classify_models[("r21d", True, 1)]
    jlabels = _flat(jax_param_labels(jstate.params, want))
    optim.freeze(model, got)
    try:
        # the port's partition (requires_grad) at the JAX leaf paths
        pflat = _flat(export_named(model, {
            n: torch.tensor(float(not p.requires_grad))
            for n, p in model.named_parameters()}))
    finally:
        optim.freeze(model, ())
    assert pflat.keys() == jlabels.keys()
    assert {k for k, v in pflat.items() if v} == {
        k for k, v in jlabels.items() if v == "frozen"}


@pytest.fixture(scope="module", params=list(TASKS))
def two_steps(request):
    kw = _kw(**TASKS[request.param])
    (jmodel, jstate, jtx), (model, state, tx), cfg = _states(kw)
    params0 = _np_tree(jstate.params)
    stats0 = _np_tree(jstate.batch_stats)
    jstep = jax_make_step(jmodel, jtx, JaxConfig(**kw).finalize())
    pstep = make_preaugmented_finetune_step(model, tx, cfg)
    rng = np.random.default_rng(2)
    jmetrics, pmetrics = [], []
    for i in range(2):
        frames = frames_of_videos(rng, B, T, H0, W0)
        labels = rng.integers(0, N_CLASSES, (B,)).astype(np.int32)
        key = jax.random.PRNGKey(10 + i)
        clips = np.array(jax_aug(key, frames, sample_size=S))
        jstate, jm = jstep(jstate, key, {"frames": jnp.asarray(frames),
                                         "labels": jnp.asarray(labels)},
                           jnp.float32(LR))
        state, pm = pstep(state, {"clips": torch.from_numpy(clips),
                                  "labels": torch.from_numpy(labels)}, LR)
        jmetrics.append({k: float(v) for k, v in jm.items()})
        pmetrics.append({k: float(v) for k, v in pm.items()})
    return dict(task=request.param, jmetrics=jmetrics, pmetrics=pmetrics,
                jstate=jstate, state=state, params0=params0, stats0=stats0,
                frozen=finetune_frozen_prefixes(cfg))


def test_finetune_losses_match(two_steps):
    for jm, pm in zip(two_steps["jmetrics"], two_steps["pmetrics"]):
        assert pm.keys() == jm.keys() == {"loss", "acc"}
        for k, v in jm.items():
            np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_finetune_batch_stats_match(two_steps):
    _, stats = export_jax_variables(two_steps["state"].model)
    g, w = _flat(stats), _flat(_np_tree(two_steps["jstate"].batch_stats))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_finetune_updates_match(two_steps):
    params, _ = export_jax_variables(two_steps["state"].model)
    p0 = two_steps["params0"]
    got = _flat(jax.tree_util.tree_map(np.subtract, params, p0))
    want = _flat(jax.tree_util.tree_map(
        np.subtract, _np_tree(two_steps["jstate"].params), p0))
    assert got.keys() == want.keys()
    floor = 1e-4 * np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                               for v in want.values()))
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 5e-2 * np.linalg.norm(want[k]) + floor, (
            f"{k}: |got - want| {err:.3e}, |want| "
            f"{np.linalg.norm(want[k]):.3e}")


def test_frozen_leaves_unchanged_and_the_rest_moved(two_steps):
    """Frozen leaves are bitwise their initial values on both sides, and
    every trainable leaf of the head moved; the backbone's BN running
    statistics move under every task (train mode)."""
    params, stats = export_jax_variables(two_steps["state"].model)
    jparams = _np_tree(two_steps["jstate"].params)
    p0 = two_steps["params0"]
    frozen = two_steps["frozen"]
    for side in (params, jparams):
        for k, v in _flat(side).items():
            path = k.replace("['", "").replace("']", ".").rstrip(".")
            if optim.is_frozen(path, frozen):
                assert np.array_equal(v, _flat(p0)[k]), k
    moved = {k: not np.array_equal(v, _flat(p0)[k])
             for k, v in _flat(params).items()}
    assert all(v for k, v in moved.items() if "classify" in k), moved
    assert two_steps["state"].step == 2
    stats0 = _flat(two_steps["stats0"])
    assert all(not np.array_equal(v, stats0[k])
               for k, v in _flat(stats).items()), "a BN statistic stood still"
