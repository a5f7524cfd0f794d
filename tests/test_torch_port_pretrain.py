"""The port's pretrain step (cstp_tpu_torch) against the JAX package's, on
the CPU in float32, from the same bridged weights, views and labels.

JAX runs the train program of ``split_pretrain_step`` with ``fused_conv=1``; on the CPU its
modules take the unfused XLA chain, while the port's eligible sites take
``fused_st_conv``'s plain version: the comparison covers that they compute
the same chain. The augment program is compared at the parameter seam:
JAX samples the boxes and augmentation parameters, both packages apply them.

Tolerances. Both sides compute in float32 with other convolution and
reduction orders. The forward pass is well conditioned: the first step's
losses agree to about 1e-6 relative, the second step's (after an update
that carries the gradient's rounding, below) to about 1e-5, so losses and
metrics are held to rtol 1e-4, the BN running statistics to rtol 1e-4. The gradient is
not: the pooled features reach every BatchNorm's backward as a cotangent
that is constant over space, whose contributions cancel to a small residual,
so float32 rounding moves single gradient leaves by up to about 1% (measured
on this input against a float64 evaluation of the same step). The momentum
trace and the parameter updates are therefore compared leaf by leaf in norm:
``|got - want| <= 5e-2 |want| + 1e-4 |all of want|``, the second term for
leaves whose exact gradient is zero (a bias in front of a BatchNorm). The
views differ per clip in offset and contrast, and each BN group holds at
least four samples: with two samples per group (or look-alike clips) the
BN backward is pure rounding noise and no float32 comparison is meaningful.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.augment.pipeline import (
    pretrain_augment_batch as jax_augment,
    sample_pretrain_aug_params as jax_sample,
)
from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.train.pretrain import (
    create_pretrain_state as jax_create_state,
    split_pretrain_step as jax_split_step,
)
from cstp_tpu_torch.augment.params import ClipAugParams
from cstp_tpu_torch.augment.pipeline import apply_pretrain_aug
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    export_named,
    load_jax_variables,
)
from cstp_tpu_torch.train.pretrain import (
    create_pretrain_state,
    make_preaugmented_step,
)

B, T, S = 4, 4, 32
LR = 3e-4   # the Config default
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _momentum_trace(opt_state):
    """The optax ``TraceState.trace`` tree of the 'train' partition."""
    found = []

    def visit(x):
        if hasattr(x, "trace"):
            found.append(x.trace)
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)
        elif isinstance(x, dict):
            for y in x.values():
                visit(y)
        elif hasattr(x, "inner_states"):
            visit(x.inner_states["train"])
        elif hasattr(x, "inner_state"):
            visit(x.inner_state)

    visit(opt_state)
    assert len(found) == 1
    return found[0]


def _view(rng):
    """Normalised views in [-1, 1] whose clips differ in colour offset and
    contrast, as augmented crops of different videos do."""
    noise = rng.uniform(-1, 1, (B, T, S, S, 3))
    off = rng.uniform(-0.8, 0.8, (B, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (B, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        batch = {k: rng.integers(0, 5, (B,)).astype(np.int32)
                 for k in ("spa", "tem", "pb")}
        batch.update(rot1=rng.integers(0, 4, (B,)).astype(np.int32),
                     rot2=rng.integers(0, 4, (B,)).astype(np.int32),
                     view1=_view(rng), view2=_view(rng))
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def two_steps():
    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              fused_conv=1, learning_rate=LR)
    jcfg = JaxConfig(**kw).finalize()
    jmodel, jstate, jtx = jax_create_state(jcfg, jax.random.PRNGKey(0))
    params0 = _np_tree(jstate.params)
    stats0 = _np_tree(jstate.batch_stats)
    model, state, tx = create_pretrain_state(Config(**kw).finalize(),
                                             device="cpu")
    load_jax_variables(model, params0, stats0)
    _, jtrain = jax_split_step(jmodel, jtx, jcfg)
    pstep = make_preaugmented_step(model, tx, Config(**kw).finalize())
    jmetrics, pmetrics = [], []
    for batch in _batches():
        jstate, jm = jtrain(jstate, tuple(jnp.asarray(batch[k]) for k in KEYS),
                            jnp.float32(LR))
        state, pm = pstep(state, {k: torch.from_numpy(batch[k])
                                  for k in KEYS}, LR)
        jmetrics.append({k: float(v) for k, v in jm.items()})
        pmetrics.append({k: float(v) for k, v in pm.items()})
    return dict(jmetrics=jmetrics, pmetrics=pmetrics, jstate=jstate,
                state=state, params0=params0)


def test_losses_and_metrics_match(two_steps):
    for jm, pm in zip(two_steps["jmetrics"], two_steps["pmetrics"]):
        assert pm.keys() == jm.keys()
        for k, v in jm.items():
            np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {k}")


def _assert_trees_close_in_norm(got, want, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    floor = 1e-4 * np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                               for v in w.values()))
    for k in w:
        err = np.linalg.norm(g[k] - w[k])
        assert err <= 5e-2 * np.linalg.norm(w[k]) + floor, (
            f"{what} {k}: |got - want| {err:.3e}, |want| "
            f"{np.linalg.norm(w[k]):.3e}")


def test_updated_batch_stats_match(two_steps):
    _, stats = export_jax_variables(two_steps["state"].model)
    _assert_trees_close(stats, _np_tree(two_steps["jstate"].batch_stats),
                        "batch_stats")


def test_parameter_updates_match(two_steps):
    params, _ = export_jax_variables(two_steps["state"].model)
    p0 = two_steps["params0"]
    delta = jax.tree_util.tree_map(np.subtract, params, p0)
    want = jax.tree_util.tree_map(np.subtract,
                                  _np_tree(two_steps["jstate"].params), p0)
    _assert_trees_close_in_norm(delta, want, "params - params0")


def test_online_parameters_moved(two_steps):
    params, _ = export_jax_variables(two_steps["state"].model)
    p0 = two_steps["params0"]
    moved = jax.tree_util.tree_map(lambda a, b: float(np.abs(a - b).max()),
                                   params["online_net"], p0["online_net"])
    assert max(jax.tree_util.tree_leaves(moved)) > 0.0
    assert two_steps["state"].step == 2


def test_momentum_trace_matches(two_steps):
    state = two_steps["state"]
    got = export_named(state.model, state.opt_state["trace"])
    want = _np_tree(_momentum_trace(two_steps["jstate"].opt_state))
    want = {k: v for k, v in want.items() if k != "target_net"}
    _assert_trees_close_in_norm(got, want, "trace")


def test_augment_program_matches_at_param_seam():
    """JAX's ops-path augment program and the port's, fed the boxes and
    parameters JAX sampled (same key structure as its program), agree to
    2e-2 on [-1, 1] views, the Pallas test's tolerance (f32 resampling in
    another summation order)."""
    rng = np.random.default_rng(1)
    h0, w0 = 48, 64
    f1 = rng.integers(0, 255, (B, T, h0, w0, 3)).astype(np.uint8)
    f2 = rng.integers(0, 255, (B, T, h0, w0, 3)).astype(np.uint8)
    r1 = rng.integers(0, 4, (B,)).astype(np.int32)
    r2 = rng.integers(0, 4, (B,)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    jv1, jv2, jspa = jax_augment(key, f1, f2, r1, r2, sample_size=S)
    box1, box2, spa, p1, p2 = _np_tree(
        jax_sample(key, B, T, float(w0), float(h0), r1, r2))
    np.testing.assert_array_equal(spa, np.asarray(jspa))

    def params(p):
        return ClipAugParams(*(torch.from_numpy(np.array(a)) for a in p))

    sampled = (torch.from_numpy(np.array(box1)),
               torch.from_numpy(np.array(box2)),
               torch.from_numpy(np.array(spa)), params(p1), params(p2))
    pv1, pv2 = apply_pretrain_aug(
        torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(r1),
        torch.from_numpy(r2), sampled, sample_size=S)
    np.testing.assert_allclose(pv1.numpy(), np.asarray(jv1), atol=2e-2, rtol=0)
    np.testing.assert_allclose(pv2.numpy(), np.asarray(jv2), atol=2e-2, rtol=0)
