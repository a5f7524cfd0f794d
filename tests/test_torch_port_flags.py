"""The step flags of the port against the JAX package, on the CPU in
float32 at a small size (R(2+1)D depth 1, 4 frames of 32², per-view batch
4), from weights bridged with ``models/bridge.py``:

* ``--concat_views 0`` (one tower call per view): the forward's loss, six
  logits and sequentially updated running statistics, and one pretrain
  step;
* the optimizers of ``make_optimizer`` (SGD with dampening and/or
  nesterov, Adam, AdamW), each with and without weight decay and clip,
  over 3 updates on the same numpy parameters and gradients, with
  ``apply_lr``'s ``--double_bias_lr`` multipliers; the set of parameters
  those double, on the pretrain and classify models;
* one pretrain step with ``adamw --double_bias_lr`` and one finetune step
  with ``adam``;
* ``--remat`` and ``--remat_policy bnrelu``: port steps equal to the step
  without remat (loss, gradients, updated parameters, running statistics),
  and each equal to JAX's remat step;
* an ``adamw`` checkpoint round trip and ``--task resume``.

Tolerances. Optimizer updates are elementwise float32 arithmetic in the
same order as optax's, apart from the global norm's summation order and
(which moves the clip's scale by an ulp): states and parameters agree to
1e-6 relative, with an atol of 1e-6 of the leaf's largest magnitude for
the few elements that cancel to about 0. The
forward pass agrees to about 1e-6 relative, so losses and logits are held
to 1e-4 and running statistics to 1e-5. Steps are held as in
``tests/test_torch_port_pretrain.py``: metrics and running statistics to
rtol 1e-4, parameter updates and optimizer states leaf by leaf in norm
(``|got - want| <= 5e-2 |want| + 1e-4 |all of want|``), because the step's
float32 gradient is ill conditioned at this size (that file's docstring).
Under Adam a leaf whose exact gradient is 0 (a bias in front of a
BatchNorm) gets a step of ``g / (|g| + 1e-8)`` from rounding noise alone,
so Adam's moments are compared leaf by leaf in norm, and its parameter
updates on the elements whose first moment is above a tenth of its leaf's
RMS (``_assert_adam_updates_close``).
Remat against no remat on the port's CPU path recomputes the same
operations in the same order: equal within 1e-6, running statistics
bitwise.
"""

import copy
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.augment.pipeline import finetune_train_augment_batch as jax_aug
from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.train import optim as jax_optim
from cstp_tpu.train.finetune import (
    create_finetune_state as jax_ft_state,
    make_finetune_step as jax_ft_step,
)
from cstp_tpu.train.pretrain import (
    create_pretrain_state as jax_create_state,
    split_pretrain_step as jax_split_step,
)
from cstp_tpu_torch.ckpt import checkpoint as ck
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.data.loader import PretrainLoader
from cstp_tpu_torch.models import bridge
from cstp_tpu_torch.models import r21d as port_r21d
from cstp_tpu_torch.models.layers import BatchNorm
from cstp_tpu_torch.train import loops, optim
from cstp_tpu_torch.train.finetune import (
    create_finetune_state,
    make_preaugmented_finetune_step,
)
from cstp_tpu_torch.train.pretrain import (
    _loss_and_metrics,
    create_pretrain_state,
    make_preaugmented_step,
    make_pretrain_step,
)

from _torch_threads import torch_threads  # noqa: F401

B, T, S = 4, 4, 32
LR = 3e-4   # the Config default
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")
N_CLASSES = 5


@pytest.fixture
def tmp_path(tmp_path):
    """The test's own directory, removed when the test ends, passed or
    failed: its checkpoints, .pth files and CLI outputs are read back
    inside the test, and left behind they would fill the disk over a
    whole run of the suite."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _kw(**over):
    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              learning_rate=LR)
    kw.update(over)
    return kw


def _view(rng, n=B):
    """Normalised views in [-1, 1] whose clips differ in colour offset and
    contrast, as augmented crops of different videos do."""
    noise = rng.uniform(-1, 1, (n, T, S, S, 3))
    off = rng.uniform(-0.8, 0.8, (n, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (n, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, 5, (B,)).astype(np.int32)
             for k in ("spa", "tem", "pb")}
    batch.update(rot1=rng.integers(0, 4, (B,)).astype(np.int32),
                 rot2=rng.integers(0, 4, (B,)).astype(np.int32),
                 view1=_view(rng), view2=_view(rng))
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pretrain_states(kw):
    """JAX's initial pretrain state and the port's, bridged from it."""
    jcfg = JaxConfig(**kw).finalize()
    jmodel, jstate, jtx = jax_create_state(jcfg, jax.random.PRNGKey(0))
    cfg = Config(**kw).finalize()
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    bridge.load_jax_variables(model, _np_tree(jstate.params),
                              _np_tree(jstate.batch_stats))
    return (jmodel, jstate, jtx, jcfg), (model, state, tx, cfg)


def _assert_trees_close(got, want, what, rtol=1e-4, atol=1e-5):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def _assert_trees_close_in_norm(got, want, what, keys=None):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    floor = 1e-4 * np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                               for v in w.values()))
    for k in (w if keys is None else keys):
        err = np.linalg.norm(g[k] - w[k])
        assert err <= 5e-2 * np.linalg.norm(w[k]) + floor, (
            f"{what} {k}: |got - want| {err:.3e}, |want| "
            f"{np.linalg.norm(w[k]):.3e}")


def _jax_opt_fields(opt_state):
    """``trace`` / ``mu`` / ``nu`` / ``count`` of an optax state of the
    'train' partition (SGD's ``TraceState``, ``trace_with_dampening``'s
    dict, ``ScaleByAdamState``)."""
    found = {}

    def visit(x):
        if isinstance(x, dict) and "trace" in x:
            found.update(x)
        elif hasattr(x, "_fields"):
            for f in ("trace", "mu", "nu", "count"):
                if f in x._fields:
                    found[f] = getattr(x, f)
            if not any(f in x._fields for f in ("trace", "mu")):
                for y in x:
                    visit(y)
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
    return found


def _drop_target(tree):
    return {k: v for k, v in tree.items() if k != "target_net"}


# ------------------------------------------------------------ concat_views 0

def test_per_view_forward_matches_jax():
    (jmodel, jstate, _, _), (model, *_rest) = _pretrain_states(
        _kw(concat_views=0))
    batch = _batch(1)
    (jloss, jouts), mutated = jmodel.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(batch["view1"]), jnp.asarray(batch["view2"]),
        train=True, mutable=["batch_stats"])
    v1, v2 = (torch.from_numpy(batch[k]) for k in ("view1", "view2"))
    with torch.no_grad():
        loss, outs = model(v1, v2, train=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                               atol=1e-4)
    assert len(outs) == len(jouts) == 6
    for i, (a, b) in enumerate(zip(outs, jouts)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=f"logits {i}")
    _, stats = bridge.export_jax_variables(model)
    _assert_trees_close(stats, _np_tree(mutated["batch_stats"]),
                        "batch_stats", rtol=1e-5, atol=1e-5)
    # per-view calls advance the running statistics twice: not the one
    # averaged update of the concatenated call
    s0 = _flat(_np_tree(jstate.batch_stats))
    key = next(k for k in s0 if "online_net" in k and k.endswith("['mean']"))
    assert not np.allclose(_flat(stats)[key], s0[key])


def test_per_view_outputs_equal_the_concatenated_call():
    """The call pattern changes only the running statistics: the same
    weights give the same loss and logits (the JAX package's
    ``test_concat_views_matches_reference_call_pattern``)."""
    cfg = Config(**_kw()).finalize()
    cat, *_ = create_pretrain_state(cfg, device="cpu")
    per_view, *_ = create_pretrain_state(
        dataclasses.replace(cfg, concat_views=0), device="cpu")
    per_view.load_state_dict(cat.state_dict())
    batch = _batch(2)
    v1, v2 = (torch.from_numpy(batch[k]) for k in ("view1", "view2"))
    with torch.no_grad():
        la, oa = cat(v1, v2, train=True)
        lb, ob = per_view(v1, v2, train=True)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-5)
    for i, (a, b) in enumerate(zip(oa, ob)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"logits {i}")


# ------------------------------------------------------------ steps vs JAX

STEP_CASES = {
    "concat_views0": dict(concat_views=0, fused_conv=1),
    "adamw_double_bias_lr": dict(optimizer="adamw", double_bias_lr=True,
                                 fused_conv=1),
    "remat": dict(remat=True, fused_conv=1),
    "remat_bnrelu": dict(remat_policy="bnrelu", fused_conv=1),
}


@pytest.fixture(scope="module", params=list(STEP_CASES))
def one_step(request):
    kw = _kw(**STEP_CASES[request.param])
    (jmodel, jstate, jtx, jcfg), (model, state, tx, cfg) = _pretrain_states(
        kw)
    params0 = _np_tree(jstate.params)
    _, jtrain = jax_split_step(jmodel, jtx, jcfg)
    pstep = make_preaugmented_step(model, tx, cfg)
    batch = _batch(3)
    jstate, jm = jtrain(jstate, tuple(jnp.asarray(batch[k]) for k in KEYS),
                        jnp.float32(LR))
    state, pm = pstep(state, _torch_batch(batch), LR)
    return dict(case=request.param, jm={k: float(v) for k, v in jm.items()},
                pm={k: float(v) for k, v in pm.items()}, jstate=jstate,
                state=state, params0=params0)


def test_step_losses_match_jax(one_step):
    jm, pm = one_step["jm"], one_step["pm"]
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_step_batch_stats_match_jax(one_step):
    _, stats = bridge.export_jax_variables(one_step["state"].model)
    _assert_trees_close(stats, _np_tree(one_step["jstate"].batch_stats),
                        "batch_stats")


def _assert_adam_updates_close(got, want, mu):
    """Adam's step is about ``lr * sign(g)`` per element, whatever the
    gradient's size, so an element whose float32 gradient is within its
    rounding error of 0 may step either way. The updates are compared in
    norm, leaf by leaf, on the elements whose first moment is above a tenth
    of its leaf's RMS, in the leaves whose first moment is above 1e-6 of
    the largest leaf's (not a leaf of pure rounding noise, such as a bias
    in front of a BatchNorm); there the sign is settled."""
    g, w, m = _flat(got), _flat(want), _flat(mu)
    assert g.keys() == w.keys() == m.keys()
    top = max(np.linalg.norm(v) for v in m.values())
    for k in w:
        if np.linalg.norm(m[k]) <= 1e-6 * top:
            continue
        keep = np.abs(m[k]) > 0.1 * np.sqrt(np.mean(m[k] ** 2))
        err = np.linalg.norm((g[k] - w[k])[keep])
        assert err <= 5e-2 * np.linalg.norm(w[k][keep]) + 1e-12, (
            f"update {k}: |got - want| {err:.3e} on {keep.sum()} of "
            f"{keep.size} elements")


def test_step_updates_and_optimizer_state_match_jax(one_step):
    state = one_step["state"]
    params, _ = bridge.export_jax_variables(state.model)
    p0 = one_step["params0"]
    delta = _drop_target(jax.tree_util.tree_map(np.subtract, params, p0))
    want = _drop_target(jax.tree_util.tree_map(
        np.subtract, _np_tree(one_step["jstate"].params), p0))
    jfields = _jax_opt_fields(one_step["jstate"].opt_state)
    got_state = state.opt_state
    assert set(got_state) == set(jfields)
    for field in got_state:
        if field == "count":
            assert got_state["count"] == int(jfields["count"]) == 1
            continue
        got = bridge.export_named(state.model, got_state[field])
        _assert_trees_close_in_norm(got, _drop_target(_np_tree(
            jfields[field])), field)
    if "mu" in got_state:
        _assert_adam_updates_close(delta, want,
                                   _drop_target(_np_tree(jfields["mu"])))
    else:
        _assert_trees_close_in_norm(delta, want, "params - params0")


@pytest.mark.parametrize("kind", ["pretrain", "classify"])
def test_double_bias_lr_selects_jax_parameters(kind):
    if kind == "pretrain":
        (_, jstate, *_), (model, *_rest) = _pretrain_states(_kw())
    else:
        kw = _kw(task="ft_all", n_finetune_classes=N_CLASSES)
        _, jstate, _ = jax_ft_state(JaxConfig(**kw).finalize(),
                                    jax.random.PRNGKey(0), N_CLASSES)
        model, *_rest = create_finetune_state(Config(**kw).finalize(),
                                              N_CLASSES, device="cpu")
    owners = {n for n, m in model.named_modules()
              if isinstance(m, BatchNorm)}
    jmult = jax_optim.bias_double_lr_multipliers(_np_tree(jstate.params))
    want = {bridge.port_name(tuple(getattr(k, "key", k) for k in path),
                             owners): m
            for path, m in jax.tree_util.tree_flatten_with_path(jmult)[0]}
    got = optim.bias_double_lr_multipliers(dict(model.named_parameters()))
    assert got == want
    assert {n for n, m in got.items() if m == 2.0} == {
        n for n, _ in model.named_parameters() if n.endswith(".bias")}
    assert any(".bn." in n or ".bn1." in n for n, m in got.items()
               if m == 2.0)


def test_finetune_step_with_adam_matches_jax():
    kw = _kw(task="ft_all", n_finetune_classes=N_CLASSES, fused_conv=1,
             optimizer="adam", mesh_shape=(1, 1))
    jmodel, jstate, jtx = jax_ft_state(JaxConfig(**kw).finalize(),
                                       jax.random.PRNGKey(0), N_CLASSES)
    cfg = Config(**kw).finalize()
    model, state, tx = create_finetune_state(cfg, N_CLASSES, device="cpu")
    bridge.load_jax_variables(model, _np_tree(jstate.params),
                              _np_tree(jstate.batch_stats))
    p0 = _np_tree(jstate.params)
    rng = np.random.default_rng(4)
    frames = np.round((_view(rng)[:, :, :S, :S] + 1.0) * 127.5).astype(
        np.uint8)
    labels = rng.integers(0, N_CLASSES, (B,)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    clips = np.array(jax_aug(key, frames, sample_size=S))
    jstep = jax_ft_step(jmodel, jtx, JaxConfig(**kw).finalize())
    jstate, jm = jstep(jstate, key, {"frames": jnp.asarray(frames),
                                     "labels": jnp.asarray(labels)},
                       jnp.float32(LR))
    pstep = make_preaugmented_finetune_step(model, tx, cfg)
    state, pm = pstep(state, {"clips": torch.from_numpy(clips),
                              "labels": torch.from_numpy(labels)}, LR)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=1e-5)
    _, stats = bridge.export_jax_variables(model)
    _assert_trees_close(stats, _np_tree(jstate.batch_stats), "batch_stats")
    jfields = _jax_opt_fields(jstate.opt_state)
    assert set(state.opt_state) == {"mu", "nu", "count"}
    assert state.opt_state["count"] == int(jfields["count"]) == 1
    for field in ("mu", "nu"):
        _assert_trees_close_in_norm(
            bridge.export_named(model, state.opt_state[field]),
            _np_tree(jfields[field]), field)
    params, _ = bridge.export_jax_variables(model)
    delta = jax.tree_util.tree_map(np.subtract, params, p0)
    want = jax.tree_util.tree_map(np.subtract, _np_tree(jstate.params), p0)
    _assert_adam_updates_close(delta, want, _np_tree(jfields["mu"]))


# ------------------------------------------------------------ optimizers

OPT_CASES = {
    "sgd_dampening": dict(name="sgd", dampening=0.1),
    "sgd_nesterov": dict(name="sgd", nesterov=True),
    "sgd_dampening_nesterov": dict(name="sgd", dampening=0.3, nesterov=True),
    "adam": dict(name="adam"),
    "adamw": dict(name="adamw"),
}
# (name, shape): a BatchNorm-like and a dense-like pair, so that
# --double_bias_lr doubles two of the four leaves
OPT_LEAVES = (("bn.scale", (16,)), ("bn.bias", (16,)),
              ("fc.kernel", (24, 20)), ("fc.bias", (20,)))


def _ulps(leaf):
    """atol for an element that cancels to about 0: 1e-6 of its leaf's
    largest magnitude (a few float32 ulps of the operands)."""
    return 1e-6 * float(np.abs(leaf).max())


def _nest(flat):
    out = {}
    for n, v in flat.items():
        a, b = n.split(".")
        out.setdefault(a, {})[b] = v
    return out


@pytest.mark.parametrize("decay_clip", [True, False],
                         ids=["decay_clip", "plain"])
@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_jax_over_three_updates(case, decay_clip):
    kw = dict(OPT_CASES[case])
    name = kw.pop("name")
    kw.update(momentum=0.9, weight_decay=1e-2 if decay_clip else 0.0,
              clip_grad_norm=18.0 if decay_clip else None)
    rng = np.random.default_rng(5)
    p_np = {n: rng.normal(0, 1, s).astype(np.float32)
            for n, s in OPT_LEAVES}
    jtx = jax_optim.make_optimizer(name, **kw)
    tx = optim.make_optimizer(name, **kw)
    jparams = _nest(p_np)
    jstate = jtx.init(jparams)
    params = {n: torch.from_numpy(v.copy()) for n, v in p_np.items()}
    state = tx.init(params)
    lr = 0.05
    for step in range(3):
        # scaled so that the global norm (about 2.4 x 23) crosses the clip
        # at 18 on some steps and not on others
        g_np = {n: (rng.normal(0, 1, s) * (1.5 + step)).astype(np.float32)
                for n, s in OPT_LEAVES}
        updates, jstate = jtx.update(_nest(g_np), jstate, jparams)
        jparams = jax_optim.apply_lr(
            jparams, updates, lr,
            jax_optim.bias_double_lr_multipliers(jparams))
        u, state = tx.update({n: torch.from_numpy(v) for n, v in
                              g_np.items()}, state, params)
        optim.apply_lr(params, u, lr, optim.bias_double_lr_multipliers(params))
        jflat = {f"{a}.{b}": np.asarray(v) for a, d in jparams.items()
                 for b, v in d.items()}
        for n in p_np:
            np.testing.assert_allclose(params[n].numpy(), jflat[n],
                                       rtol=1e-6, atol=_ulps(jflat[n]),
                                       err_msg=f"step {step} {n}")
        jfields = _jax_opt_fields(jstate)
        assert set(state) == set(jfields), (set(state), set(jfields))
        for field, tree in jfields.items():
            if field == "count":
                assert state["count"] == int(tree) == step + 1
                continue
            for a, d in tree.items():
                for b, v in d.items():
                    np.testing.assert_allclose(
                        state[field][f"{a}.{b}"].numpy(), np.asarray(v),
                        rtol=1e-6, atol=_ulps(np.asarray(v)),
                        err_msg=f"step {step} {field} {a}.{b}")


def test_state_layouts():
    p = {"w": torch.ones(3)}
    assert set(optim.make_optimizer("sgd").init(p)) == {"trace"}
    assert set(optim.make_optimizer("sgd", nesterov=True).init(p)) == {
        "trace"}
    assert optim.make_optimizer("sgd", dampening=0.1).init(p)["count"] == 0
    adam = optim.make_optimizer("adamw").init({"w": torch.ones(3).double()})
    assert set(adam) == {"mu", "nu", "count"}
    assert adam["mu"]["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer("lamb")


# ------------------------------------------------------------ remat

REMAT_CASES = [(dict(remat=True), 0), (dict(remat=True), 1),
               (dict(remat_policy="bnrelu"), 0),
               (dict(remat_policy="bnrelu"), 1),
               (dict(remat=True, concat_views=0), 1)]


def _port_step(kw, state_dict, batch):
    """Gradients of the loss, then one step, from ``state_dict``: (loss,
    {name: grad}, parameters after the step, buffers after the step)."""
    cfg = Config(**kw).finalize()
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    model.load_state_dict(state_dict)
    probe = copy.deepcopy(model)
    params = optim.trainable(probe)
    total, _ = _loss_and_metrics(
        probe, tuple(batch[k] for k in KEYS), cfg.loss_weight)
    grads = dict(zip(params, torch.autograd.grad(
        total, list(params.values()), allow_unused=True)))
    state, m = make_preaugmented_step(model, tx, cfg)(state, batch, LR)
    return (float(m["loss"]), grads,
            {n: p.detach() for n, p in model.named_parameters()},
            dict(model.named_buffers()))


@pytest.fixture(scope="module")
def remat_base():
    cfg = Config(**_kw()).finalize()
    model, *_ = create_pretrain_state(cfg, device="cpu")
    return model.state_dict(), _torch_batch(_batch(6))


@pytest.mark.parametrize("flags, fused", REMAT_CASES,
                         ids=["remat-fused0", "remat-fused1",
                              "bnrelu-fused0", "bnrelu-fused1",
                              "remat-concat_views0"])
def test_remat_step_equals_the_step_without_it(remat_base, flags, fused):
    sd, batch = remat_base
    base_kw = _kw(fused_conv=fused,
                  concat_views=flags.get("concat_views", 1))
    want = _port_step(base_kw, sd, batch)
    got = _port_step(_kw(fused_conv=fused, **flags), sd, batch)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for i, what in ((1, "grad"), (2, "param")):
        assert got[i].keys() == want[i].keys()
        for n in want[i]:
            if want[i][n] is None:
                assert got[i][n] is None, n
                continue
            torch.testing.assert_close(got[i][n], want[i][n], rtol=1e-6,
                                       atol=1e-9, msg=f"{what} {n}")
    # the recompute must not advance the running statistics a second time
    moved = False
    for n, b in want[3].items():
        assert torch.equal(got[3][n], b), n
        moved |= not torch.equal(b, sd[n])
    assert moved


@pytest.mark.parametrize("flags, calls", [
    (dict(remat=True), 4), (dict(remat_policy="bnrelu"), 4),
    (dict(remat=True, concat_views=0), 8), (dict(), 0)])
def test_remat_wraps_the_online_stages_only(remat_base, monkeypatch, flags,
                                            calls):
    """conv2..conv5 of the online tower run checkpointed, once per tower
    call; the target tower runs under no_grad and is not wrapped."""
    n = []
    wrapped = port_r21d.checkpointed

    def counting(*a, **k):
        n.append(a[3])
        return wrapped(*a, **k)

    monkeypatch.setattr(port_r21d, "checkpointed", counting)
    sd, batch = remat_base
    _port_step(_kw(**flags), sd, batch)
    # _port_step runs the loss twice: for the gradients, then in the step
    assert len(n) == 2 * calls
    assert set(n) <= {"full", "bnrelu"}


def test_remat_keeps_fewer_tensors_for_backward(remat_base):
    """With remat the online tower keeps fewer bytes for the backward
    outside its checkpointed stages (counted by a saved-tensors hook)."""
    sd, batch = remat_base

    def saved_bytes(**flags):
        cfg = Config(**_kw(**flags)).finalize()
        model, *_ = create_pretrain_state(cfg, device="cpu")
        model.load_state_dict(sd)
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model.online_net(batch["view1"], True)
        return total[0]

    plain = saved_bytes()
    assert saved_bytes(remat=True) < plain / 2
    assert saved_bytes(remat_policy="bnrelu") < plain / 2


# ------------------------------------------------------------ checkpoints

def _adamw_kw(tmp_path, **over):
    kw = _kw(task="loss_com", optimizer="adamw", double_bias_lr=True,
             data_backend="synthetic", synthetic_len=8, n_workers=2,
             result_path=str(tmp_path), log_every=0, learning_rate=0.03,
             steps_per_epoch=1, manual_seed=3, n_classes=N_CLASSES)
    kw.update(over)
    return kw


def test_adamw_checkpoint_round_trips(tmp_path):
    cfg = Config(**_kw(optimizer="adamw")).finalize()
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    state, _ = make_preaugmented_step(model, tx, cfg)(
        state, _torch_batch(_batch(8)), LR)
    path = ck.save_checkpoint(str(tmp_path / "save_1"), ck.state_tree(state),
                              meta={"arch": cfg.arch, "epoch": 2})
    tree, meta = ck.restore_checkpoint(path)
    assert meta["epoch"] == 2
    assert tree["step"] == 1
    got, want = tree["opt_state"], state.opt_state
    assert set(got) == {"mu", "nu", "count"}
    assert type(got["count"]) is int and got["count"] == want["count"] == 1
    for field in ("mu", "nu"):
        assert got[field].keys() == want[field].keys()
        for n, v in want[field].items():
            assert torch.equal(got[field][n], v), (field, n)


def test_adamw_resume_continues_as_the_state_in_memory(tmp_path):
    """``--task resume`` from ``save_1`` (which redoes epoch 1, the JAX
    package's and the reference's naming) gives bitwise what the state the
    first run held in memory gives when the same two epochs run on it by
    hand: the restored AdamW moments, step count and parameters are the
    saved ones."""
    first = loops.run_pretrain(Config(**_adamw_kw(
        tmp_path, n_epochs=1, ckpt_every_epochs=1)).finalize(), device="cpu")
    kept = copy.deepcopy(first["state"])
    save_1 = tmp_path / "UCF101" / "loss_com" / "save_1"
    assert save_1.is_dir()
    resumed = loops.run_pretrain(Config(**_adamw_kw(
        tmp_path, task="resume", resume_md_path=str(save_1),
        n_epochs=2)).finalize(), device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [1, 2]

    cfg = Config(**_adamw_kw(tmp_path, n_epochs=2)).finalize()
    tx = optim.make_optimizer("adamw", weight_decay=cfg.weight_decay,
                              clip_grad_norm=cfg.clip_grad_value)
    step = make_pretrain_step(kept.model, tx, cfg)
    loader = PretrainLoader(loops.build_dataset(cfg, "train"), B, T,
                                  seed=3, num_workers=2)
    gen = torch.Generator().manual_seed(3 + 17)
    lr_fn = optim.cosine_warmup_restarts(0.03, 2, 1.0)
    state = kept
    for epoch in (1, 2):
        for _, batch in zip(range(1), loader.epoch(epoch)):
            state, _ = step(state, gen, {k: torch.from_numpy(v)
                                         for k, v in batch.items()},
                            lr_fn(epoch - 1))
    got = resumed["state"]
    assert got.step == state.step == 3
    assert got.opt_state["count"] == state.opt_state["count"] == 3
    for n, p in state.model.named_parameters():
        assert torch.equal(dict(got.model.named_parameters())[n], p), n
    for field in ("mu", "nu"):
        for n, v in state.opt_state[field].items():
            assert torch.equal(got.opt_state[field][n], v), (field, n)
