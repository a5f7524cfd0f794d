"""The legacy pace-era models of the port (``cstp_tpu_torch/models/legacy.py``,
``make_legacy_model``) and ``--legacy_pace`` (the 'pace_project' finetune
head of bare ``r21d``) against the JAX package's, on the CPU in float32,
from the same weights and numpy-seeded inputs.

Sizes: 4 clips of 8 x 32^2 (C3D pools time three times; S3D-G's
space-to-depth stem halves T, H and W), R(2+1)D and R3D at layer sizes
(1, 1, 1, 1). The JAX side takes the port's initial weights (exported
through ``models/bridge.py``); ``test_parameter_trees_match_jax`` holds the
two trees to the same paths and shapes.

Tolerances (those of ``tests/test_torch_port_inception.py``):
- the models' outputs, in eval mode (the running statistics those of one
  train-mode batch, ``_calibrated``; the outputs checked to differ between
  clips) and in train mode (with the running statistics): ten times the
  port's own float32 spread at the same input (``_spread``: the largest
  change a 1e-7 relative change of the input makes), never more than 1e-2
  of the output's size, plus 1e-5 of its size. In eval mode the spread is
  small but not nothing: calibrated S3D-G's logits reach about 900, and
  their float32 spread is about 3e-5 of that, as is their distance from a
  float64 run of the port;
- the ``--legacy_pace`` finetune step: loss and running statistics rtol
  1e-4, the updates leaf by leaf in norm, ``|got - want| <= 5e-2 |want| +
  1e-4 |all of want|``, eval logits rtol 1e-4, atol 1e-5; the gradients of
  ``LegacyR21DBYOL``'s loss by the same norm rule.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.models import make_legacy_model as jax_make_legacy_model
from cstp_tpu.models import torch_import as jti
from cstp_tpu.models.s3dg import space_to_depth_stem as jax_space_to_depth
from cstp_tpu.ssl.byol import CSTPClassify as JaxClassify
from cstp_tpu.train import finetune as jft
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models import make_legacy_model
from cstp_tpu_torch.models import torch_import as pti
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    export_named,
    export_state_dict,
    load_jax_variables,
)
from cstp_tpu_torch.models.s3dg import space_to_depth_stem
from cstp_tpu_torch.ssl.byol import CSTPClassify
from cstp_tpu_torch.train import finetune as pft

B, T, S, H0, W0 = 4, 8, 32, 40, 48
N_CLASSES = 7
LR = 3e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_close(got, want, rtol, what, atol=1e-5):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
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


def clips_of_videos(rng, n, t=T, s=S):
    """Clips in [-1, 1] whose videos differ in colour offset and contrast,
    as augmented crops of different videos do."""
    noise = rng.uniform(-1, 1, (n, t, s, s, 3))
    off = rng.uniform(-0.8, 0.8, (n, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (n, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def _spread(run, x):
    """Per output of ``run``, the largest change a 1e-7 relative change of
    the input makes: the float32 noise floor at this input."""
    a, b = run(x), run(x * np.float32(1 + 1e-7))
    return [float(np.abs(u - v).max()) for u, v in zip(a, b)]


def _assert_within_spread(got, want, spread, what):
    for i, (g, w, s) in enumerate(zip(got, want, spread)):
        err = float(np.abs(g - w).max())
        size = 1 + float(np.abs(w).max())
        assert err <= min(10 * s, 1e-2 * size) + 1e-5 * size, (
            f"{what} output {i}: max |got - want| {err:.3e}, float32 "
            f"spread {s:.3e}, size {size:.3e}")


def _outputs(out):
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o.detach().numpy() if hasattr(o, "detach") else o)
            for o in out]


@contextlib.contextmanager
def _jax_init_returns(cls, params, batch_stats):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "init", lambda self, *a, **k: {
            "params": params, "batch_stats": batch_stats})
        yield


# ------------------------------------------------------------ models

# case -> (reference file name, kwargs, two-clip forward, method)
MODELS = {
    "r21d-project": ("r21d", {}, False, None),
    "r21d-linear": ("r21d", dict(linear_flag="linear"), False, None),
    "r21d_byol": ("r21d_byol", {}, True, None),
    "r21d_byol-classify": ("r21d_byol", {}, False, "classify_forward"),
    "c3d": ("c3d", {}, True, None),
    "c3d-cls": ("c3d", {}, False, "cls"),
    "r3d": ("r3d", {}, False, None),
    "s3d_g-s2d": ("s3d_g", {}, False, None),
    "s3d_g-plain": ("s3d_g", dict(space_to_depth=False), False, None),
}


def _calibrated(model, fn, args):
    """Set every BatchNorm's running statistics to its batch statistics of
    one train-mode call ``fn(*args, True)`` (the last call where a module
    runs twice): eval mode then keeps the activations' scale through the whole
    random-weight network, which running statistics at their init do
    not (the outputs would all be the head's bias)."""
    from cstp_tpu_torch.models.layers import BatchNorm

    seen = {}

    def hook(m, inp):
        seen[m] = m.batch_stats(inp[0].float())

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            fn(*args, True)
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        for m, (gmean, gvar) in seen.items():
            m.mean.copy_(gmean.mean(0))
            m.var.copy_(gvar.mean(0))


@pytest.fixture(scope="module")
def model_pairs():
    """Per case: JAX's model, the port's (seed 1) and the port's variables,
    the running statistics those of a batch like the test's."""
    out = {}
    for i, (case, (name, kw, two, method)) in enumerate(MODELS.items()):
        model = make_legacy_model(name, dtype=torch.float32,
                                  gen=torch.Generator().manual_seed(1), **kw)
        rng = np.random.default_rng(i)
        x = torch.from_numpy(clips_of_videos(rng, B))
        _calibrated(model, getattr(model, method) if method else model,
                    (x, x.flip(0)) if two else (x,))
        params, stats = jax.tree_util.tree_map(
            np.copy, export_jax_variables(model))
        out[case] = (jax_make_legacy_model(name, dtype=jnp.float32, **kw),
                     model, {"params": params, "batch_stats": stats})
    return out


# the train-mode cases: the second entry points and S3D-G without space to
# depth run the same modules as a case here (r21d_byol's train-mode loss is
# held by test_r21d_byol_gradients_match_jax)
TRAIN_CASES = ("r21d-project", "c3d", "r3d", "s3d_g-s2d")


@pytest.mark.parametrize("case, train", [(c, False) for c in MODELS] + [
    (c, True) for c in TRAIN_CASES])
def test_legacy_model_matches_jax(model_pairs, case, train):
    """Each ``make_legacy_model`` model (and the second entry point of
    ``r21d_byol`` and ``c3d``) from the same weights: eval mode at 1e-5
    with outputs that differ between clips, train mode (with the running
    statistics) within ten times the float32 spread."""
    jmodel, model, variables = model_pairs[case]
    _, _, two, method = MODELS[case]
    rng = np.random.default_rng(20)
    x = (np.concatenate([clips_of_videos(rng, B), clips_of_videos(rng, B)])
         if two else clips_of_videos(rng, B))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    fn = getattr(model, method) if method else model
    jmethod = getattr(type(jmodel), method) if method else None

    def jargs(xx):
        return (xx[:B], xx[B:]) if two else (xx,)

    def run(xx):
        model.load_state_dict(sd)
        with torch.no_grad():
            out = _outputs(fn(*(torch.from_numpy(a) for a in jargs(xx)),
                              train))
        if train:
            out += list(_flat(export_jax_variables(model)[1]).values())
        return out

    got, spread = run(x), _spread(run, x)
    if not train:
        want = _outputs(jax.jit(lambda v, *a: jmodel.apply(
            v, *a, False, method=jmethod))(variables,
                                           *map(jnp.asarray, jargs(x))))
        assert [g.shape for g in got] == [w.shape for w in want]
        _assert_within_spread(got, want, spread, case)
        for g in got:
            if g.ndim == 2:      # the clips give different outputs
                assert np.abs(g - g[:1]).max() > 1e-2 * np.abs(g).max()
        return
    want, mutated = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, True, method=jmethod, mutable=["batch_stats"]))(
        variables, *map(jnp.asarray, jargs(x)))
    wstats = _flat(_np_tree(mutated["batch_stats"]))
    assert list(wstats) == list(_flat(export_jax_variables(model)[1]))
    _assert_within_spread(got, _outputs(want) + list(wstats.values()),
                          spread, case)
    model.load_state_dict(sd)


def test_output_shapes():
    """512 projector outputs, 4 speed classes, the pair of 512-d C3D
    features and S3D-G's 512 logits, with and without space to depth."""
    x = torch.zeros(2, T, S, S, 3)
    kw = dict(dtype=torch.float32)
    shapes = {
        "r21d": make_legacy_model("r21d", **kw)(x, False).shape,
        "r21d-linear": make_legacy_model("r21d", linear_flag="linear",
                                         **kw)(x, False).shape,
        "r3d": make_legacy_model("r3d", **kw)(x, False).shape,
        "c3d": tuple(o.shape for o in make_legacy_model("c3d", **kw)(
            x, x, False)),
        "s3d_g": make_legacy_model("s3d_g", **kw)(x, False).shape,
        "s3d_g-plain": make_legacy_model("s3d_g", space_to_depth=False,
                                         **kw)(x, False).shape,
    }
    assert shapes == {"r21d": (2, 512), "r21d-linear": (2, 4),
                      "r3d": (2, 4), "c3d": ((2, 512), (2, 512)),
                      "s3d_g": (2, 512), "s3d_g-plain": (2, 512)}


def test_space_to_depth_matches_jax():
    """The permutation of the legacy S3D-G stem, exactly."""
    x = np.random.default_rng(2).normal(size=(2, 4, 6, 8, 3)).astype(
        np.float32)
    got = space_to_depth_stem(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_space_to_depth(jnp.asarray(x)))
    assert got.shape == (2, 2, 3, 4, 24)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["r21d-project", "r21d-linear", "r21d_byol",
                                  "c3d", "r3d", "s3d_g-s2d", "s3d_g-plain"])
def test_parameter_trees_match_jax(case):
    """The port's parameters and running statistics, exported through the
    bridge, have exactly the paths and shapes of JAX's ``init``
    (``eval_shape``): the classify heads of ``r21d_byol`` and ``c3d``
    included, the bare convolutions one level down."""
    name, kw, two, _ = MODELS[case]
    model = make_legacy_model(name, **kw)
    jmodel = jax_make_legacy_model(name, dtype=jnp.float32, **kw)
    x = jnp.zeros((2, T, S, S, 3), jnp.float32)
    args = (x, x) if two else (x,)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *args, True))
    params, stats = export_jax_variables(model)
    for got, want in ((params, shapes["params"]),
                      (stats, shapes["batch_stats"])):
        assert _shapes(got) == _shapes(want)


def test_unknown_legacy_name_raises_in_both():
    for make in (make_legacy_model, jax_make_legacy_model):
        with pytest.raises(ValueError, match="unknown legacy model 's3d'"):
            make("s3d")


def test_r21d_byol_gradients_match_jax(model_pairs):
    """``LegacyR21DBYOL``'s loss in train mode: its gradients reach the
    online tower and the ``prodictor`` as JAX's do (by the norm rule),
    and nothing reaches the target tower or ``classify``."""
    jmodel, model, variables = model_pairs["r21d_byol"]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    x1, x2 = clips_of_videos(rng, B), clips_of_videos(rng, B)

    def jloss(params):
        loss, _ = jmodel.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x1), jnp.asarray(x2), True,
                               mutable=["batch_stats"])
        return loss

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    model.zero_grad(set_to_none=True)
    loss = model(torch.from_numpy(x1), torch.from_numpy(x2), True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    assert not any(n.startswith(("target_net.", "classify."))
                   for n in grads)
    jg = _np_tree(jgrads)
    assert not any(np.any(v) for v in _flat(jg["target_net"]).values())
    assert not any(np.any(v) for v in _flat(jg["classify"]).values())
    got = export_named(model, grads)
    _assert_close_in_norm(got, {k: jg[k] for k in got}, "grads")
    model.load_state_dict(sd)


# ------------------------------------------------------------ --legacy_pace

def _kw(**over):
    kw = dict(model_name="r21d", model_depth=1, legacy_pace=1,
              sample_duration=T, sample_size=S, batch_size=B,
              compute_dtype="float32", learning_rate=LR,
              n_finetune_classes=N_CLASSES, mesh_shape=(1, 1),
              task="ft_all")
    kw.update(over)
    return kw


@pytest.mark.parametrize("name, legacy_pace, head", [
    ("r21d", 1, "pace_project"), ("r21d", 0, "linear"),
    ("r21d_byol", 1, "linear"), ("c3d", 1, "linear")])
def test_pace_head_needs_bare_r21d(name, legacy_pace, head):
    """``--legacy_pace`` selects the 'pace_project' head on the name
    ``r21d`` only, in both packages."""
    kw = _kw(model_name=name, legacy_pace=legacy_pace)
    model = pft.create_classify_model(Config(**kw).finalize(), N_CLASSES,
                                      device="cpu")
    assert model.head_style == head
    assert jft.create_classify_model(JaxConfig(**kw).finalize(),
                                     N_CLASSES).head_style == head
    assert hasattr(model, "pace_bn") == (head == "pace_project")


def test_pace_head_refuses_more_than_512_classes():
    kw = _kw()
    with pytest.raises(ValueError, match="512"):
        pft.create_classify_model(Config(**kw).finalize(), 513, device="cpu")
    with pytest.raises(AssertionError, match="512"):
        jft.create_classify_model(JaxConfig(**kw).finalize(), 513)
    assert pft.create_classify_model(Config(**kw).finalize(), 512,
                                     device="cpu").head_style == "pace_project"


@pytest.fixture(scope="module")
def pace_step():
    """One ``--legacy_pace`` ft_all step on each side from the same weights
    and clips, with ``--fused_conv 1`` as on the card (on the CPU the fused
    sites run their kernels' plain version), then the eval logits of the
    stepped states on the same test windows."""
    kw = _kw(fused_conv=1)
    jcfg = JaxConfig(**kw).finalize()
    cfg = Config(**kw).finalize()
    model, state, tx = pft.create_finetune_state(cfg, N_CLASSES,
                                                 device="cpu")
    params0, stats0 = jax.tree_util.tree_map(np.copy,
                                             export_jax_variables(model))
    with _jax_init_returns(JaxClassify, params0, stats0):
        jmodel, jstate, jtx = jft.create_finetune_state(
            jcfg, jax.random.PRNGKey(0), N_CLASSES)
    rng = np.random.default_rng(10)
    frames = np.round((clips_of_videos(rng, B, T, W0)[:, :, :H0] + 1.0)
                      * 127.5).astype(np.uint8)
    labels = rng.integers(0, N_CLASSES, (B,)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    from cstp_tpu.augment.pipeline import finetune_train_augment_batch

    clips = np.array(finetune_train_augment_batch(key, frames, sample_size=S))
    train_logits = copy.deepcopy(model)(torch.from_numpy(clips),
                                        True).detach().numpy()
    jstate, jm = jft.make_finetune_step(jmodel, jtx, jcfg)(
        jstate, key, {"frames": jnp.asarray(frames),
                      "labels": jnp.asarray(labels)}, jnp.float32(LR))
    state, pm = pft.make_preaugmented_finetune_step(model, tx, cfg)(
        state, {"clips": torch.from_numpy(clips),
                "labels": torch.from_numpy(labels)}, LR)
    windows = rng.integers(0, 256, (3, T, H0, W0, 3)).astype(np.uint8)
    jlogits = np.asarray(jft.make_logits_step(jmodel, jcfg)(
        jstate, jnp.asarray(windows)))
    plogits = pft.make_logits_step(model, cfg)(
        state, torch.from_numpy(windows)).numpy()
    return dict(jm={k: float(v) for k, v in jm.items()},
                pm={k: float(v) for k, v in pm.items()}, jstate=jstate,
                state=state, params0=params0, jlogits=jlogits,
                plogits=plogits, train_logits=train_logits)


def test_pace_step_matches_jax(pace_step):
    """The loss and accuracy over the 512 projector outputs, the running
    statistics and the updates of one step."""
    jm, pm = pace_step["jm"], pace_step["pm"]
    assert pm.keys() == jm.keys() == {"loss", "acc"}
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    params, stats = export_jax_variables(pace_step["state"].model)
    _assert_close(stats, _np_tree(pace_step["jstate"].batch_stats), 1e-4,
                  "batch_stats")
    p0 = pace_step["params0"]
    _assert_close_in_norm(
        jax.tree_util.tree_map(np.subtract, params, p0),
        jax.tree_util.tree_map(np.subtract,
                               _np_tree(pace_step["jstate"].params), p0),
        "params - params0")
    assert set(params) == {"online_net", "classify", "pace_bn"}


def test_pace_logits_are_the_512_relu_outputs(pace_step):
    """The logits are the projector's 512 ReLU outputs whatever the class
    count (the reference's live behaviour), and the eval logits match
    JAX's."""
    tl = pace_step["train_logits"]
    assert tl.shape == (B, 512) and tl.min() >= 0.0
    assert pace_step["plogits"].shape == (3, 512)
    np.testing.assert_allclose(pace_step["plogits"], pace_step["jlogits"],
                               rtol=1e-4, atol=1e-5)


def test_pace_pth_round_trip_matches_jax(tmp_path):
    """A ``--legacy_pace`` finetune model exported as a reference ``.pth``
    names JAX's tensors (``classify.{0,1,3}``, ``pace_bn``); loaded back,
    as in JAX, ``pace_bn`` and the backbone load while the
    ``classify.N`` names map to no module, so the model keeps its own
    ``classify``."""
    model = CSTPClassify("r21d", 1, N_CLASSES, head_style="pace_project",
                         gen=torch.Generator().manual_seed(4))
    tree = export_state_dict(model.state_dict())
    got = pti.export_torch_state_dict(tree, "r21d", ddp_prefix=True)
    want = jti.export_torch_state_dict(tree, "r21d", ddp_prefix=True)
    assert got.keys() == want.keys()
    assert {"module.classify.0.weight", "module.classify.3.bias",
            "module.classify.1.running_var",
            "module.pace_bn.running_mean"} <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = str(tmp_path / "save_1.pth")
    pti.save_torch_checkpoint(path, tree, "r21d")
    jtree, _ = jti.load_torch_checkpoint(path, "r21d")
    ptree, _ = pti.load_torch_checkpoint(path, "r21d")
    assert _shapes(ptree) == _shapes(jtree)
    assert set(ptree["params"]["classify"]) == {"0", "1", "3"}
    other = CSTPClassify("r21d", 1, N_CLASSES, head_style="pace_project",
                         gen=torch.Generator().manual_seed(5))
    init = {n: t.clone() for n, t in other.state_dict().items()}
    pti.load_into(other, ptree)
    mine = model.state_dict()
    for n, t in other.state_dict().items():
        if n.startswith("classify."):
            assert torch.equal(t, init[n]), n
        else:
            assert torch.equal(t, mine[n]), n
