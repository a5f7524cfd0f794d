"""The SlowFast family of the port (``cstp_tpu_torch/models/slowfast.py``,
``slowfast`` / ``slowfast_fb``, ``--tau`` / ``--alpha``) against the JAX
package's, on the CPU in float32, from the same weights and numpy-seeded
inputs.

Sizes: 8 fast frames of 32^2 (``alpha`` 4: 2 slow frames), per-view batch
4, depth 18 (basic blocks) and 50 (bottleneck blocks). The JAX side takes
the port's initial weights (exported through ``models/bridge.py``);
``test_parameter_trees_match_jax`` holds the two trees to the same paths
and shapes.

Tolerances (those of ``tests/test_torch_port_inception.py``):
- blocks and backbones in eval mode: rtol 1e-5, atol 1e-5;
- whole backbones in train mode and the pretrain forward: ten times the
  port's own float32 spread at the same input (``_spread``: the largest
  change a 1e-7 relative change of the input makes), never more than 1e-2
  of the output's size, plus 1e-5 of its size. At 32^2 the last stage is
  1x1 spatially and its BatchNorms see 4 values per channel, so the
  features are ill conditioned in train mode;
- the pretrain and finetune steps (depth 18): losses and running
  statistics rtol 1e-4, the updates leaf by leaf in norm, ``|got - want|
  <= 5e-2 |want| + 1e-4 |all of want|``; eval logits rtol 1e-4, atol 1e-5.
  The steps run at depth 18: at depth 50 the JAX package's own float32
  update on this host is up to 9% (median 0.5%) off a float64 run of the
  same step (the port in float64), leaf by leaf, while the port's float32
  update is within 0.1% of it, so the reference is not exact enough there
  for the 5e-2 rule. Depth 50's forward is held in both modes.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.models import backbone_spec as jax_spec
from cstp_tpu.models import make_backbone as jax_make_backbone
from cstp_tpu.models import torch_import as jti
from cstp_tpu.ssl.byol import CSTPClassify as JaxClassify
from cstp_tpu.ssl.byol import CSTPPretrain as JaxPretrain
from cstp_tpu.train import finetune as jft
from cstp_tpu.train.optim import param_labels as jax_param_labels
from cstp_tpu.train.pretrain import (
    create_pretrain_model as jax_create_pretrain_model,
    create_pretrain_state as jax_create_pretrain_state,
    split_pretrain_step as jax_split_pretrain_step,
)
from cstp_tpu_torch.cli import main_ft, main_test
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models import backbone_spec, make_backbone
from cstp_tpu_torch.models import torch_import as pti
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    export_named,
    export_state_dict,
    load_jax_variables,
)
from cstp_tpu_torch.models.slowfast import SLOWFAST_LAYERS, slowfast_feat_dim
from cstp_tpu_torch.ssl.byol import CSTPPretrain
from cstp_tpu_torch.train import finetune as pft
from cstp_tpu_torch.train import loops, optim
from cstp_tpu_torch.train.pretrain import (
    create_pretrain_state,
    make_preaugmented_step,
)

B, T, S, H0, W0 = 4, 8, 32, 40, 48
N_CLASSES = 7
LR = 3e-4
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")


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


def clips_of_videos(rng, n, t=T, s=S, c=3):
    """Clips in [-1, 1] whose videos differ in colour offset and contrast,
    as augmented crops of different videos do."""
    noise = rng.uniform(-1, 1, (n, t, s, s, c))
    off = rng.uniform(-0.8, 0.8, (n, 1, 1, 1, c))
    contrast = rng.uniform(0.1, 1.0, (n, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def _kw(name, depth=18, **over):
    kw = dict(model_name=name, model_depth=depth, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              learning_rate=LR, n_finetune_classes=N_CLASSES,
              mesh_shape=(1, 1))
    kw.update(over)
    return kw


@contextlib.contextmanager
def _jax_init_returns(cls, params, batch_stats):
    """``cls.init`` (a Flax module class) returns these variables: JAX's
    own state builders then run on the port's initial weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "init", lambda self, *a, **k: {
            "params": params, "batch_stats": batch_stats})
        yield


def _variables(model):
    """``(params, batch_stats)`` of ``model`` in JAX's layout, copied."""
    return jax.tree_util.tree_map(np.copy, export_jax_variables(model))


def _perturbed_stats(stats, seed):
    """Running statistics off their init, so eval mode uses them."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.2, v.shape).astype(
            np.float32), stats)


def _spread(run, x):
    """Per output of ``run`` (a list of arrays from one call on ``x``), the
    largest change a 1e-7 relative change of ``x`` makes."""
    a, b = run(x), run(x * np.float32(1 + 1e-7))
    return [float(np.abs(u - v).max()) for u, v in zip(a, b)]


def _assert_within_spread(got, want, spread, what):
    for i, (g, w, s) in enumerate(zip(got, want, spread)):
        err = float(np.abs(g - w).max())
        size = 1 + float(np.abs(w).max())
        assert err <= min(10 * s, 1e-2 * size) + 1e-5 * size, (
            f"{what} output {i}: max |got - want| {err:.3e}, float32 "
            f"spread {s:.3e}, size {size:.3e}")


# ------------------------------------------------------------ widths

@pytest.mark.parametrize("depth, dim", [(18, 576), (34, 576), (50, 2304),
                                        (101, 2304), (1, 576)])
def test_feature_dims_and_specs_match_jax(depth, dim):
    """576 features at the basic depths, 2304 at the bottleneck ones, 576
    at a depth without a layout (the 18 fallback); both names share JAX's
    spec."""
    assert slowfast_feat_dim(depth) == dim
    for name in ("slowfast", "slowfast_fb"):
        assert vars(backbone_spec(name, depth)) == vars(jax_spec(name, depth))
        assert backbone_spec(name, depth).feat_dim == dim


@pytest.mark.parametrize("depth, widths", [
    (18, (80, 80, 160, 320)), (50, (80, 320, 640, 1280))])
def test_stage_input_widths_and_projections(depth, widths):
    """The lateral concatenations widen the slow pathway: each stage's
    first block takes ``widths`` channels and has a projection shortcut,
    stride 1 or not; the other blocks have none."""
    model = make_backbone("slowfast", depth, dtype=torch.float32)
    _, counts, _ = SLOWFAST_LAYERS[depth]
    for li, n in enumerate(counts):
        first = getattr(model, f"slow_layer{li + 1}_block1")
        assert first.conv1.weight.shape[1] == widths[li]
        assert first.project
        assert not any(getattr(model, f"slow_layer{li + 1}_block{b + 1}"
                               ).project for b in range(1, n))


# ------------------------------------------------------------ blocks

def _block_pair(block):
    from cstp_tpu.models import slowfast as js
    from cstp_tpu_torch.models import slowfast as ps

    f32 = dict(dtype=jnp.float32)
    return {
        # (JAX module, port module, input channels)
        "basic-proj-stride1": (js._SFBasic(8, 1, 1, **f32),
                               ps._SFBasic(16, 8, 1, 1, torch.float32), 16),
        "basic-stride2-kt3": (js._SFBasic(8, 3, 2, **f32),
                              ps._SFBasic(8, 8, 3, 2, torch.float32), 8),
        "basic-identity": (js._SFBasic(8, 3, 1, **f32),
                           ps._SFBasic(8, 8, 3, 1, torch.float32), 8),
        "bottleneck-proj-stride1": (
            js._SFBottleneck(4, 3, 1, **f32),
            ps._SFBottleneck(10, 4, 3, 1, torch.float32), 10),
        "bottleneck-stride2": (
            js._SFBottleneck(4, 1, 2, **f32),
            ps._SFBottleneck(16, 4, 1, 2, torch.float32), 16),
        "lateral": (js._Lateral(4, **f32),
                    ps._Lateral(8, 4, torch.float32), 8),
    }[block]


@pytest.mark.parametrize("block", [
    "basic-proj-stride1", "basic-stride2-kt3", "basic-identity",
    "bottleneck-proj-stride1", "bottleneck-stride2", "lateral"])
def test_block_eval_mode_matches_jax(block):
    """One block in eval mode, 3 clips of 8 x 12^2, running statistics off
    their init; the lateral takes 8 frames to 2."""
    jblock, pblock, cin = _block_pair(block)
    x = clips_of_videos(np.random.default_rng(3), 3, 8, 12, cin)
    variables = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x), True)
    stats = _perturbed_stats(_np_tree(variables["batch_stats"]), 2)
    load_jax_variables(pblock, _np_tree(variables["params"]), stats)
    want = np.asarray(jblock.apply(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x), False))
    got = pblock(torch.from_numpy(x), False).detach().numpy()
    assert got.shape == want.shape
    if block == "lateral":
        assert got.shape == (3, 2, 12, 12, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ backbones

@pytest.fixture(scope="module")
def backbone_pairs():
    """Per depth: JAX's backbone, the port's (seed 1) and the port's
    variables with running statistics moved off their init."""
    out = {}
    for i, depth in enumerate((18, 50)):
        model = make_backbone("slowfast_fb", depth, dtype=torch.float32,
                              gen=torch.Generator().manual_seed(1))
        params, stats = _variables(model)
        stats = _perturbed_stats(stats, i)
        load_jax_variables(model, params, stats)
        out[depth] = (jax_make_backbone("slowfast_fb", depth,
                                        dtype=jnp.float32), model,
                      {"params": params, "batch_stats": stats})
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("depth", [18, 50])
def test_backbone_features_match_jax(backbone_pairs, depth, train):
    """The whole SlowFastNet from the same weights; in train mode also the
    running statistics. Eval mode at 1e-5, train mode within ten times the
    float32 spread (module docstring)."""
    jmodel, model, variables = backbone_pairs[depth]
    x = clips_of_videos(np.random.default_rng(4), B)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if not train:
        want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, False))(
            variables, jnp.asarray(x)))
        got = model(torch.from_numpy(x), False).detach().numpy()
        assert got.shape == (B, slowfast_feat_dim(depth))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return

    def run(xx):
        model.load_state_dict(sd)
        out = [model(torch.from_numpy(xx), True).detach().numpy()]
        return out + list(_flat(export_jax_variables(model)[1]).values())

    spread = _spread(run, x)
    got = run(x)
    want, mutated = jax.jit(lambda v, a: jmodel.apply(
        v, a, True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    wstats = _flat(_np_tree(mutated["batch_stats"]))
    assert list(wstats) == list(_flat(export_jax_variables(model)[1]))
    _assert_within_spread(got, [np.asarray(want)] + list(wstats.values()),
                          spread, f"slowfast-{depth}")
    model.load_state_dict(sd)


def test_length_not_divisible_by_alpha_fails_in_both():
    """6 fast frames with ``alpha`` 4: JAX's assert, the port's
    ``ValueError``, the same message."""
    x = np.zeros((1, 6, 32, 32, 3), np.float32)
    model = make_backbone("slowfast", 18, dtype=torch.float32)
    with pytest.raises(ValueError, match="not divisible by alpha=4"):
        model(torch.from_numpy(x), False)
    jmodel = jax_make_backbone("slowfast", 18, dtype=jnp.float32)
    with pytest.raises(AssertionError, match="not divisible by alpha=4"):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), False))


def test_alpha_reaches_the_towers_and_the_head():
    """``--alpha`` builds both towers and the finetune backbone with its
    ratio; 8 frames at alpha 8 give one slow frame."""
    cfg = Config(**_kw("slowfast", alpha=8, task="loss_com")).finalize()
    model = create_pretrain_state(cfg, device="cpu")[0]
    assert model.online_net.alpha == model.target_net.alpha == 8
    clf = pft.create_classify_model(Config(**_kw(
        "slowfast_fb", alpha=2, task="ft_all")).finalize(), N_CLASSES,
        device="cpu")
    assert clf.online_net.alpha == 2
    assert jax_create_pretrain_model(JaxConfig(**_kw(
        "slowfast", alpha=8)).finalize()).alpha == 8
    feat = model.online_net(torch.from_numpy(clips_of_videos(
        np.random.default_rng(0), 2)), False)
    assert feat.shape == (2, 576)


def test_per_view_bn_is_one_call_per_view():
    """The port's counterpart of ``tests/test_pretrain_step.py``'s per-view
    test on slowfast: in the 2B call of ``CSTPPretrain``, view 1's
    playback and rotation logits do not depend on view 2 (every BatchNorm,
    the laterals' too, takes its statistics per view)."""
    model = CSTPPretrain("slowfast", 18, dtype=torch.float32,
                         gen=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x1, x2a, x2b = (torch.from_numpy(rng.uniform(-1, 1, (2, T, S, S, 3)
                                                 ).astype(np.float32))
                    for _ in range(3))
    sd = {k: v.clone() for k, v in model.state_dict().items()}

    def run(x2):
        model.load_state_dict(sd)
        with torch.no_grad():
            return model(x1, x2, True)[1]

    outs_a, outs_b = run(x2a), run(x2b)
    for i in (2, 4):          # pb1, rot1
        np.testing.assert_allclose(outs_a[i].numpy(), outs_b[i].numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert not np.allclose(outs_a[3].numpy(), outs_b[3].numpy())


def _jax_classify(name, depth):
    return JaxClassify(backbone=name, depth=depth, num_classes=N_CLASSES,
                       dtype=jnp.float32)


# (port module builder, JAX module builder)
TREES = {
    "pretrain-18": lambda: (
        create_pretrain_state(Config(**_kw("slowfast")).finalize(),
                              device="cpu")[0],
        jax_create_pretrain_model(JaxConfig(**_kw("slowfast")).finalize())),
    "classify-18": lambda: (
        pft.create_classify_model(Config(**_kw("slowfast_fb")).finalize(),
                                  N_CLASSES, device="cpu"),
        _jax_classify("slowfast_fb", 18)),
    "classify-50": lambda: (
        pft.create_classify_model(Config(**_kw("slowfast_fb",
                                               50)).finalize(),
                                  N_CLASSES, device="cpu"),
        _jax_classify("slowfast_fb", 50)),
}


@pytest.mark.parametrize("case", list(TREES))
def test_parameter_trees_match_jax(case):
    """The port's parameters and running statistics, exported through the
    bridge, have exactly the paths and shapes of JAX's ``init``
    (``eval_shape``), the laterals' ``lateral_*/bn/bn/*`` included."""
    model, jmodel = TREES[case]()
    x = jnp.zeros((2, T, S, S, 3), jnp.float32)
    args = (x, x, True) if case.startswith("pretrain") else (x, True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *args))
    params, stats = export_jax_variables(model)
    for got, want in ((params, shapes["params"]),
                      (stats, shapes["batch_stats"])):
        assert _shapes(got) == _shapes(want)
    assert "bn" in params["online_net"]["lateral_pool1"]["bn"]


# ------------------------------------------------------------ pretrain

@pytest.fixture(scope="module")
def pretrain_base():
    """The port's initial slowfast-18 pretrain state (seed 0) and its
    variables in JAX's layout."""
    cfg = Config(**_kw("slowfast")).finalize()
    model, _, _ = create_pretrain_state(cfg, device="cpu")
    params, stats = _variables(model)
    return model, params, stats


@pytest.mark.parametrize("concat_views", [0])
def test_pretrain_forward_matches_jax(pretrain_base, concat_views):
    """The loss, the six logits and the running statistics of one
    train-mode forward with one tower call per view, within ten times the
    float32 spread (the 2B call of ``concat_views`` 1 is the pretrain
    step's, held below)."""
    base, params, stats = pretrain_base
    kw = _kw("slowfast", concat_views=concat_views)
    model, _, _ = create_pretrain_state(Config(**kw).finalize(),
                                        device="cpu")
    jmodel = jax_create_pretrain_model(JaxConfig(**kw).finalize())
    rng = np.random.default_rng(8)
    x1, x2 = clips_of_videos(rng, B), clips_of_videos(rng, B)
    (jloss, jout), mutated = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x1),
        jnp.asarray(x2))

    def run(views):
        model.load_state_dict(base.state_dict())
        with torch.no_grad():
            loss, out = model(torch.from_numpy(views[:B]),
                              torch.from_numpy(views[B:]), True)
        return ([loss.numpy()] + [o.numpy() for o in out]
                + list(_flat(export_jax_variables(model)[1]).values()))

    views = np.concatenate([x1, x2])
    got = run(views)
    assert [o.shape[-1] for o in got[1:7]] == [5, 5, 4, 4, 4, 4]
    wstats = _flat(_np_tree(mutated["batch_stats"]))
    assert list(wstats) == list(_flat(export_jax_variables(model)[1]))
    want = [np.asarray(jloss)] + [np.asarray(o) for o in jout] \
        + list(wstats.values())
    _assert_within_spread(got, want, _spread(run, views), "slowfast forward")


@pytest.fixture(scope="module")
def pretrain_step(pretrain_base):
    """One float32 pretrain step on each side from the same weights and
    batch; JAX's state and optimizer from its own
    ``create_pretrain_state``."""
    kw = _kw("slowfast")
    _, params0, stats0 = pretrain_base
    with _jax_init_returns(JaxPretrain, params0, stats0):
        jmodel, jstate, jtx = jax_create_pretrain_state(
            JaxConfig(**kw).finalize(), jax.random.PRNGKey(0))
    cfg = Config(**kw).finalize()
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    load_jax_variables(model, params0, stats0)
    _, jtrain = jax_split_pretrain_step(jmodel, jtx,
                                        JaxConfig(**kw).finalize())
    rng = np.random.default_rng(9)
    batch = {k: rng.integers(0, 5, (B,)).astype(np.int32)
             for k in ("spa", "tem")}
    batch.update({k: rng.integers(0, 4, (B,)).astype(np.int32)
                  for k in ("pb", "rot1", "rot2")})
    batch.update(view1=clips_of_videos(rng, B), view2=clips_of_videos(rng, B))
    jstate, jm = jtrain(jstate, tuple(jnp.asarray(batch[k]) for k in KEYS),
                        jnp.float32(LR))
    state, pm = make_preaugmented_step(model, tx, cfg)(
        state, {k: torch.from_numpy(batch[k]) for k in KEYS}, LR)
    return dict(jm={k: float(v) for k, v in jm.items()},
                pm={k: float(v) for k, v in pm.items()}, jstate=jstate,
                state=state, params0=params0)


def test_pretrain_step_losses_match(pretrain_step):
    jm, pm = pretrain_step["jm"], pretrain_step["pm"]
    assert pm.keys() == jm.keys()
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_pretrain_step_batch_stats_match(pretrain_step):
    _, stats = export_jax_variables(pretrain_step["state"].model)
    _assert_close(stats, _np_tree(pretrain_step["jstate"].batch_stats), 1e-4,
                  "batch_stats")


def test_pretrain_step_updates_match(pretrain_step):
    params, _ = export_jax_variables(pretrain_step["state"].model)
    p0 = pretrain_step["params0"]
    delta = jax.tree_util.tree_map(np.subtract, params, p0)
    want = jax.tree_util.tree_map(
        np.subtract, _np_tree(pretrain_step["jstate"].params), p0)
    _assert_close_in_norm(delta, want, "params - params0")
    moved = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a: float(np.abs(a).max()), delta["online_net"]))
    assert max(moved) > 0.0


# ------------------------------------------------------------ finetune

@pytest.fixture(scope="module")
def finetune_step():
    """One ft_all step of slowfast_fb-18 on each side from the same weights
    and clips, then the eval logits of the stepped states on the same test
    windows."""
    kw = _kw("slowfast_fb", 18, task="ft_all")
    jcfg = JaxConfig(**kw).finalize()
    cfg = Config(**kw).finalize()
    model, state, tx = pft.create_finetune_state(cfg, N_CLASSES,
                                                 device="cpu")
    params0, stats0 = _variables(model)
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
                plogits=plogits)


def test_finetune_step_matches_jax(finetune_step):
    jm, pm = finetune_step["jm"], finetune_step["pm"]
    assert pm.keys() == jm.keys() == {"loss", "acc"}
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    params, stats = export_jax_variables(finetune_step["state"].model)
    _assert_close(stats, _np_tree(finetune_step["jstate"].batch_stats),
                  1e-4, "batch_stats")
    p0 = finetune_step["params0"]
    _assert_close_in_norm(
        jax.tree_util.tree_map(np.subtract, params, p0),
        jax.tree_util.tree_map(np.subtract,
                               _np_tree(finetune_step["jstate"].params), p0),
        "params - params0")


def test_eval_logits_match_jax(finetune_step):
    assert finetune_step["plogits"].shape == (3, N_CLASSES)
    np.testing.assert_allclose(finetune_step["plogits"],
                               finetune_step["jlogits"], rtol=1e-4,
                               atol=1e-5)


_JAX_PARAMS = {}


@pytest.mark.parametrize("idx", range(6))
def test_frozen_parameters_match_jax(idx):
    """``ft_begin_index`` 0-5 on slowfast_fb freezes JAX's leaves. The
    prefixes match whole path parts, and ``online_net/conv1`` ..
    ``conv{i}`` name no SlowFast module, so index 1-4 freezes ``cls_bn``
    alone: the reference-side state the JAX package has, reproduced."""
    kw = _kw("slowfast_fb", task="scratch", ft_begin_index=idx)
    jcfg = JaxConfig(**kw).finalize()
    cfg = Config(**kw).finalize()
    want = jft.finetune_frozen_prefixes(jcfg)
    if not _JAX_PARAMS:
        jmodel = jft.create_classify_model(jcfg, N_CLASSES)
        _JAX_PARAMS["p"] = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((2, T, S, S, 3)), train=True)
        )["params"]
    jlabels = _flat(jax_param_labels(_JAX_PARAMS["p"], want))
    model = pft.create_classify_model(cfg, N_CLASSES, device="cpu")
    got = pft.finetune_frozen_prefixes(cfg)
    assert got == tuple(p.replace("/", ".") for p in want)
    optim.freeze(model, got)
    pflat = _flat(export_named(model, {
        n: torch.tensor(float(not p.requires_grad))
        for n, p in model.named_parameters()}))
    assert pflat.keys() == jlabels.keys()
    frozen = {k for k, v in pflat.items() if v}
    assert frozen == {k for k, v in jlabels.items() if v == "frozen"}
    if 1 <= idx <= 4:
        assert {n for n, p in model.named_parameters()
                if not p.requires_grad} == {"cls_bn.scale", "cls_bn.bias"}


# ------------------------------------------------------------ data path

@pytest.mark.parametrize("tau, alpha, stride", [(16, 8, 2), (8, 4, 2),
                                                (8, 8, 1), (4, 8, 1)])
def test_clip_stride_is_tau_over_alpha(tau, alpha, stride):
    """The finetune and test loaders' frame stride for slowfast is ``tau
    // alpha`` (at least 1), JAX's; other models keep ``pb_rate``."""
    for name in ("slowfast", "slowfast_fb"):
        kw = dict(model_name=name, tau=tau, alpha=alpha, pb_rate=3)
        assert Config(**kw).finalize().clip_stride == stride
        assert JaxConfig(**kw).finalize().clip_stride == stride
    assert Config(model_name="r21d_byol", tau=tau, alpha=alpha,
                  pb_rate=3).finalize().clip_stride == 3


def test_finetune_and_test_clis_sample_at_tau_over_alpha(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``main_ft`` then ``main_test`` on slowfast_fb with ``device="cpu"``
    on synthetic videos, ``--tau 8 --alpha 4``: the train and val loaders
    and every test window take frames at stride 2."""
    strides = {"loader": [], "windows": []}
    loader_cls, windows_fn = loops.FinetuneLoader, loops.sliding_window_indices

    def loader(ds, batch, duration, stride, *a, **k):
        strides["loader"].append(stride)
        return loader_cls(ds, batch, duration, stride, *a, **k)

    def windows(nframes, duration, stride, *a, **k):
        strides["windows"].append(stride)
        return windows_fn(nframes, duration, stride, *a, **k)

    monkeypatch.setattr(loops, "FinetuneLoader", loader)
    monkeypatch.setattr(loops, "sliding_window_indices", windows)
    common = ["--model_name", "slowfast_fb", "--model_depth", "18",
              "--tau", "8", "--alpha", "4", "--pb_rate", "5",
              "--data_backend", "synthetic", "--synthetic_len", "4",
              "--sample_duration", str(T), "--sample_size", str(S),
              "--compute_dtype", "float32", "--batch_size", "2",
              "--n_classes", "5", "--n_finetune_classes", "5",
              "--n_workers", "2", "--log_every", "0",
              "--result_path", str(tmp_path)]
    out = main_ft.main(common + ["--task", "ft_all", "--n_epochs", "1",
                                 "--steps_per_epoch", "1"], device="cpu")
    assert np.isfinite(out["history"][0]["train_loss"])
    res = main_test.main(common + ["--task", "test", "--t_ft_task",
                                   "ft_all"], device="cpu")
    assert res["n_videos"] == 4 and 0.0 <= res["accuracy"] <= 1.0
    assert "Video accuracy =" in capsys.readouterr().out
    assert strides["loader"] == [2, 2]
    assert len(strides["windows"]) == 4 and set(strides["windows"]) == {2}


# ------------------------------------------------------------ importer

def test_pth_importer_has_no_slowfast_map():
    """Neither package has a reference name map for SlowFast: both the
    import and the export refuse it with JAX's ``ValueError``."""
    model = create_pretrain_state(Config(**_kw("slowfast")).finalize(),
                                  device="cpu")[0]
    tree = export_state_dict(model.state_dict())
    for mod in (pti, jti):
        for arch in ("slowfast", "slowfast_fb"):
            with pytest.raises(ValueError, match="unknown model family"):
                mod.export_torch_state_dict(tree, arch)
            with pytest.raises(ValueError, match="unknown model family"):
                mod.convert_torch_state_dict({}, arch)
