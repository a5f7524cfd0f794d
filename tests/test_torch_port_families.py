"""The C3D and 3D-ResNet backbone families of the port (cstp_tpu_torch)
against the JAX package's, on the CPU in float32, from the same bridged
weights (``models/bridge.py``) and numpy-seeded inputs.

Sizes: 8 frames (C3D pools time three times), 32^2, per-view batch 4.

Tolerances:
- backbone features and running statistics: rtol 1e-5, atol 1e-5 (a
  float32 forward in another convolution and reduction order agrees to
  about 1e-6 relative);
- ``max_pool_3d``: exactly equal (a max rounds nothing);
- the pretrain forward: loss and the six logits rtol 1e-4 (atol 1e-5),
  the running statistics rtol 1e-5 (atol 1e-5);
- the pretrain and finetune steps: those of
  ``tests/test_torch_port_pretrain.py``: losses rtol 1e-4, running
  statistics rtol 1e-4, the updates leaf by leaf in norm, ``|got - want|
  <= 5e-2 |want| + 1e-4 |all of want|`` (the float32 BatchNorm backward
  over pooled features is ill conditioned at test sizes);
- the eval logits: rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.models import backbone_spec as jax_spec
from cstp_tpu.models import make_backbone as jax_make_backbone
from cstp_tpu.models.layers import max_pool_3d as jax_max_pool_3d
from cstp_tpu.train import finetune as jft
from cstp_tpu.train.optim import param_labels as jax_param_labels
from cstp_tpu.train.pretrain import (
    create_pretrain_state as jax_create_pretrain_state,
    split_pretrain_step as jax_split_pretrain_step,
)
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models import backbone_spec, make_backbone
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    export_named,
    load_jax_variables,
)
from cstp_tpu_torch.models.layers import max_pool_3d
from cstp_tpu_torch.train import finetune as pft
from cstp_tpu_torch.train import optim
from cstp_tpu_torch.train.pretrain import (
    create_pretrain_state,
    make_preaugmented_step,
)

from _torch_threads import torch_threads  # noqa: F401

B, T, S, H0, W0 = 4, 8, 32, 40, 48
N_CLASSES = 7
LR = 3e-4
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")

# (model_name, depth, shortcut, feature width)
BACKBONES = {
    "c3d": ("c3d_byol", 1, "B", 512),
    "r3d-10-A": ("r3d_byol", 10, "A", 512),
    "r3d-10-B": ("r3d_byol", 10, "B", 512),
    "r3d-18": ("r3d_byol", 18, "B", 512),
    "r3d-50": ("r3d_byol", 50, "B", 2048),
}
# train mode: r3d-50 is replaced by one bottleneck block per stage, built
# from the ResNet3D classes (see test_backbone_forward_matches_jax)
TRAIN_BACKBONES = {k: v for k, v in BACKBONES.items() if k != "r3d-50"}
TRAIN_BACKBONES.update({f"bottleneck-1111-{sc}": ("bottleneck", None, sc,
                                                   2048) for sc in "AB"})
FAMILIES = {"c3d": ("c3d_byol", 1), "r3d-18": ("r3d_byol", 18)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_close(got, want, rtol, what):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-5,
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


def _kw(name, depth, **over):
    kw = dict(model_name=name, model_depth=depth, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              learning_rate=LR, n_finetune_classes=N_CLASSES,
              mesh_shape=(1, 1))
    kw.update(over)
    return kw


# ------------------------------------------------------------ backbones

def _backbone_pair(name, depth, shortcut):
    """JAX's backbone and the port's; ``name`` "bottleneck": the ResNet3D
    classes with one bottleneck block per stage."""
    if name == "bottleneck":
        from cstp_tpu.models.r3d import ResNet3D as JaxResNet3D
        from cstp_tpu_torch.models.r3d import ResNet3D

        return (JaxResNet3D("bottleneck", (1, 1, 1, 1), shortcut,
                            jnp.float32),
                ResNet3D("bottleneck", (1, 1, 1, 1), shortcut, torch.float32))
    return (jax_make_backbone(name, depth, dtype=jnp.float32,
                              shortcut=shortcut),
            make_backbone(name, depth, dtype=torch.float32,
                          shortcut=shortcut))


@pytest.mark.parametrize("train, case",
                         [(False, c) for c in BACKBONES]
                         + [(True, c) for c in TRAIN_BACKBONES])
def test_backbone_forward_matches_jax(case, train):
    """Features (and, in train mode, the running statistics) of the port's
    backbone from JAX's weights, one BN group of 4 clips.

    In train mode each BatchNorm normalises by statistics of this batch,
    and r3d's last stage is 1x1x1 at this size, so a BatchNorm there sees
    4 values per channel: a variance near eps amplifies float32 rounding,
    and more so the deeper the network. For r3d-50 (16 blocks) the
    amplification exceeds the tolerance: a 1e-7 relative change of the
    input moves the port's own train-mode features by about 1.5e-4 at this
    size. So r3d-50 is held to 1e-5 in eval mode, and its bottleneck block
    in train mode at one block per stage."""
    name, depth, shortcut, feat = (TRAIN_BACKBONES if train
                                   else BACKBONES)[case]
    x = clips_of_videos(np.random.default_rng(0), B)
    jmodel, model = _backbone_pair(name, depth, shortcut)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), True)
    # running statistics off their init, so eval mode uses them
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.2, v.shape).astype(
            np.float32), _np_tree(variables["batch_stats"]))
    variables = {"params": variables["params"], "batch_stats": stats}
    load_jax_variables(model, _np_tree(variables["params"]), stats)
    if train:
        want, mutated = jmodel.apply(variables, jnp.asarray(x), True,
                                     mutable=["batch_stats"])
    else:
        want = jmodel.apply(variables, jnp.asarray(x), False)
    got = model(torch.from_numpy(x), train)
    assert got.dtype == torch.float32 and got.shape == (B, feat)
    if depth is not None:
        assert vars(backbone_spec(name, depth)) == vars(jax_spec(name,
                                                                 depth))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if train:
        _, pstats = export_jax_variables(model)
        _assert_close(pstats, _np_tree(mutated["batch_stats"]), 1e-5,
                      "batch_stats")


@pytest.mark.parametrize("kernel, stride, padding", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),    # r3d's stem pool
    ((1, 2, 2), (1, 2, 2), (0, 0, 0)),    # C3D's first pool
    ((2, 2, 2), (2, 2, 2), (0, 0, 0)),    # C3D's other pools
])
def test_max_pool_3d_matches_jax(kernel, stride, padding):
    """On signed values, so the -inf padding is seen at the edges."""
    x = np.random.default_rng(3).normal(size=(2, 7, 9, 10, 5)).astype(
        np.float32)
    want = np.asarray(jax_max_pool_3d(jnp.asarray(x), kernel, stride,
                                      padding))
    got = max_pool_3d(torch.from_numpy(x), kernel, stride, padding)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_default_depth_builds_r3d18():
    """``--model_depth 1`` (the default) on r3d builds r3d-18, with a 512
    feature, in both packages: the same leaves with the same shapes."""
    x = jnp.zeros((2, T, S, S, 3), jnp.float32)
    jvars = jax.eval_shape(
        lambda: jax_make_backbone("r3d_byol", 1, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), x, True))
    model = make_backbone("r3d_byol", 1, dtype=torch.float32)
    params, stats = export_jax_variables(model)
    want = {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_flatten_with_path(jvars["params"])[0]}
    assert {k: v.shape for k, v in _flat(params).items()} == want
    assert "['layer4_block2']['conv2']['kernel']" in "".join(want)
    assert "['layer4_block3']" not in "".join(want)
    assert backbone_spec("r3d_byol", 1).feat_dim == 512
    assert jax_spec("r3d_byol", 1).feat_dim == 512
    r18 = make_backbone("r3d_byol", 18, dtype=torch.float32)
    assert [n for n, _ in r18.named_parameters()] == [
        n for n, _ in model.named_parameters()]


# ------------------------------------------------------------ pretrain

@pytest.fixture(scope="module")
def pretrain_states():
    """JAX's initial pretrain state and the port's bridged from it, per
    family and concat_views."""
    out = {}
    for fam, (name, depth) in FAMILIES.items():
        for cv in (1, 0):
            kw = _kw(name, depth, concat_views=cv)
            jmodel, jstate, jtx = jax_create_pretrain_state(
                JaxConfig(**kw).finalize(), jax.random.PRNGKey(0))
            cfg = Config(**kw).finalize()
            model, state, tx = create_pretrain_state(cfg, device="cpu")
            load_jax_variables(model, _np_tree(jstate.params),
                               _np_tree(jstate.batch_stats))
            out[fam, cv] = (jmodel, jstate, jtx), (model, state, tx), kw
    return out


@pytest.mark.parametrize("concat_views", [1, 0])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_pretrain_forward_matches_jax(pretrain_states, fam, concat_views):
    (jmodel, jstate, _), (model, _, _), _ = pretrain_states[fam, concat_views]
    rng = np.random.default_rng(4)
    x1, x2 = clips_of_videos(rng, B), clips_of_videos(rng, B)
    (jloss, jout), mutated = jmodel.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        jnp.asarray(x1), jnp.asarray(x2), True, mutable=["batch_stats"])
    load_jax_variables(model, _np_tree(jstate.params),
                       _np_tree(jstate.batch_stats))
    loss, out = model(torch.from_numpy(x1), torch.from_numpy(x2), True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4,
                               atol=1e-5)
    assert [o.shape[-1] for o in out] == [5, 5, 4, 4, 4, 4]
    for g, w in zip(out, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)
    _, stats = export_jax_variables(model)
    _assert_close(stats, _np_tree(mutated["batch_stats"]), 1e-5,
                  "batch_stats")


def _pretrain_batch(rng):
    batch = {k: rng.integers(0, 5, (B,)).astype(np.int32)
             for k in ("spa", "tem")}
    batch.update(pb=rng.integers(0, 4, (B,)).astype(np.int32),
                 rot1=rng.integers(0, 4, (B,)).astype(np.int32),
                 rot2=rng.integers(0, 4, (B,)).astype(np.int32),
                 view1=clips_of_videos(rng, B), view2=clips_of_videos(rng, B))
    return batch


@pytest.fixture(scope="module", params=list(FAMILIES))
def pretrain_step(request):
    """One pretrain step on each side from the same weights and batch."""
    name, depth = FAMILIES[request.param]
    kw = _kw(name, depth)
    jmodel, jstate, jtx = jax_create_pretrain_state(
        JaxConfig(**kw).finalize(), jax.random.PRNGKey(0))
    params0 = _np_tree(jstate.params)
    cfg = Config(**kw).finalize()
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    load_jax_variables(model, params0, _np_tree(jstate.batch_stats))
    _, jtrain = jax_split_pretrain_step(jmodel, jtx,
                                        JaxConfig(**kw).finalize())
    batch = _pretrain_batch(np.random.default_rng(5))
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

@pytest.fixture(scope="module", params=list(FAMILIES))
def finetune_step(request):
    """One ft_all step on each side from the same weights and clips, then
    the eval logits of the stepped states on the same test windows."""
    name, depth = FAMILIES[request.param]
    kw = _kw(name, depth, task="ft_all")
    jcfg = JaxConfig(**kw).finalize()
    jmodel, jstate, jtx = jft.create_finetune_state(
        jcfg, jax.random.PRNGKey(0), N_CLASSES)
    params0 = _np_tree(jstate.params)
    cfg = Config(**kw).finalize()
    model, state, tx = pft.create_finetune_state(cfg, N_CLASSES,
                                                 device="cpu")
    load_jax_variables(model, params0, _np_tree(jstate.batch_stats))
    rng = np.random.default_rng(6)
    frames = np.round((clips_of_videos(rng, B, T, W0)[:, :, :H0] + 1.0)
                      * 127.5).astype(np.uint8)
    labels = rng.integers(0, N_CLASSES, (B,)).astype(np.int32)
    key = jax.random.PRNGKey(7)
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


@pytest.mark.parametrize("idx", range(6))
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_frozen_parameters_match_jax(fam, idx):
    """``ft_begin_index`` 0-5 freezes the same leaves as JAX's
    ``param_labels``: on these families the stage prefixes ``conv{i}``
    match only what they match in JAX (r3d's stem; C3D's conv1/conv2)."""
    name, depth = FAMILIES[fam]
    kw = _kw(name, depth, task="scratch", ft_begin_index=idx)
    jcfg = JaxConfig(**kw).finalize()
    cfg = Config(**kw).finalize()
    jmodel = jft.create_classify_model(jcfg, N_CLASSES)
    jparams = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, T, S, S, 3)), train=True)
    )["params"]
    want = jft.finetune_frozen_prefixes(jcfg)
    jlabels = _flat(jax_param_labels(jparams, want))
    model = pft.create_classify_model(cfg, N_CLASSES, device="cpu")
    got = pft.finetune_frozen_prefixes(cfg)
    assert got == tuple(p.replace("/", ".") for p in want)
    optim.freeze(model, got)
    pflat = _flat(export_named(model, {
        n: torch.tensor(float(not p.requires_grad))
        for n, p in model.named_parameters()}))
    assert pflat.keys() == jlabels.keys()
    assert {k for k, v in pflat.items() if v} == {
        k for k, v in jlabels.items() if v == "frozen"}


@pytest.mark.parametrize("flag", [dict(remat=True),
                                  dict(remat_policy="bnrelu"),
                                  dict(fused_conv=1), dict(fused_conv=2)],
                         ids=["remat", "bnrelu", "fused_conv1",
                              "fused_conv2"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_r21d_only_flags_change_nothing(fam, flag):
    """``--remat``, ``--remat_policy`` and ``--fused_conv`` reach R(2+1)D
    only: on these families one pretrain step from the same seed gives
    bitwise the parameters and running statistics of the step without
    the flag."""
    name, depth = FAMILIES[fam]
    batch = _pretrain_batch(np.random.default_rng(8))
    out = []
    for over in ({}, flag):
        cfg = Config(**_kw(name, depth, **over)).finalize()
        model, state, tx = create_pretrain_state(cfg, seed=3, device="cpu")
        state, m = make_preaugmented_step(model, tx, cfg)(
            state, {k: torch.from_numpy(batch[k]) for k in KEYS}, LR)
        out.append((m, model.state_dict()))
    (m0, sd0), (m1, sd1) = out
    assert {k: float(v) for k, v in m0.items()} == {
        k: float(v) for k, v in m1.items()}
    assert sd0.keys() == sd1.keys()
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
