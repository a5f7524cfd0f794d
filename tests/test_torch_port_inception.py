"""The S3D-G and I3D backbone families of the port (cstp_tpu_torch) against
the JAX package's, on the CPU in float32, from the same weights and
numpy-seeded inputs.

Sizes: 8 frames of 32^2, per-view batch 4 (both families pool down to
1x1x1 there), and I3D's conv head at its only size, 1 x 16 x 224^2.

The JAX side takes the port's initial weights (exported through
``models/bridge.py``) in place of its own ``init``, whose compile costs
minutes at full width on this host; ``test_parameter_trees_match_jax``
holds the two trees to the same paths and shapes.

Tolerances (those of ``tests/test_torch_port_families.py``):
- layers and backbones in eval mode: rtol 1e-5, atol 1e-5
  (``max_pool_3d_same``: exactly equal, a max rounds nothing); one block
  in train mode: its output rtol 1e-4 (as the pretrain forward: two
  BatchNorms in a row normalise by float32 batch statistics), its running
  statistics rtol 1e-5;
- the pretrain and finetune steps: losses and running statistics rtol
  1e-4, the updates
  leaf by leaf in norm, ``|got - want| <= 5e-2 |want| + 1e-4 |all of
  want|``; eval logits and features rtol 1e-4, atol 1e-5.
- whole backbones in train mode, and the pretrain forward: at 32^2 the
  last BatchNorms see 4 values per channel, and the features move by
  about 1e-3 of their size when the input moves by 1e-7 (float32
  rounding). They are held to ten times that spread, measured on the port
  at the same input (``_spread``), but never more than 1e-2 of their size,
  plus 1e-5 of their size: a wrong pad, stride or gate moves them by their
  own size, and the cap keeps a port that is worse conditioned than the
  JAX package from widening its own limit. On this host the largest
  error seen is 1.4e-3 of the size (S3D-G with its projector), and ten
  times the spread at most 6.4e-3.
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
from cstp_tpu.models.layers import Conv3d as JaxConv3d
from cstp_tpu.models.layers import SelfGating as JaxSelfGating
from cstp_tpu.models.layers import max_pool_3d_same as jax_pool_same
from cstp_tpu.ssl.byol import CSTPClassify as JaxClassify
from cstp_tpu.ssl.byol import CSTPPretrain as JaxPretrain
from cstp_tpu.train import finetune as jft
from cstp_tpu.train.optim import param_labels as jax_param_labels
from cstp_tpu.train.pretrain import (
    create_pretrain_model as jax_create_pretrain_model,
    create_pretrain_state as jax_create_pretrain_state,
    split_pretrain_step as jax_split_pretrain_step,
)
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models import backbone_spec, make_backbone
from cstp_tpu_torch.models import torch_import as pti
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    export_named,
    export_state_dict,
    load_jax_variables,
)
from cstp_tpu_torch.models.layers import Conv3d, SelfGating, max_pool_3d_same
from cstp_tpu_torch.ssl.byol import CSTPClassify
from cstp_tpu_torch.train import finetune as pft
from cstp_tpu_torch.train import optim
from cstp_tpu_torch.train.pretrain import (
    create_pretrain_state,
    make_preaugmented_step,
)

B, T, S, H0, W0 = 4, 8, 32, 40, 48
N_CLASSES = 7
LR = 3e-4
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")
FAMILIES = {"s3d": "s3d_byol", "i3d": "i3d_byol"}


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


def _kw(name, **over):
    kw = dict(model_name=name, model_depth=1, sample_duration=T,
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
    """``(params, batch_stats)`` of ``model`` in JAX's layout, copied (the
    bridge's float32 CPU arrays share the live tensors' memory)."""
    return jax.tree_util.tree_map(np.copy, export_jax_variables(model))


def _perturbed_stats(stats, seed):
    """Running statistics off their init, so eval mode uses them."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.2, v.shape).astype(
            np.float32), stats)


def _spread(run, x):
    """Per output of ``run`` (a list of arrays from one call on ``x``), the
    largest change a 1e-7 relative change of ``x`` makes: the float32
    noise floor of the computation at this input."""
    a, b = run(x), run(x * np.float32(1 + 1e-7))
    return [float(np.abs(u - v).max()) for u, v in zip(a, b)]


def _assert_within_spread(got, want, spread, what):
    for i, (g, w, s) in enumerate(zip(got, want, spread)):
        err = float(np.abs(g - w).max())
        size = 1 + float(np.abs(w).max())
        assert err <= min(10 * s, 1e-2 * size) + 1e-5 * size, (
            f"{what} output {i}: max |got - want| {err:.3e}, float32 "
            f"spread {s:.3e}, size {size:.3e}")


# ------------------------------------------------------------ layers

@pytest.mark.parametrize("kernel, stride, padding", [
    ((7, 7, 7), (2, 2, 2), ((2, 3), (2, 3), (2, 3))),  # I3D's stem, SAME
    ((3, 3, 3), (1, 2, 2), ((1, 1), (0, 1), (1, 0))),  # mixed lo/hi
    ((1, 3, 3), (1, 1, 1), (0, 1, 1)),                 # symmetric ints
])
def test_conv3d_pads_match_jax(kernel, stride, padding):
    x = np.random.default_rng(0).normal(size=(2, 7, 9, 10, 5)).astype(
        np.float32)
    jconv = JaxConv3d(6, kernel, stride, padding, dtype=jnp.float32)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    conv = Conv3d(5, 6, kernel, stride, padding, torch.float32)
    load_jax_variables(conv, _np_tree(variables["params"]), {})
    got = conv(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [(7, 9, 10), (8, 12, 12)],
                         ids=["odd", "even"])
@pytest.mark.parametrize("kernel, stride", [
    ((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2)), ((2, 2, 2), (2, 2, 2))])
def test_max_pool_3d_same_matches_jax(kernel, stride, size):
    """I3D's four TF-SAME pools, on signed values so the -inf padding is
    seen at the edges."""
    x = np.random.default_rng(1).normal(size=(2, *size, 5)).astype(
        np.float32)
    want = np.asarray(jax_pool_same(jnp.asarray(x), kernel, stride))
    got = max_pool_3d_same(torch.from_numpy(x), kernel, stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_self_gating_matches_jax(dtype):
    """The gate is computed in float32 and the result cast back to the
    input's dtype."""
    x = np.random.default_rng(2).normal(size=(3, 2, 4, 4, 8)).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    jgate = JaxSelfGating(dtype=jnp.dtype(dtype))
    variables = jgate.init(jax.random.PRNGKey(0), jx)
    want = np.asarray(jgate.apply(variables, jx).astype(jnp.float32))
    gate = SelfGating(8)
    load_jax_variables(gate, _np_tree(variables["params"]), {})
    got = gate(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=tol,
                               atol=tol)


# ------------------------------------------------------------ blocks

def _block_pair(block):
    from cstp_tpu.models import i3d as ji
    from cstp_tpu.models import s3dg as js
    from cstp_tpu_torch.models import i3d as pi
    from cstp_tpu_torch.models import s3dg as ps

    f32 = dict(dtype=jnp.float32)
    return {
        "sep-inception-gated": (
            js.SepInception([8, 6, 8, 4, 6, 4], True, **f32),
            ps.SepInception(16, [8, 6, 8, 4, 6, 4], True, torch.float32)),
        "s3d-stem": (js.STConv3d(16, 7, (2, 2, 2), 3, **f32),
                     ps.STConv3d(16, 16, 7, (2, 2), 3, torch.float32)),
        "i3d-mixed": (ji.Mixed([8, 6, 8, 4, 6, 4], **f32),
                      pi.Mixed(16, [8, 6, 8, 4, 6, 4], torch.float32)),
        "i3d-stem": (ji.Unit3D(16, (7, 7, 7), (2, 2, 2), **f32),
                     pi.Unit3D(16, 16, 7, 2, dtype=torch.float32)),
    }[block]


@pytest.mark.parametrize("block", ["sep-inception-gated", "s3d-stem",
                                   "i3d-mixed", "i3d-stem"])
def test_block_train_mode_matches_jax(block):
    """One block in train mode, 8 clips of 8 x 12^2: its output and running
    statistics."""
    x = clips_of_videos(np.random.default_rng(3), 8, 8, 12)
    x = np.concatenate([x] * 6, -1)[..., :16]
    jblock, pblock = _block_pair(block)
    variables = jblock.init(jax.random.PRNGKey(1), jnp.asarray(x), True)
    load_jax_variables(pblock, _np_tree(variables["params"]),
                       _np_tree(variables["batch_stats"]))
    want, mutated = jblock.apply(variables, jnp.asarray(x), True,
                                 mutable=["batch_stats"])
    got = pblock(torch.from_numpy(x), True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    _assert_close(export_jax_variables(pblock)[1],
                  _np_tree(mutated["batch_stats"]), 1e-5, "batch_stats")


# ------------------------------------------------------------ backbones

# case -> (model_name, make_backbone kwargs)
BACKBONES = {
    "s3d-gated-proj": ("s3d_byol", dict(proj_flag=True)),
    "s3d-ungated": ("s3d_byol", dict(gating=False)),
    "s3d-slow": ("s3d_byol", dict(slow=True)),
    "i3d": ("i3d_byol", {}),
}


@pytest.fixture(scope="module")
def backbone_pairs():
    """Per case: JAX's backbone, the port's (seed 1) and the port's
    variables with running statistics moved off their init."""
    out = {}
    for i, (case, (name, kw)) in enumerate(BACKBONES.items()):
        model = make_backbone(name, dtype=torch.float32,
                              gen=torch.Generator().manual_seed(1), **kw)
        params, stats = _variables(model)
        stats = _perturbed_stats(stats, i)
        load_jax_variables(model, params, stats)
        out[case] = (jax_make_backbone(name, dtype=jnp.float32, **kw), model,
                     {"params": params, "batch_stats": stats})
    return out


def _outputs(out):
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o.detach().numpy() if hasattr(o, "detach") else o)
            for o in out]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(BACKBONES))
def test_backbone_features_match_jax(backbone_pairs, case, train):
    """Features (and the projection with ``proj_flag``) of the port's
    backbone from the same weights; in train mode also the running
    statistics. Eval mode at 1e-5; train mode within ten times the float32
    spread (module docstring)."""
    jmodel, model, variables = backbone_pairs[case]
    x = clips_of_videos(np.random.default_rng(4), B)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if not train:
        want = _outputs(jax.jit(lambda v, a: jmodel.apply(v, a, False))(
            variables, jnp.asarray(x)))
        got = _outputs(model(torch.from_numpy(x), False))
        assert got[0].shape == (B, 1024)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        return

    def run(xx):
        model.load_state_dict(sd)
        out = _outputs(model(torch.from_numpy(xx), True))
        return out + list(_flat(export_jax_variables(model)[1]).values())

    spread = _spread(run, x)
    got = run(x)
    want, mutated = jax.jit(lambda v, a: jmodel.apply(
        v, a, True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    want = _outputs(want)
    wstats = _flat(_np_tree(mutated["batch_stats"]))
    assert list(wstats) == list(_flat(export_jax_variables(model)[1]))
    _assert_within_spread(got, want + list(wstats.values()), spread, case)
    model.load_state_dict(sd)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_per_view_bn_is_one_call_per_view(fam):
    """Two BN groups over the concatenated views give each view's
    features of a one-group backbone called on that view alone, and the
    mean of the two calls' running statistics (within the float32
    spread)."""
    kw = dict(dtype=torch.float32, gen=torch.Generator().manual_seed(2))
    both = make_backbone(FAMILIES[fam], bn_groups=2, **kw)
    one = make_backbone(FAMILIES[fam], bn_groups=1, **kw)
    one.load_state_dict(both.state_dict())
    sd = {k: v.clone() for k, v in both.state_dict().items()}
    rng = np.random.default_rng(5)
    x = np.concatenate([clips_of_videos(rng, B), clips_of_videos(rng, B)])

    def run_both(xx):
        both.load_state_dict(sd)
        feat = both(torch.from_numpy(xx), True).detach().numpy()
        return [feat[:B], feat[B:]] + [b.numpy().copy()
                                       for b in both.buffers()]

    def run_views(xx):
        feats, stats = [], []
        for v in (xx[:B], xx[B:]):
            one.load_state_dict(sd)
            feats.append(one(torch.from_numpy(v), True).detach().numpy())
            stats.append([b.numpy().copy() for b in one.buffers()])
        # running = 0.9 r + 0.1 mean of the two views' statistics
        return feats + [0.5 * (a + b) for a, b in zip(*stats)]

    _assert_within_spread(run_both(x), run_views(x),
                          _spread(run_both, x), fam)


def test_i3d_conv_head_matches_jax_at_224():
    """``--i3d_conv_head``: the reference classifier inside I3D, eval mode,
    one 16 x 224^2 clip (as ``tests/test_torch_parity.py`` holds JAX's to
    the reference)."""
    model = make_backbone("i3d_classify", dtype=torch.float32,
                          conv_head=True, num_classes=N_CLASSES,
                          gen=torch.Generator().manual_seed(3))
    params, stats = _variables(model)
    stats = _perturbed_stats(stats, 7)
    load_jax_variables(model, params, stats)
    x = clips_of_videos(np.random.default_rng(6), 1, 16, 224)
    jmodel = jax_make_backbone("i3d_classify", dtype=jnp.float32,
                               conv_head=True, num_classes=N_CLASSES)
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    got = model(torch.from_numpy(x), False).detach().numpy()
    assert got.shape == (1, N_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_i3d_conv_head_refuses_112():
    """The (2, 7, 7) window needs a 7x7 final map: 112^2 raises in both
    packages."""
    x = np.zeros((1, 16, 112, 112, 3), np.float32)
    model = make_backbone("i3d_classify", dtype=torch.float32,
                          conv_head=True, num_classes=N_CLASSES)
    with pytest.raises(ValueError, match="7, 7"):
        model(torch.from_numpy(x), False)
    jmodel = jax_make_backbone("i3d_classify", dtype=jnp.float32,
                               conv_head=True, num_classes=N_CLASSES)
    with pytest.raises(ValueError, match="7, 7"):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x), False))


def _jax_classify(name, head):
    return JaxClassify(backbone=name, depth=1, num_classes=N_CLASSES,
                       head_style=head, dtype=jnp.float32)


# (model, port module builder, JAX module builder)
TREES = {
    "s3d-pretrain": lambda: (
        create_pretrain_state(Config(**_kw("s3d_byol")).finalize(),
                              device="cpu")[0],
        jax_create_pretrain_model(JaxConfig(**_kw("s3d_byol")).finalize())),
    "i3d-pretrain": lambda: (
        create_pretrain_state(Config(**_kw("i3d_byol")).finalize(),
                              device="cpu")[0],
        jax_create_pretrain_model(JaxConfig(**_kw("i3d_byol")).finalize())),
    "s3d-ungated": lambda: (
        make_backbone("s3d_byol", gating=False),
        jax_make_backbone("s3d_byol", gating=False)),
    "s3d_classify-mlp": lambda: (
        CSTPClassify("s3d_classify", 1, N_CLASSES, head_style="mlp"),
        _jax_classify("s3d_classify", "mlp")),
    "i3d-conv-head": lambda: (
        CSTPClassify("i3d_byol", 1, N_CLASSES, head_style="i3d_conv"),
        _jax_classify("i3d_byol", "i3d_conv")),
    "i3d-linear": lambda: (
        CSTPClassify("i3d_byol", 1, N_CLASSES),
        _jax_classify("i3d_byol", "linear")),
}


@pytest.mark.parametrize("case", list(TREES))
def test_parameter_trees_match_jax(case):
    """The port's parameters and running statistics, exported through the
    bridge, have exactly the paths and shapes of JAX's ``init``
    (``eval_shape``); the families' specs are JAX's."""
    model, jmodel = TREES[case]()
    s = 224 if case == "i3d-conv-head" else S
    t = 16 if case == "i3d-conv-head" else T
    x = jnp.zeros((2, t, s, s, 3), jnp.float32)
    args = (x, x, True) if case.endswith("pretrain") else (x, True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *args))
    params, stats = export_jax_variables(model)
    for got, want in ((params, shapes["params"]),
                      (stats, shapes["batch_stats"])):
        assert _shapes(got) == _shapes(want)
    for name in ("s3d_byol", "i3d_byol", "s3d_classify"):
        assert vars(backbone_spec(name)) == vars(jax_spec(name))


# ------------------------------------------------------------ pretrain

@pytest.fixture(scope="module")
def pretrain_bases():
    """Per family: the port's initial pretrain state (seed 0) and its
    variables in JAX's layout."""
    out = {}
    for fam, name in FAMILIES.items():
        cfg = Config(**_kw(name)).finalize()
        model, state, tx = create_pretrain_state(cfg, device="cpu")
        params, stats = _variables(model)
        out[fam] = (model, params, stats)
    return out


@pytest.mark.parametrize("concat_views", [1, 0])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_pretrain_forward_matches_jax(pretrain_bases, fam, concat_views):
    """The loss, the six logits and the running statistics of one train-mode
    forward; within ten times the float32 spread (module docstring): both
    towers run their BatchNorms on 4 clips per view."""
    base, params, stats = pretrain_bases[fam]
    kw = _kw(FAMILIES[fam], concat_views=concat_views)
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
    n = backbone_spec(FAMILIES[fam])
    assert [o.shape[-1] for o in got[1:7]] == [n.n_spa, n.n_tem] \
        + [n.n_pb] * 2 + [n.n_rot] * 2
    wstats = _flat(_np_tree(mutated["batch_stats"]))
    assert list(wstats) == list(_flat(export_jax_variables(model)[1]))
    want = [np.asarray(jloss)] + [np.asarray(o) for o in jout] \
        + list(wstats.values())
    _assert_within_spread(got, want, _spread(run, views), f"{fam} forward")


def _pretrain_batch(rng):
    batch = {k: rng.integers(0, 5, (B,)).astype(np.int32)
             for k in ("spa", "tem")}
    batch.update(pb=rng.integers(0, 4, (B,)).astype(np.int32),
                 rot1=rng.integers(0, 4, (B,)).astype(np.int32),
                 rot2=rng.integers(0, 4, (B,)).astype(np.int32),
                 view1=clips_of_videos(rng, B), view2=clips_of_videos(rng, B))
    return batch


@pytest.fixture(scope="module", params=list(FAMILIES))
def pretrain_step(request, pretrain_bases):
    """One pretrain step on each side from the same weights and batch; JAX's
    state and optimizer come from its own ``create_pretrain_state``."""
    name = FAMILIES[request.param]
    kw = _kw(name)
    _, params0, stats0 = pretrain_bases[request.param]
    with _jax_init_returns(JaxPretrain, params0, stats0):
        jmodel, jstate, jtx = jax_create_pretrain_state(
            JaxConfig(**kw).finalize(), jax.random.PRNGKey(0))
    cfg = Config(**kw).finalize()
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    load_jax_variables(model, params0, stats0)
    _, jtrain = jax_split_pretrain_step(jmodel, jtx,
                                        JaxConfig(**kw).finalize())
    batch = _pretrain_batch(np.random.default_rng(9))
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

FINETUNE = ("s3d_classify", "s3d_byol", "i3d_byol")


@pytest.fixture(scope="module", params=FINETUNE)
def finetune_step(request):
    """One ft_all step on each side from the same weights and clips, then
    the eval logits of the stepped states on the same test windows, and
    (linear head) the eval-mode features of the same clips."""
    name = request.param
    kw = _kw(name, task="ft_all")
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
    jvars = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    jfeat = np.asarray(jax.jit(lambda v, a: jmodel.apply(
        v, a, False, method=JaxClassify.features))(jvars, jnp.asarray(clips)))
    with torch.no_grad():
        pfeat = model.features(torch.from_numpy(clips)).numpy()
    return dict(jm={k: float(v) for k, v in jm.items()},
                pm={k: float(v) for k, v in pm.items()}, jstate=jstate,
                state=state, params0=params0, jlogits=jlogits,
                plogits=plogits, jfeat=jfeat, pfeat=pfeat, name=name)


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


def test_features_match_jax(finetune_step):
    """The pre-head features (retrieval's): i3d's are L2-normalised, as
    JAX's ``features`` gives them; s3d's are not."""
    got, want = finetune_step["pfeat"], finetune_step["jfeat"]
    assert got.shape == (B, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    norms = np.linalg.norm(got, axis=-1)
    if finetune_step["name"].startswith("i3d"):
        np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
    else:
        assert not np.allclose(norms, 1.0, rtol=1e-3)


def test_i3d_conv_head_has_no_features():
    """The 'i3d_conv' head keeps its classifier inside the backbone: there
    is no pre-head feature, in either package."""
    model = CSTPClassify("i3d_byol", 1, N_CLASSES, head_style="i3d_conv",
                         dtype=torch.float32)
    assert not hasattr(model, "classify") and not hasattr(model, "cls_bn")
    with pytest.raises(ValueError, match="pre-head"):
        model.features(torch.zeros(1, 16, 224, 224, 3))
    cfg = Config(**_kw("i3d_byol", i3d_conv_head=1)).finalize()
    assert pft.create_classify_model(cfg, N_CLASSES, device="cpu"
                                     ).head_style == "i3d_conv"
    assert jft.create_classify_model(JaxConfig(**_kw(
        "i3d_byol", i3d_conv_head=1)).finalize(),
        N_CLASSES).head_style == "i3d_conv"


_JAX_PARAMS = {}


def _jax_classify_params(name, conv_head):
    """JAX's finetune parameter tree (``eval_shape``), once per model."""
    if (name, conv_head) not in _JAX_PARAMS:
        jcfg = JaxConfig(**_kw(name, i3d_conv_head=int(conv_head))).finalize()
        jmodel = jft.create_classify_model(jcfg, N_CLASSES)
        s, t = (224, 16) if conv_head else (S, T)
        _JAX_PARAMS[name, conv_head] = jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((2, t, s, s, 3)), train=True)
        )["params"]
    return _JAX_PARAMS[name, conv_head]


@pytest.mark.parametrize("idx", range(6))
@pytest.mark.parametrize("name, conv_head", [
    ("s3d_byol", False), ("i3d_byol", False), ("i3d_byol", True)],
    ids=["s3d", "i3d", "i3d-conv-head"])
def test_frozen_parameters_match_jax(name, conv_head, idx):
    """``ft_begin_index`` 0-5 freezes the same leaves as JAX's
    ``param_labels``. Index 1-4 names modules (``conv1``, ``conv{i}``)
    that exist on no s3d or i3d backbone, so only ``cls_bn`` freezes
    there; index 5 with ``--i3d_conv_head`` freezes I3D's stages and
    trains its internal classifier."""
    kw = _kw(name, task="scratch", ft_begin_index=idx,
             i3d_conv_head=int(conv_head))
    jcfg = JaxConfig(**kw).finalize()
    cfg = Config(**kw).finalize()
    want = jft.finetune_frozen_prefixes(jcfg)
    jlabels = _flat(jax_param_labels(_jax_classify_params(name, conv_head),
                                     want))
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
    if conv_head and idx == 5:
        assert [n for n, p in model.named_parameters() if p.requires_grad] \
            == ["online_net.conv3d_0c_1x1_custom.conv.weight"]


# ------------------------------------------------------------ importer

@pytest.mark.parametrize("arch, kind", [
    ("s3d_byol", "pretrain"), ("s3d_byol", "classify"),
    ("s3d_classify", "classify"), ("i3d_byol", "pretrain"),
    ("i3d_byol", "classify")])
def test_pth_export_and_load_match_jax(tmp_path, arch, kind):
    """A port model's weights exported as a reference ``.pth`` name the
    tensors JAX's exporter names from the same tree (S3D's ``blockN``
    aliases are not written, by either); laid over a port model from
    another seed, the file gives bitwise the weights it was written from."""
    gen = torch.Generator().manual_seed(4)
    if kind == "pretrain":
        model = create_pretrain_state(Config(**_kw(arch)).finalize(),
                                      seed=4, device="cpu")[0]
    else:
        head = "mlp" if arch.endswith("_classify") else "linear"
        model = CSTPClassify(arch, 1, N_CLASSES, head_style=head, gen=gen)
    tree = export_state_dict(model.state_dict())
    got = pti.export_torch_state_dict(tree, arch, ddp_prefix=True)
    want = jti.export_torch_state_dict(tree, arch, ddp_prefix=True)
    assert got.keys() == want.keys()
    assert not any(".block" in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = str(tmp_path / "save_1.pth")
    pti.save_torch_checkpoint(path, tree, arch)
    if kind == "pretrain":
        other = create_pretrain_state(Config(**_kw(arch)).finalize(),
                                      seed=5, device="cpu")[0]
    else:
        other = CSTPClassify(arch, 1, N_CLASSES, head_style=head,
                             gen=torch.Generator().manual_seed(5))
    init = {n: t.clone() for n, t in other.state_dict().items()}
    pti.load_into(other, pti.load_torch_checkpoint(path, arch)[0])
    mine = model.state_dict()
    head = [n for n in mine if n.startswith("classify.")]
    for n, t in other.state_dict().items():
        if arch == "s3d_classify" and n in head:
            # the MLP head's reference names classify.{0,1,3} map to no
            # module in either package: the model keeps its own head
            assert torch.equal(t, init[n]), n
        else:
            assert torch.equal(t, mine[n]), n
    if arch == "s3d_classify":
        assert any(not torch.equal(init[n], mine[n]) for n in head)
