"""The port's s8 storage chain (``--quant int8_store`` / ``int8_store_fz``
and the ``int8_store_calib`` bootstrap; ``cstp_tpu_torch/ops/quant.py``,
``models/layers.py SpatioTemporalConv``, ``train/pretrain.py``) against the
JAX package's, on the CPU. Inputs and weights are made from a seed with
numpy (the models' from the port's seeded init) and cross by
``models/bridge.py``.

Tolerances, and why:
- the s8 tensors of the chain: ``xq`` and ``hq`` bitwise (the same true
  division and round-half-even; the int conv is exact), ``yq`` equal but
  for at most 0.1% of its values, each off by exactly one (the port's BN
  moments come from exact integer sums, JAX's from f32 reductions: an ulp
  of ``y1`` moves a value that sits at half a step);
- the chain's output: bitwise where ``yq`` is, else within 1e-3 of its
  norm; the ``(G, M)`` moments within 1e-5 of ``mean^2 + var`` (JAX's own
  f32 rounding); the observations ``a_in``/``a_mid`` bitwise (maxima of
  the same values), ``a_act`` rtol 1e-6;
- the chain's gradients (bf16 conv VJPs at the same dequantized points,
  summed in other orders): cosine >= 0.999 and norm within 1e-2;
- the float chain: rtol 1e-5 of the output's range (f32 convs and BN
  reductions in other orders);
- the plain versions of K6's storage epilogue and of K7 against a float64
  evaluation: s8 values equal but for 1e-4 of them, off by one (the f32
  products round at ties that float64 does not), sums of the f32 values
  exact, maxima rtol 1e-6;
- whole models: every site quantizes three times, so an f32 rounding
  difference upstream flips round-half decisions that each move one value
  by a step, and at these random weights and 2 x 2 last positions the
  BatchNorm backward amplifies them: JAX's own int8_store step, with its
  input moved by 1e-7 relative, moves its loss by 0.4% and turns its
  update to cosine 0.60 (``test_torch_port_quant.py`` says the same of
  ``--quant int8``). The step tests therefore hold losses, scales,
  statistics and the update's norm to the percent, and the update's
  direction only against wrong modes; each test states its numbers.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

if __name__ != "__main__":      # the gloo ranks below import no JAX
    import jax
    import jax.numpy as jnp

    from cstp_tpu.config import Config as JaxConfig
    from cstp_tpu.ops import quant as jq

from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    load_jax_variables,
)
from cstp_tpu_torch.models.layers import (
    Conv3d,
    SpatioTemporalConv,
    r21d_intermediate_channels,
)
from cstp_tpu_torch.ops import quant as q

from _torch_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
B, T, S = 4, 4, 32
LR = 3e-4   # the Config default
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")
WORLD = 2
TIMEOUT_S = 120


@pytest.fixture
def tmp_path(tmp_path):
    """The test's own directory, removed when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _np(a):
    return np.asarray(jax.device_get(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oidhw(w):
    return _t(np.asarray(w).transpose(4, 3, 0, 1, 2))


# (id, kernel, stride, padding, Cin, Cout, T, H=W): the three site kinds of
# R(2+1)D, narrowed
GEOMETRIES = [
    ("block-3x3x3-s1", (3, 3, 3), (1, 1, 1), (1, 1, 1), 8, 16, 4, 8),
    ("stem-3x7x7-s122", (3, 7, 7), (1, 2, 2), (1, 3, 3), 3, 16, 4, 12),
    ("down-1x1x1-s222", (1, 1, 1), (2, 2, 2), (0, 0, 0), 8, 16, 4, 8),
]


def _chain_inputs(geom, seed=0, b=B):
    """numpy ``x``, DHWIO ``ws``/``wt``, ``gamma``, ``beta`` and the chain's
    stride/pad arguments."""
    _, k, stride, pad, cin, cout, t, s = geom
    mid = r21d_intermediate_channels(cin, cout, k)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, s, s, cin)).astype(np.float32)
    ws = (rng.normal(size=(1, k[1], k[2], cin, mid)) * 0.2).astype(np.float32)
    wt = (rng.normal(size=(k[0], 1, 1, mid, cout)) * 0.2).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=(mid,))).astype(np.float32)
    beta = (0.1 * rng.normal(size=(mid,))).astype(np.float32)
    args = ((1, stride[1], stride[2]), (0, pad[1], pad[2]),
            (stride[0], 1, 1), (pad[0], 0, 0))
    return (x, ws, wt, gamma, beta), args


def _port_args(inputs):
    x, ws, wt, gamma, beta = inputs
    return _t(x), _oidhw(ws), _oidhw(wt), _t(gamma), _t(beta)


def _jax_scales(inputs, args, groups):
    """The float chain's exact observations (JAX's), as f32 scalars."""
    *_, obs = jq.float_store_chain(*map(jnp.asarray, inputs), groups, *args,
                                   True, None, None, jnp.float32)
    return [np.float32(_np(a)) for a in obs]


def _off_by_one_share(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    return float((d > 0).mean())


# ------------------------------------------------------------ the chain

@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_int8_store_chain_forward_matches_jax(geom, groups):
    inputs, args = _chain_inputs(geom)
    scales = _jax_scales(inputs, args, groups)
    (jo, jres) = jq._store_chain_fwd_impl(
        *map(jnp.asarray, inputs), *map(jnp.float32, scales), *args, groups)
    po, (xq, hq, yq) = q._store_chain_forward(
        *_port_args(inputs), *map(torch.tensor, scales),
        q._geometry(*args), groups, True, False)
    np.testing.assert_array_equal(xq.numpy(), _np(jres[0]))
    np.testing.assert_array_equal(hq.numpy(), _np(jres[1]))
    assert _off_by_one_share(yq.numpy(), _np(jres[2])) <= 1e-3
    out, want = po[0].numpy(), _np(jo[0])
    if np.array_equal(yq.numpy(), _np(jres[2])):
        np.testing.assert_array_equal(out, want)
    assert np.linalg.norm(out - want) <= 1e-3 * np.linalg.norm(want)
    gmean, gvar, jmean, jvar = (po[1].numpy(), po[2].numpy(), _np(jo[1]),
                                _np(jo[2]))
    assert gmean.shape == gvar.shape == (groups, hq.shape[-1])
    atol = 1e-5 * float((jmean ** 2 + jvar).max())
    np.testing.assert_allclose(gmean, jmean, rtol=0, atol=atol)
    np.testing.assert_allclose(gvar, jvar, rtol=0, atol=atol)
    assert float(po[3]) == float(jo[3]) and float(po[4]) == float(jo[4])
    np.testing.assert_allclose(float(po[5]), float(jo[5]), rtol=1e-6)


def test_int8_store_chain_frozen_observes_nothing():
    """``observe=False`` (int8_store_fz): zeros for the observations, the
    same output and moments."""
    inputs, args = _chain_inputs(GEOMETRIES[0])
    scales = [torch.tensor(s) for s in _jax_scales(inputs, args, 2)]
    on = q.int8_store_chain(*_port_args(inputs), *scales, *args, 2)
    off = q.int8_store_chain(*_port_args(inputs), *scales, *args, 2,
                             observe=False)
    for a, b in zip(on[:3], off[:3]):
        assert torch.equal(a, b)
    assert all(float(a) == 0.0 for a in off[3:])
    assert all(float(a) > 0.0 for a in on[3:])


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_int8_store_chain_gradients_match_jax(geom):
    """The custom VJP's gradients to x, ws, wt, gamma and beta: the same
    straight-through bf16 conv VJPs, ReLU mask and grouped-BN three-term
    gradient (no gradient to the scales)."""
    inputs, args = _chain_inputs(geom, seed=1)
    scales = _jax_scales(inputs, args, 2)

    def probe(shape):
        return np.cos(np.arange(np.prod(shape))).reshape(shape).astype(
            np.float32)

    def loss_j(*a):
        out = jq.int8_store_chain(*a, *map(jnp.float32, scales), *args, 2)[0]
        return jnp.sum(out * probe(out.shape))

    want = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, inputs))
    leaves = [t.requires_grad_() for t in _port_args(inputs)]
    s_t = [torch.tensor(s, requires_grad=True) for s in scales]
    out = q.int8_store_chain(*leaves, *s_t, *args, 2)[0]
    (out * _t(probe(tuple(out.shape)))).sum().backward()
    assert all(s.grad is None for s in s_t)
    for name, p, w in zip(("x", "ws", "wt", "gamma", "beta"), leaves, want):
        got = p.grad.numpy()
        w = _np(w)
        if w.ndim == 5 and name != "x":
            w = w.transpose(4, 3, 0, 1, 2)
        assert _cos(got, w) >= 0.999, name
        assert abs(np.linalg.norm(got) / np.linalg.norm(w) - 1) <= 1e-2, name


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_float_store_chain_matches_jax(train):
    inputs, args = _chain_inputs(GEOMETRIES[1], seed=2)
    mid = inputs[1].shape[-1]
    rng = np.random.default_rng(3)
    ra_mean = (0.1 * rng.normal(size=(mid,))).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, (mid,)).astype(np.float32)
    jo = jq.float_store_chain(*map(jnp.asarray, inputs), 2, *args, train,
                              jnp.asarray(ra_mean), jnp.asarray(ra_var),
                              jnp.float32)
    po = q.float_store_chain(*_port_args(inputs), 2, *args, train,
                             _t(ra_mean), _t(ra_var), torch.float32)
    want = _np(jo[0])
    np.testing.assert_allclose(po[0].numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if train:
        np.testing.assert_allclose(po[1].numpy(), _np(jo[1]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(po[2].numpy(), _np(jo[2]), rtol=1e-5,
                                   atol=1e-6)
    else:
        assert po[1] is None and po[2] is None
    for a, b in zip(po[3], jo[3]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


# ------------------------------------------------------------ plain versions

@pytest.mark.parametrize("observe", [True, False])
@pytest.mark.parametrize("geom", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_storage_epilogue_plain_matches_float64(geom, observe):
    """K6's storage epilogue, plain version: the s8 mid against a float64
    dequantize-and-requantize of the exact accumulator, its sums exact, its
    absmax, and the group moments ``store_moments`` forms from the sums
    against float64 moments of ``hq * s_mid``."""
    _, k, stride, pad, cin, cout, t, s = geom
    rng = np.random.default_rng(4)
    xq = _t(rng.integers(-127, 128, (B, t, s, s, cin)).astype(np.int8))
    wq = _t(rng.integers(-127, 128, (cout, cin, 1, k[1], k[2])).astype(
        np.int8))
    scale = _t((rng.uniform(0.5, 2.0, cout) * 1e-4).astype(np.float32))
    s_mid = torch.tensor(np.float32(0.02))
    args = ([1, stride[1], stride[2]], [0, pad[1], pad[2]],
            [0, pad[1], pad[2]])
    hq, sums, sq_sums, amax = q.int8_conv3d_store(xq, wq, scale, s_mid,
                                                  *args, observe)
    acc = q.int8_conv3d_acc_plain(xq, wq, *args).double()
    h64 = acc * scale.double()
    hq64 = torch.clamp(torch.round(h64 / float(s_mid)), -127, 127)
    assert hq.dtype == torch.int8
    assert _off_by_one_share(hq.numpy(), hq64.numpy().astype(np.int8)) \
        <= 1e-4
    hl = hq.double()
    assert torch.equal(sums, hl.sum((1, 2, 3)).long())
    assert torch.equal(sq_sums, hl.square().sum((1, 2, 3)).long())
    if observe:
        np.testing.assert_allclose(float(amax), float(h64.abs().max()),
                                   rtol=1e-6)
    else:
        assert float(amax) == 0.0
    gmean, gvar = q.store_moments(sums, sq_sums, hq[0, ..., 0].numel(),
                                  s_mid, 2)
    hh = (hl * float(s_mid)).reshape(2, -1, cout)
    np.testing.assert_allclose(gmean.numpy(), hh.mean(1).numpy(),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(gvar.numpy(), hh.var(1, unbiased=False)
                               .numpy(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("observe", [True, False])
def test_bn_relu_requant_plain_matches_float64(observe):
    """K7's plain version against the same formula in float64."""
    rng = np.random.default_rng(5)
    n, m = 4, 23
    hq = _t(rng.integers(-127, 128, (n, 3, 5, 5, m)).astype(np.int8))
    s_mid, s_act = torch.tensor(np.float32(0.013)), torch.tensor(
        np.float32(0.021))
    mean = _t((0.1 * rng.normal(size=(n, m))).astype(np.float32))
    inv = _t(rng.uniform(0.5, 2.0, (n, m)).astype(np.float32))
    gamma = _t((1 + 0.2 * rng.normal(size=(m,))).astype(np.float32))
    beta = _t((0.2 * rng.normal(size=(m,))).astype(np.float32))
    yq, amax = q.bn_relu_requant(hq, s_mid, mean, inv, gamma, beta, s_act,
                                 observe)
    bs = (n, 1, 1, 1, m)
    y64 = torch.relu((hq.double() * float(s_mid) - mean.double().reshape(bs))
                     * inv.double().reshape(bs) * gamma.double()
                     + beta.double())
    yq64 = torch.clamp(torch.round(y64 / float(s_act)), -127, 127)
    assert yq.dtype == torch.int8 and int(yq.min()) >= 0
    assert _off_by_one_share(yq.numpy(), yq64.numpy().astype(np.int8)) \
        <= 1e-4
    if observe:
        np.testing.assert_allclose(float(amax), float(y64.max()), rtol=1e-6)
    else:
        assert float(amax) == 0.0


# ------------------------------------------------------------ the layer

def _jax_layer(quant, groups, geom):
    from cstp_tpu.models.layers import SpatioTemporalConv as JaxSTConv

    _, k, stride, pad, _, cout, _, _ = geom
    return JaxSTConv(cout, k, stride, pad, dtype=jnp.float32,
                     bn_groups=groups, quant=quant)


def _port_layer(quant, groups, geom, seed=0):
    _, k, stride, pad, cin, cout, _, _ = geom
    return SpatioTemporalConv(cin, cout, k, stride, pad, dtype=torch.float32,
                              bn_groups=groups, quant=quant,
                              gen=torch.Generator().manual_seed(seed))


def _calibrated(layer, x):
    """``layer``'s scales raised by one int8_store_calib pass over ``x``
    (the running statistics then put back)."""
    sd = {k: v.clone() for k, v in layer.state_dict().items()}
    mode, layer.quant = layer.quant, "int8_store_calib"
    with torch.no_grad():
        layer(x, True)
    layer.quant = mode
    for k in ("act_scale_in", "act_scale_mid", "act_scale_act"):
        sd[k] = getattr(layer, k).clone()
    layer.load_state_dict(sd)
    return layer


@pytest.mark.parametrize("mode", ["int8_store", "int8_store_fz",
                                  "int8_store_calib", "eval"])
def test_spatiotemporal_conv_modes_match_jax(mode):
    """The layer in each mode (eval: an int8_store layer in eval mode)
    against JAX's on the same variables: the output and every batch-stats
    leaf afterwards."""
    geom = GEOMETRIES[0]
    quant = "int8_store" if mode == "eval" else mode
    train = mode != "eval"
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, *geom[6:7], geom[7], geom[7], geom[4])).astype(
        np.float32)
    layer = _port_layer(quant, 2, geom)
    if mode != "int8_store_calib":
        _calibrated(layer, _t(x * 1.5))
    params, stats = export_jax_variables(layer)
    want, mut = _jax_layer(quant, 2, geom).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=train, mutable=["batch_stats"])
    with torch.no_grad():
        got = layer(_t(x), train)
    want = _np(want)
    assert np.linalg.norm(got.numpy() - want) <= 1e-3 * np.linalg.norm(want)
    _, got_stats = export_jax_variables(layer)
    flat_w = jax.tree_util.tree_flatten_with_path(mut["batch_stats"])[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got_stats)[0])
    assert len(flat_w) == len(flat_g) == 5
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], _np(w), rtol=1e-5,
                                   atol=1e-7, err_msg=str(path))
    scales = [float(getattr(layer, f"act_scale_{k}"))
              for k in ("in", "mid", "act")]
    assert all(s > 0 for s in scales)
    if mode in ("int8_store_fz", "eval"):
        assert scales == [float(stats[f"act_scale_{k}"])
                          for k in ("in", "mid", "act")]


def test_store_sites_keep_the_float_parameters_and_add_three_buffers():
    """Checkpoints interchange with the float block: the same parameters;
    the three scales (zero at init) are buffers, and the convs are float
    ``Conv3d`` (which refuses the chain's modes)."""
    geom = GEOMETRIES[0]
    fl, st = _port_layer("", 1, geom), _port_layer("int8_store", 1, geom)
    assert ([(n, p.shape) for n, p in fl.named_parameters()]
            == [(n, p.shape) for n, p in st.named_parameters()])
    extra = set(dict(st.named_buffers())) - set(dict(fl.named_buffers()))
    assert extra == {"act_scale_in", "act_scale_mid", "act_scale_act"}
    assert all(float(getattr(st, n)) == 0.0 for n in extra)
    assert st.spatial_conv.quant == st.temporal_conv.quant == ""
    for mode in q.STORE_MODES:
        with pytest.raises(ValueError):
            Conv3d(4, 4, 1, quant=mode)


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("mode", ["int8_store", "int8_store_fz"])
def test_config_takes_the_storage_chain(mode):
    """What JAX builds, the port builds: both r21d names, a training task
    and an eval task."""
    for kw in (dict(model_name="r21d_byol"), dict(model_name="r21d"),
               dict(model_name="r21d", task="test")):
        JaxConfig(quant=mode, **kw).finalize()
        Config(quant=mode, **kw).finalize()


@pytest.mark.parametrize("mode", ["int8_store", "int8_store_fz"])
@pytest.mark.parametrize("flag", [dict(model_name="c3d"),
                                  dict(s2d_stem=True), dict(t_fold=True),
                                  dict(fused_conv=1)],
                         ids=["non-r21d", "s2d_stem", "t_fold",
                              "fused_conv"])
def test_config_refuses_what_jax_refuses(mode, flag):
    for cls in (JaxConfig, Config):
        with pytest.raises(ValueError):
            cls(quant=mode, **flag).finalize()


def test_training_steps_refuse_non_r21d_storage_chains():
    """The step factories' guard for a config that skipped ``finalize``,
    as JAX's ``_check_trainable_quant``."""
    from cstp_tpu.train.pretrain import _check_trainable_quant
    from cstp_tpu_torch.train.finetune import make_finetune_step
    from cstp_tpu_torch.train.pretrain import make_pretrain_step

    cfg = dict(model_name="c3d", quant="int8_store")
    with pytest.raises(ValueError, match="r21d factorized chain"):
        _check_trainable_quant(JaxConfig(**cfg), "pretrain")
    for build in (make_pretrain_step, make_finetune_step):
        with pytest.raises(ValueError, match="r21d factorized chain"):
            build(None, None, Config(**cfg))


# ------------------------------------------------------------ the step

def _view(rng, b=B):
    noise = rng.uniform(-1, 1, (b, T, S, S, 3))
    off = rng.uniform(-0.8, 0.8, (b, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (b, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def _labels(rng, b=B):
    out = {k: rng.integers(0, 5, (b,)).astype(np.int32)
           for k in ("spa", "tem", "pb")}
    out.update(rot1=rng.integers(0, 4, (b,)).astype(np.int32),
               rot2=rng.integers(0, 4, (b,)).astype(np.int32))
    return out


def _step_kw(**over):
    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              quant="int8_store", weight_decay=0.0)
    kw.update(over)
    return kw


def _views_augment(module, views, spa, convert):
    """``module._build_pretrain_programs`` with its augment replaced by one
    that hands out ``views`` in turn: the step factory's own bootstrap and
    train program then run on the same views in both packages."""
    real = module._build_pretrain_programs

    def build(*a, **k):
        _, train = real(*a, **k)
        calls = []

        def augment(gen, f1, f2, r1, r2):
            v1, v2 = views[len(calls)]
            calls.append(1)
            return convert(v1), convert(v2), convert(spa)

        return augment, train

    return build


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def store_steps():
    """Three ``make_pretrain_step`` steps with ``--quant int8_store`` in
    both packages (R(2+1)D depth 1, 4 x 32^2, float32, no weight decay;
    the setting of ``tests/test_quant.py
    test_int8_store_pretrain_bootstraps_and_trains``), from the port's
    initial weights (JAX's ``init`` returns them) and the same views: the
    step factories' own bootstrap runs on the first. Also the port's
    ``int8_store_fz`` and float steps from the same weights."""
    import cstp_tpu.train.pretrain as jpre
    from cstp_tpu.ssl.byol import CSTPPretrain as JaxPretrain

    import cstp_tpu_torch.train.pretrain as ppre

    rng = np.random.default_rng(7)
    views = [(_view(rng), _view(rng)) for _ in range(3)]
    labels = _labels(rng)
    kw = _step_kw()
    cfg = Config(**kw).finalize()
    model, _, _ = ppre.create_pretrain_state(cfg, device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    params0, stats0 = jax.tree_util.tree_map(np.copy,
                                             export_jax_variables(model))
    jcfg = JaxConfig(**kw).finalize()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPretrain, "init", lambda self, *a, **k: {
            "params": params0, "batch_stats": stats0})
        jmodel, jstate, jtx = jpre.create_pretrain_state(
            jcfg, jax.random.PRNGKey(0))
        mp.setattr(jpre, "_build_pretrain_programs",
                   _views_augment(jpre, views, labels["spa"], jnp.asarray))
        jstep = jpre.make_pretrain_step(jmodel, jtx, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in labels.items()}
    jbatch.update(frames1=None, frames2=None)
    jm = []
    for i in range(3):
        jstate, m = jstep(jstate, jax.random.PRNGKey(i), jbatch,
                          jnp.float32(jcfg.learning_rate))
        jm.append({k: float(v) for k, v in m.items()})

    tbatch = {k: _t(v) for k, v in labels.items()}
    tbatch.update(frames1=None, frames2=None)

    def port(bootstrap=True, **over):
        c = Config(**_step_kw(**over)).finalize()
        m, st, tx = ppre.create_pretrain_state(c, device="cpu")
        m.load_state_dict({k: v for k, v in init.items()
                           if k in m.state_dict()})
        metrics, scales = [], []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ppre, "_build_pretrain_programs",
                       _views_augment(ppre, views, labels["spa"], _t))
            if not bootstrap:
                mp.setattr(ppre, "bootstrap_store_scales", lambda *a: 0)
            step = ppre.make_pretrain_step(m, tx, c)
            for _ in range(3):
                st, met = step(st, None, tbatch, jcfg.learning_rate)
                metrics.append({k: float(v) for k, v in met.items()})
                scales.append({n: b.clone() for n, b in m.named_buffers()
                               if "act_scale" in n})
        params, stats = export_jax_variables(m)
        return dict(metrics=metrics, scales=scales, params=_flat(params),
                    stats=_flat(stats), model=m)

    return dict(jax=dict(metrics=jm, params=_flat(jstate.params),
                         stats=_flat(jstate.batch_stats)),
                port=port(), fz=port(quant="int8_store_fz"),
                float=port(quant=""), unseeded=port(bootstrap=False),
                params0=_flat(params0))


def test_store_steps_losses_match_jax(store_steps):
    """Loss terms: the first step's (the bootstrap, then the first int8
    step) rtol 1e-2 (0.3% when written), all three rtol 5e-2 (2% when
    written; JAX's own first step moves its loss by 0.4% when its input
    moves by 1e-7 relative, and the flips compound over the steps)."""
    jm, pm = store_steps["jax"]["metrics"], store_steps["port"]["metrics"]
    for i, (j, p) in enumerate(zip(jm, pm)):
        assert p.keys() == j.keys()
        for k, v in j.items():
            assert np.isfinite(p[k]), k
            if k.startswith("loss"):
                np.testing.assert_allclose(p[k], v, rtol=1e-2 if i == 0
                                           else 5e-2, err_msg=(i, k))


def test_store_steps_batch_stats_match_jax(store_steps):
    """Every ``act_scale_*`` leaf (72: 12 sites x 3 x 2 towers) and every
    running statistic after the bootstrap and three steps: running
    statistics within 10% of the leaf's largest value, scales within 15%
    of JAX's (7% at most when written) and their median within 2% (0.6%
    when written)."""
    want, got = store_steps["jax"]["stats"], store_steps["port"]["stats"]
    assert want.keys() == got.keys()
    rel = []
    for k, w in want.items():
        err = np.abs(got[k] - w).max() / np.abs(w).max()
        if "act_scale_" in k:
            assert float(got[k]) > 0 and err <= 0.15, k
            rel.append(err)
        else:
            assert err <= 0.1, k
    assert len(rel) == 72 and np.median(rel) <= 0.02


def test_store_steps_update_matches_jax(store_steps):
    """The trainable parameters' update over the three steps (no weight
    decay): its norm within 5% of JAX's (2.5% when written), and its
    direction nearer JAX's than the float steps' and than the same steps
    without the bootstrap (cosine 0.41 against 0.18 and -0.03 when
    written). The direction is no tighter: JAX's own one-step update turns
    to cosine 0.60 when its input moves by 1e-7 relative (the round-half
    flips of the loss test, through the BatchNorm backward of 2 x 2
    positions)."""
    p0 = store_steps["params0"]
    keys = [k for k in p0 if "target_net" not in k]

    def update(run):
        params = store_steps[run]["params"]
        return np.concatenate([(params[k].astype(np.float64) - p0[k])
                               .ravel() for k in keys])

    want, got = update("jax"), update("port")
    assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1) <= 5e-2
    cos = _cos(got, want)
    assert cos > max(_cos(update("float"), want),
                     _cos(update("unseeded"), want))


def test_store_steps_bootstrap_then_decayed_maxima(store_steps):
    """After the bootstrap every scale is positive; int8_store then moves
    each to ``max(0.999 * scale, observation)``, int8_store_fz keeps the
    bootstrap's scales through every step."""
    for run in ("port", "fz"):
        for s in store_steps[run]["scales"]:
            assert len(s) == 72 and all(float(v) > 0 for v in s.values())
    fz = store_steps["fz"]["scales"]
    for later in fz[1:]:
        assert all(torch.equal(later[k], fz[0][k]) for k in fz[0])
    obs = store_steps["port"]["scales"]
    for a, b in zip(obs, obs[1:]):
        assert all(float(b[k]) >= float(q.STORE_DECAY * a[k]) for k in a)
        assert any(not torch.equal(b[k], a[k]) for k in a)


def test_quant_scope_target_runs_the_chain_in_the_target_tower_only():
    from cstp_tpu_torch.train.pretrain import (
        bootstrap_store_scales,
        create_pretrain_model,
    )

    m = create_pretrain_model(Config(**_step_kw(quant_scope="target"))
                              .finalize(), device="cpu")
    sites = {n: t.quant for n, t in m.named_modules()
             if isinstance(t, SpatioTemporalConv)}
    assert {v for k, v in sites.items() if k.startswith("online")} == {""}
    assert {v for k, v in sites.items()
            if k.startswith("target")} == {"int8_store"}
    assert not any("online" in n for n, _ in m.named_buffers()
                   if "act_scale" in n)
    rng = np.random.default_rng(8)
    v1, v2 = _t(_view(rng)), _t(_view(rng))
    assert bootstrap_store_scales(m, v1, v2) == 12
    assert all(t.quant == "int8_store" for t in m.target_net.modules()
               if isinstance(t, SpatioTemporalConv))
    scales = [float(b) for n, b in m.named_buffers() if "act_scale" in n]
    assert len(scales) == 36 and all(s > 0 for s in scales)


def test_remat_recompute_sees_the_forwards_scales():
    """Under ``--remat`` the recompute quantizes at the scales the forward
    used, not the ones it left, and advances nothing: the step is bitwise
    the step without remat, scales and running statistics too."""
    from cstp_tpu_torch.train.pretrain import (
        bootstrap_store_scales,
        create_pretrain_state,
        make_preaugmented_step,
    )

    rng = np.random.default_rng(9)
    batch = {**_labels(rng), "view1": _view(rng), "view2": _view(rng)}
    tb = tuple(_t(batch[k]) for k in KEYS)
    out = {}
    for remat in (False, True):
        cfg = Config(**_step_kw(remat=remat)).finalize()
        m, st, tx = create_pretrain_state(cfg, device="cpu")
        bootstrap_store_scales(m, tb[0], tb[1])
        step = make_preaugmented_step(m, tx, cfg)
        st, met = step(st, dict(zip(KEYS, tb)), 0.03)
        out[remat] = (met, m.state_dict())
    for k, v in out[False][0].items():
        assert torch.equal(out[True][0][k], v), k
    for k, v in out[False][1].items():
        assert torch.equal(out[True][1][k], v), k


def test_fresh_finetune_step_quantizes_at_the_floor(monkeypatch):
    """JAX's ``make_finetune_step`` has no bootstrap: a fresh int8_store
    finetune's first step quantizes at the 1e-6 floor, and then the
    scales are the step's observations."""
    import cstp_tpu_torch.models.layers as L
    from cstp_tpu_torch.train import finetune as ft

    seen = []
    real = L.int8_store_chain

    def spy(x, ws, wt, gamma, beta, s_in, s_mid, s_act, *a, **k):
        seen.append([float(s) for s in (s_in, s_mid, s_act)])
        return real(x, ws, wt, gamma, beta, s_in, s_mid, s_act, *a, **k)

    monkeypatch.setattr(L, "int8_store_chain", spy)
    cfg = Config(**_step_kw(task="ft_all", batch_size=2)).finalize()
    model, state, tx = ft.create_finetune_state(cfg, 5, device="cpu")
    step = ft.make_finetune_step(model, tx, cfg)
    rng = np.random.default_rng(10)
    batch = dict(frames=_t(rng.integers(0, 256, (2, T, 40, 48, 3)).astype(
        np.uint8)), labels=_t(np.array([1, 3])))
    state, _ = step(state, torch.Generator().manual_seed(0), batch, 0.01)
    assert len(seen) == 12
    assert all(s == [float(np.float32(1e-6))] * 3 for s in seen)
    scales = [float(b) for n, b in model.named_buffers() if "act_scale" in n]
    assert len(scales) == 36 and all(s > 0 for s in scales)


# ------------------------------------------------------------ checkpoints

def test_bridge_and_checkpoint_carry_the_scales(tmp_path):
    """``act_scale_{in,mid,act}`` cross the bridge both ways bitwise, as
    JAX's batch-stats leaves of the same names, and a pretrain checkpoint
    gives a finetune model its online tower's scales."""
    from cstp_tpu.ssl.byol import CSTPPretrain as JaxPretrain

    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.train import finetune as ft
    from cstp_tpu_torch.train.pretrain import create_pretrain_state

    cfg = Config(**_step_kw()).finalize()
    model, state, _ = create_pretrain_state(cfg, device="cpu")
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for n, b in model.named_buffers():
            if "act_scale" in n:
                b.copy_(torch.tensor(np.float32(rng.uniform(0.01, 0.1))))
    params, stats = export_jax_variables(model)
    # JAX's own tree for this config has exactly these leaves
    jmodel = JaxPretrain(backbone="r21d", depth=1, dtype=jnp.float32,
                         bn_groups=1, quant="int8_store")
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((B, T, S, S, 3)),
                            jnp.zeros((B, T, S, S, 3)), train=True))
    assert (jax.tree_util.tree_structure(shapes["batch_stats"])
            == jax.tree_util.tree_structure(stats))
    again, _, _ = create_pretrain_state(cfg, seed=1, device="cpu")
    load_jax_variables(again, params, stats)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    path = ckpt_lib.save_checkpoint(str(tmp_path / "save_1"),
                                    ckpt_lib.state_tree(state),
                                    meta={"arch": cfg.arch})
    fcfg = Config(**_step_kw(task="ft_all")).finalize()
    fmodel, fstate, _ = ft.create_finetune_state(fcfg, 5, device="cpu")
    ckpt_lib.load_pretrained(fstate, path, fcfg)
    got = {n: b for n, b in fmodel.named_buffers() if "act_scale" in n}
    assert len(got) == 36
    for n, b in got.items():
        assert torch.equal(b, model.state_dict()[n]), n


# ------------------------------------------------------------ ranks

def _trainable_update(sd, sd0):
    """The step's update of the trainable parameters (the target tower
    moves by the EMA alone), flat, float64."""
    return torch.cat([(sd[k] - sd0[k]).double().flatten() for k in sd0
                      if not k.endswith(("mean", "var"))
                      and "act_scale" not in k and "target_net" not in k])


def _rank_step(sd, batch):
    """The bootstrap and one int8_store pretrain step on ``batch`` (this
    process's rows) from ``sd``: the scales the bootstrap set, the step's
    metrics and the state dict after it."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train.pretrain import (
        bootstrap_store_scales,
        create_pretrain_state,
        make_preaugmented_step,
    )

    cfg = Config(**_step_kw()).finalize()
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    model.load_state_dict(sd)
    mesh.replicate(model)
    bootstrap_store_scales(model, batch["view1"], batch["view2"])
    boot = {n: b.clone() for n, b in model.named_buffers()
            if "act_scale" in n}
    state, met = make_preaugmented_step(model, tx, cfg)(state, batch, LR)
    return dict(boot=boot, metrics={k: float(v) for k, v in met.items()},
                sd={k: v.clone() for k, v in model.state_dict().items()})


def _chain_run(inp, rows, cross_rank, observe):
    """The stride-1 chain (2 BN groups) on ``rows`` of the input, with the
    probe's rows as the output's gradient: outputs, moments, observations
    and the gradients to x and ws."""
    x = inp["x"][rows].requires_grad_()
    ws = inp["ws"].detach().requires_grad_()
    out = q.int8_store_chain(x, ws, *inp["rest"], *inp["args"], 2, observe,
                             cross_rank)
    (out[0] * inp["probe"][rows]).sum().backward()
    return dict(out=out[0].detach(), moments=torch.stack(out[1:3]),
                obs=torch.stack(out[3:]), dx=x.grad, dws=ws.grad)


def _rows(r, b, world=WORLD):
    """Rank r's rows of a two-view batch of b rows per view."""
    n = b // world
    return torch.cat([torch.arange(r * n, (r + 1) * n),
                      b + torch.arange(r * n, (r + 1) * n)])


def _worker(store: str, tmp: str) -> None:
    from cstp_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.maybe_initialize_distributed(init_method=f"file://{store}",
                                      device="cpu")
    inp = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
    rows = {k: mesh.shard_rows(v) for k, v in inp["batch"].items()}
    out = dict(step=_rank_step(inp["sd"], rows))
    for observe in (True, False):
        out[observe] = _chain_run(inp["chain"], _rows(mesh.rank(), B), True,
                                  observe)
    torch.save(out, Path(tmp) / f"out_{mesh.rank()}.pt")
    mesh.shutdown()


def test_two_gloo_ranks_match_one_process(tmp_path):
    """Two gloo ranks under ``--sync_bn 1`` (global batch 4 per view, 2 on
    each rank) against one process on the global batch.

    The chain alone, observing (int8_store) and not (int8_store_fz): its
    moments come from int64 sums all-reduced exactly and its observations
    from maxima over the ranks, so the ranks' outputs, moments and
    observations are bitwise one process's, and the gradients (the
    three-term BN gradient's group means over the ranks) agree within the
    bf16 VJPs' rounding: cosine 0.999, norm 1e-2.

    The int8_store step (bootstrap and one step): the two ranks end bitwise
    equal; the bootstrap's scales, the float chain's maxima, are one
    process's to rtol 1e-5 (the float BatchNorms' cross-rank moments round
    otherwise). Those roundings flip round-half decisions of the int8
    sites downstream, so the rest is held as the JAX comparison above is:
    losses rtol 2e-2, statistics and the scales after the step within 10%
    of each leaf's largest value, the trainable update's norm within
    5%."""
    from cstp_tpu_torch.train.pretrain import create_pretrain_model

    rng = np.random.default_rng(12)
    batch = {**_labels(rng), "view1": _view(rng), "view2": _view(rng)}
    batch = {k: _t(v) for k, v in batch.items()}
    sd = create_pretrain_model(Config(**_step_kw()).finalize(),
                               device="cpu").state_dict()
    inputs, args = _chain_inputs(GEOMETRIES[0], seed=13, b=2 * B)
    x, ws, *rest = _port_args(inputs)
    chain = dict(x=x, ws=ws, rest=rest + [torch.tensor(np.float32(v)) for v
                                          in (0.03, 0.05, 0.03)],
                 args=args, probe=_t(np.random.default_rng(14).normal(
                     size=(2 * B, 4, 8, 8, 16)).astype(np.float32)))
    torch.save(dict(sd=sd, batch=batch, chain=chain), tmp_path / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CSTP_", "MASTER_"))}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp_path / "store"), str(tmp_path)],
        env=dict(env, RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        want = _rank_step(sd, batch)
        one = {observe: _chain_run(chain, torch.arange(2 * B), False,
                                   observe) for observe in (True, False)}
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    ranks = [torch.load(tmp_path / f"out_{r}.pt", weights_only=False)
             for r in range(WORLD)]

    order = torch.argsort(torch.cat([_rows(r, B) for r in range(WORLD)]))
    for observe, one_chain in one.items():
        got = torch.cat([rk[observe]["out"] for rk in ranks])[order]
        assert torch.equal(got, one_chain["out"]), observe
        got = torch.cat([rk[observe]["dx"] for rk in ranks])[order]
        assert _cos(got.numpy(), one_chain["dx"].numpy()) >= 0.999
        assert abs(got.norm() / one_chain["dx"].norm() - 1) <= 1e-2
        for k in ("moments", "obs"):
            for rk in ranks:
                assert torch.equal(rk[observe][k], one_chain[k]), (observe,
                                                                   k)
        dws = sum(rk[observe]["dws"] for rk in ranks)
        assert _cos(dws.numpy(), one_chain["dws"].numpy()) >= 0.999
        assert abs(dws.norm() / one_chain["dws"].norm() - 1) <= 1e-2
    assert not one[False]["obs"].any()

    got = ranks[0]["step"]
    for k, v in ranks[1]["step"]["sd"].items():
        assert torch.equal(v, got["sd"][k]), k
    assert len(want["boot"]) == 72
    for k, v in want["boot"].items():
        assert float(v) > 0, k
        torch.testing.assert_close(got["boot"][k], v, rtol=1e-5, atol=0,
                                   msg=k)
    for k, v in want["metrics"].items():
        if k.startswith("loss"):
            np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-2,
                                       err_msg=k)
    for k, v in want["sd"].items():
        if k.endswith(("mean", "var")) or "act_scale" in k:
            err = (got["sd"][k] - v).abs().max() / v.abs().max()
            assert err <= 0.1, k
    norms = [_trainable_update(r["sd"], sd).norm() for r in (got, want)]
    assert abs(norms[0] / norms[1] - 1) <= 5e-2


# ------------------------------------------------------------ the CLI

def test_main_byol_int8_store_epoch(tmp_path):
    """One synthetic ``main_byol --quant int8_store`` epoch through the
    CLI: finite CSV rows, a checkpoint holding the 72 positive scales."""
    from cstp_tpu_torch.cli import main_byol

    out = main_byol.main([
        "--model_name", "r21d_byol", "--model_depth", "1", "--quant",
        "int8_store", "--data_backend", "synthetic", "--synthetic_len", "8",
        "--dataset", "UCF101", "--sample_duration", str(T),
        "--sample_size", str(S), "--compute_dtype", "float32",
        "--n_workers", "2", "--result_path", str(tmp_path), "--log_every",
        "0", "--batch_size", "4", "--n_epochs", "1", "--steps_per_epoch",
        "2", "--ckpt_every_epochs", "1"], device="cpu")
    assert len(out["history"]) == 1
    assert all(np.isfinite(v) for v in out["history"][0].values())
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib

    tree, _ = ckpt_lib.restore_checkpoint(
        str(tmp_path / "UCF101" / "loss_com" / "save_1"))
    scales = [v for k, v in tree["model"].items() if "act_scale" in k]
    assert len(scales) == 72 and all(float(v) > 0 for v in scales)


@pytest.mark.parametrize("argv", [
    ["--mode", "eval", "--quant", "int8_store"],
    ["--mode", "serve", "--quant", "int8_store_fz"],
    ["--mode", "pretrain", "--quant", "int8_static"]])
def test_bench_step_takes_the_chain_on_pretrain_only(argv):
    """``bench_step --quant int8_store[_fz]`` is bench.py's pretrain
    flag; with another mode, as int8_static with pretrain, it refuses."""
    from cstp_tpu_torch.perf import bench_step

    with pytest.raises(SystemExit):
        bench_step.main([*argv, "--device", "cpu"])


@pytest.mark.parametrize("layer_sizes, n, t, s", [((1, 1, 1, 1), 2, 4, 32),
                                                  ((2, 2, 2, 2), 1, 8, 48)])
def test_chain_sites_are_the_towers_sites(layer_sizes, n, t, s):
    """``models/r21d.py chain_sites`` (the card checks' and phase 20's
    shapes) lists every (2+1)D site of a tower with the input it sees."""
    from cstp_tpu_torch.models.r21d import R2Plus1DNet, chain_sites

    model = R2Plus1DNet(layer_sizes, dtype=torch.float32)
    seen = {}
    for name, m in model.named_modules():
        if isinstance(m, SpatioTemporalConv):
            m.register_forward_pre_hook(
                lambda m, a, name=name: seen.__setitem__(name, (
                    tuple(a[0].shape), m.temporal_conv.weight.shape[0],
                    m.kernel, m.stride, m.padding)))
    with torch.no_grad():
        model(torch.zeros(n, t, s, s, 3), True)
    sites = chain_sites(n, t, s, layer_sizes)
    assert {name: rest for name, *rest in sites} == {
        k: list(v) for k, v in seen.items()}
    assert len(sites) == len(seen)


def test_no_kernel_launches_on_the_cpu():
    """CPU tensors take the plain versions: no launch is counted."""
    from cstp_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    inputs, args = _chain_inputs(GEOMETRIES[0])
    scales = [torch.tensor(s) for s in _jax_scales(inputs, args, 1)]
    q.int8_store_chain(*_port_args(inputs), *scales, *args, 1)
    counts = launch_counts()
    assert counts["int8_conv_store"] == counts["int8_bn_relu"] == 0
    assert not any(counts.values())


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(*sys.argv[1:3])
