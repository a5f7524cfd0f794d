"""The port's int8 quantization (``cstp_tpu_torch/ops/quant.py``, ``--quant
int8 / int8_fixed / int8_static / int8_calib``) against the JAX package's,
on the CPU. Inputs are made from a seed with numpy; JAX configs that build
``int8_static`` or ``int8_calib`` use ``task="test"`` (``finalize()``
refuses them on the default training task).

Tolerances:
- the dynamic activation scale and quantize (``activation_absmax_scale``,
  ``quantize_with_scale``), ``quantize_weight`` and the int8 conv's int32
  accumulator: bitwise (the quantize is one true division and a
  round-half-even, the conv's integer sums are exact);
- the dequantized output: within one bf16 ulp of the output's magnitude in
  bf16, bitwise in float32 (the same f32 scale product and one rounding);
- the straight-through gradients: within bf16 tolerance (both evaluate the
  bf16 conv's VJP at the same dequantized point; the float convs'
  summation orders differ);
- ``Conv3d`` in each mode and the R(2+1)D ``CSTPClassify``'s int8_static
  logits: rtol 1e-4 / atol 1e-4 of the logits' scale (float32 activations
  between the int8 convs; a rounding tie flipped by the other side's
  summation order moves one quantized value by one step);
- calibrated scales: rtol 1e-5 (a maximum of float32 activations);
- the ``--quant int8`` pretrain step's loss terms: rtol 2e-2 (the test
  says why); its update's int8 effect (the update less the float step's):
  cosine >= 0.55 to JAX's, and nearer it than a wrong mode's.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.models.layers import Conv3d as JaxConv3d
from cstp_tpu.ops import quant as jq
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    load_jax_variables,
)
from cstp_tpu_torch.models.layers import Conv3d
from cstp_tpu_torch.ops import quant as q

from _torch_threads import torch_threads  # noqa: F401

T, S, B = 4, 32, 4


@pytest.fixture
def tmp_path(tmp_path):
    """The test's own directory, removed when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _np(a):
    return np.asarray(jax.device_get(a))


def _dhwio_to_oidhw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


def test_quantize_tensor_and_weight_match_jax_bitwise():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 4, 9, 9, 7)) * 3).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 7, 11)) * 0.1).astype(np.float32)
    xq_j, sx_j = jq._quantize_tensor(jnp.asarray(x))
    # the dynamic scale as the model takes it (``Conv3d``) and quantizes at
    sx = q.activation_absmax_scale(torch.from_numpy(x))
    xq = q.quantize_with_scale(torch.from_numpy(x), sx)
    assert xq.dtype == torch.int8
    np.testing.assert_array_equal(xq.numpy(), _np(xq_j))
    assert float(sx) == float(sx_j)
    wq_j, sw_j = jq._quantize_weight(jnp.asarray(w))
    wq, sw = q.quantize_weight(_dhwio_to_oidhw(w))
    np.testing.assert_array_equal(wq.numpy(),
                                  _np(wq_j).transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sw.numpy(), _np(sw_j))


# (id, Cin, Cout, kernel (DHW), stride, padding, act_scale)
CONV_CASES = [
    ("dynamic-stem-cin3", 3, 10, (3, 7, 7), (1, 2, 2), (1, 3, 3), None),
    ("static-temporal-stride2", 9, 12, (3, 1, 1), (2, 1, 1), (1, 0, 0),
     0.07),
    ("fixed-asym-pad", 5, 6, (2, 3, 3), (2, 2, 2), ((0, 1), (1, 2), (1, 2)),
     q.FIXED_SCALE),
    ("static-tensor-cin16", 16, 8, (1, 3, 3), (1, 1, 1), (0, 1, 1),
     np.float32(0.031)),
    ("dynamic-1x1-stride2", 6, 4, (1, 1, 1), (2, 2, 2), (0, 0, 0), None),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int8_conv_plain_matches_jax(case):
    _, cin, cout, k, stride, pad, sa = case
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 11, 11, cin)).astype(np.float32)
    w = (rng.normal(size=(*k, cin, cout)) * 0.2).astype(np.float32)
    wt = _dhwio_to_oidhw(w)
    # the port's dynamic scale is the one ``Conv3d`` passes, JAX's its own
    sa_t = (q.activation_absmax_scale(torch.from_numpy(x)) if sa is None
            else torch.tensor(float(sa)) if isinstance(sa, np.floating)
            else sa)
    # accumulators: the same s8 operands through both packages' convs
    xf = jnp.asarray(x)
    if sa is None:
        xq_j, _ = jq._quantize_tensor(xf)
    else:
        xq_j = jnp.clip(jnp.round(xf / jnp.float32(sa)), -127,
                        127).astype(jnp.int8)
    wq_j, _ = jq._quantize_weight(jnp.asarray(w))
    acc_j = _np(jq._conv(xq_j, wq_j, stride, pad, jnp.int32))
    lo, hi = q._pads(pad)
    acc = q.int8_conv3d_acc_plain(torch.from_numpy(_np(xq_j).copy()),
                                  q.quantize_weight(wt)[0], list(stride),
                                  lo, hi)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    # the op, on the CPU its plain version, returns the accumulator too
    op_acc = torch.ops.cstp.int8_conv3d(
        torch.from_numpy(_np(xq_j).copy()), q.quantize_weight(wt)[0],
        torch.ones(cout), list(stride), lo, hi, torch.int32)
    assert torch.equal(op_acc, acc)
    # contiguous NDHWC, as K6 writes it and as the op's fake declares it
    assert acc.is_contiguous() and op_acc.is_contiguous()
    # dequantized outputs: float32 bitwise, bf16 within one ulp
    out32_j = _np(jq.int8_conv(xf, jnp.asarray(w), stride, pad, jnp.float32,
                               act_scale=sa))
    out32 = q.int8_conv(torch.from_numpy(x), wt, stride, pad, torch.float32,
                        act_scale=sa_t)
    np.testing.assert_array_equal(out32.numpy(), out32_j)
    out16_j = _np(jq.int8_conv(xf, jnp.asarray(w), stride, pad, jnp.bfloat16,
                               act_scale=sa).astype(jnp.float32))
    out16 = q.int8_conv(torch.from_numpy(x), wt, stride, pad, torch.bfloat16,
                        act_scale=sa_t).float().numpy()
    ulp = np.abs(out16_j) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(out16 - out16_j) <= ulp)


def test_straight_through_gradients_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 6, 6, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 8, 16)) * 0.1).astype(np.float32)
    g = rng.normal(size=(2, 2, 3, 3, 16)).astype(np.float32)
    stride, pad = (2, 2, 2), ((0, 1), (1, 1), (0, 1))

    def loss(x_, w_):
        return jnp.sum(jq.int8_conv(x_, w_, stride, pad, jnp.float32) * g)

    dx_j, dw_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = _dhwio_to_oidhw(w).requires_grad_()
    out = q.int8_conv(xt, wt, stride, pad, torch.float32,
                      act_scale=q.activation_absmax_scale(xt.detach()))
    (out * torch.from_numpy(g)).sum().backward()
    for got, want in ((xt.grad.numpy(), _np(dx_j)),
                      (wt.grad.numpy().transpose(2, 3, 4, 1, 0), _np(dw_j))):
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("mode", q.QUANT_MODES)
def test_conv3d_modes_match_jax(mode):
    """A ``Conv3d`` in each mode against the JAX ``Conv3d`` (weights and,
    for int8_static, the scale bridged); int8_calib observes two batches
    and keeps the maximum, as JAX's does."""
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(2, 4, 9, 9, 6)).astype(np.float32) * s
          for s in (1.0, 2.5)]
    jconv = JaxConv3d(8, (3, 3, 3), (1, 2, 2), (1, 1, 1), use_bias=True,
                      dtype=jnp.float32, quant=mode)
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["bias"] = rng.normal(size=(8,)).astype(np.float32)
    stats = ({"act_scale": np.float32(0.02 if mode == "int8_static" else 0)}
             if mode in ("int8_static", "int8_calib") else {})
    conv = Conv3d(6, 8, 3, (1, 2, 2), 1, torch.float32, use_bias=True,
                  quant=mode)
    load_jax_variables(conv, params, stats)
    for x in xs:
        got = conv(torch.from_numpy(x)).detach().numpy()
        var = {"params": params, "batch_stats": stats}
        want, mut = jconv.apply(var, jnp.asarray(x),
                                mutable=["batch_stats"])
        if mode == "int8_calib":
            stats = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])
        np.testing.assert_allclose(got, _np(want), rtol=1e-4,
                                   atol=1e-4 * np.abs(_np(want)).max())
    if mode == "int8_calib":
        assert float(conv.act_scale) == pytest.approx(
            float(stats["act_scale"]), rel=1e-6)
        assert float(stats["act_scale"]) == pytest.approx(
            np.abs(xs[1]).max() / 127 + 1e-12, rel=1e-6)


def _jax_classify(quant):
    from cstp_tpu.train.finetune import create_classify_model

    cfg = JaxConfig(model_name="r21d", model_depth=1, sample_duration=T,
                    sample_size=S, compute_dtype="float32", quant=quant,
                    task="test").finalize()
    return create_classify_model(cfg, 5)


def _port_classify(quant):
    from cstp_tpu_torch.train.finetune import create_classify_model

    cfg = Config(model_name="r21d", model_depth=1, sample_duration=T,
                 sample_size=S, compute_dtype="float32", quant=quant,
                 task="test").finalize()
    return create_classify_model(cfg, 5, device="cpu")


def _clips(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def classify_int8():
    """R(2+1)D depth 1 at 4x32^2: float weights from JAX's init, scales
    calibrated in JAX over two batches, the int8_static logits in JAX."""
    jcalib, jstatic = _jax_classify("int8_calib"), _jax_classify(
        "int8_static")
    x0 = jnp.asarray(_clips(10))
    v = jax.jit(lambda x: jcalib.init(jax.random.PRNGKey(1), x,
                                      train=False))(x0)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = v["batch_stats"]
    observe = jax.jit(lambda p, s, x: jcalib.apply(
        {"params": p, "batch_stats": s}, x, train=False,
        mutable=["batch_stats"])[1]["batch_stats"])
    for seed in (10, 11):
        stats = observe(params, stats, jnp.asarray(_clips(seed)))
    stats = jax.tree_util.tree_map(np.asarray, stats)
    logits = _np(jax.jit(lambda p, s, x: jstatic.apply(
        {"params": p, "batch_stats": s}, x, train=False))(
            params, stats, jnp.asarray(_clips(12))))
    return dict(params=params, stats=stats, logits=logits)


def test_int8_static_classify_logits_match_jax(classify_int8):
    model = _port_classify("int8_static")
    load_jax_variables(model, classify_int8["params"], classify_int8["stats"])
    assert q.check_int8_calibrated(model.state_dict(), "test") == 24
    with torch.no_grad():
        got = model(torch.from_numpy(_clips(12)), train=False).numpy()
    want = classify_int8["logits"]
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_calibrated_scales_match_jax(classify_int8):
    """The port's int8_calib forward over the same two batches gives JAX's
    scales; the bridge carries them both ways."""
    model = _port_classify("int8_calib")
    zero = jax.tree_util.tree_map(
        lambda a: np.zeros_like(a) if a.ndim == 0 else a,
        classify_int8["stats"])
    load_jax_variables(model, classify_int8["params"], zero)
    with torch.no_grad():
        for seed in (10, 11):
            model(torch.from_numpy(_clips(seed)), train=False)
    _, stats = export_jax_variables(model)
    got = dict(q.iter_scales(stats))
    want = dict(q.iter_scales(classify_int8["stats"]))
    assert got.keys() == want.keys() and len(want) == 24
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def int8_pretrain_step():
    """One ``--quant int8`` pretrain step of JAX's train program and the
    port's, from the port's initial weights (JAX's ``init`` returns them:
    its own init of the two towers costs half a minute here) and the same
    pre-augmented batch: ``(JAX's metrics, the port's, {run: the
    parameters' update})`` for JAX's step and the port's int8 step, and
    for the port's step from the same weights in float, ``int8_fixed`` and
    ``--quant_scope target``."""
    from cstp_tpu.ssl.byol import CSTPPretrain as JaxPretrain
    from cstp_tpu.train.pretrain import (
        create_pretrain_state as jax_create_state,
        split_pretrain_step as jax_split_step,
    )
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_preaugmented_step,
    )

    # no weight decay: the parameters' update is then -lr * gradient
    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              quant="int8", weight_decay=0.0)
    model, state, tx = create_pretrain_state(Config(**kw).finalize(),
                                             device="cpu")
    params0, stats0 = jax.tree_util.tree_map(np.copy,
                                             export_jax_variables(model))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    jcfg = JaxConfig(**kw).finalize()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPretrain, "init", lambda self, *a, **k: {
            "params": params0, "batch_stats": stats0})
        jmodel, jstate, jtx = jax_create_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, 5, (B,)).astype(np.int32)
             for k in ("spa", "tem", "pb")}
    batch.update(rot1=rng.integers(0, 4, (B,)).astype(np.int32),
                 rot2=rng.integers(0, 4, (B,)).astype(np.int32),
                 view1=_clips(20), view2=_clips(21))
    keys = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")
    _, jtrain = jax_split_step(jmodel, jtx, jcfg)
    jstate, jm = jtrain(jstate, tuple(jnp.asarray(batch[k]) for k in keys),
                        jnp.float32(jcfg.learning_rate))
    tbatch = {k: torch.from_numpy(batch[k]) for k in keys}

    def update(params):
        """The step's parameter update, flattened in Flax leaf order."""
        new, old = (jax.tree_util.tree_leaves(t) for t in (params, params0))
        assert len(new) == len(old)
        return np.concatenate([(np.asarray(a, np.float64) - b).ravel()
                               for a, b in zip(new, old)])

    def port_step(**over):
        """The port's step from the same weights under ``kw | over``:
        ``(metrics, update)``."""
        cfg = Config(**{**kw, **over}).finalize()
        m, st, opt = create_pretrain_state(cfg, device="cpu")
        m.load_state_dict(init)
        _, met = make_preaugmented_step(m, opt, cfg)(st, tbatch,
                                                     jcfg.learning_rate)
        return ({k: float(v) for k, v in met.items()},
                update(export_jax_variables(m)[0]))

    pm, port_int8 = port_step()
    updates = {"jax_int8": update(jstate.params), "port_int8": port_int8,
               "port_float": port_step(quant="")[1],
               "fixed": port_step(quant="int8_fixed")[1],
               "scope_target": port_step(quant_scope="target")[1]}
    return {k: float(v) for k, v in jm.items()}, pm, updates


def test_int8_pretrain_step_losses_match_jax(int8_pretrain_step):
    """Loss terms within 2e-2: every conv of both towers is int8 here, so
    the two packages' float32 BatchNorm reductions, summed in other orders,
    flip a few round-half decisions at the next site's quantize, each
    moving one activation by one quantization step. At these random
    weights that moves the loss terms by 0.1-0.7% (the accuracies, counts
    over 8 clips, by whole clips), as much as the int8 quantization itself
    moves them from the float step. The int8 arithmetic is held bitwise by
    the conv and module tests above."""
    jm, pm, _ = int8_pretrain_step
    assert pm.keys() == jm.keys()
    for k, v in jm.items():
        assert np.isfinite(pm[k]), k
        if k.startswith("loss"):
            np.testing.assert_allclose(pm[k], v, rtol=2e-2, err_msg=k)


def test_int8_pretrain_step_update_matches_jax_not_float(
        int8_pretrain_step):
    """The step's update (-lr * gradient, no weight decay) separates int8
    from float where the loss terms cannot. Its int8 effect, the update
    less the port's float step's update from the same weights, points the
    way JAX's int8 effect does: cosine >= 0.55 (0.643 when written), and
    nearer than the effect of a wrong mode, ``int8_fixed`` (0.425) or
    ``--quant_scope target`` (0.019). A step that skipped the quantize has
    no effect at all. The cosine stays below 1 because the round-half flips
    the loss test describes cascade through the 24 sites; the whole update
    is also nearer JAX's int8 update than the port's float one."""
    _, _, u = int8_pretrain_step

    def cos(a, b):
        return float(a @ b / np.sqrt((a @ a) * (b @ b)))

    want = u["jax_int8"] - u["port_float"]
    effect = {k: cos(u[k] - u["port_float"], want)
              for k in ("port_int8", "fixed", "scope_target")}
    assert np.linalg.norm(u["port_int8"] - u["port_float"]) > 0
    assert effect["port_int8"] >= 0.55, effect
    assert effect["port_int8"] > max(effect["fixed"],
                                     effect["scope_target"]), effect
    assert (cos(u["port_int8"], u["jax_int8"])
            > cos(u["port_int8"], u["port_float"]))


def _conv_modes(module):
    return [m.quant for m in module.modules() if isinstance(m, Conv3d)]


def test_quant_scope_target_quantizes_the_target_tower_only():
    """``--quant_scope target``: only the target tower's convs run the
    int8 conv; 'all' quantizes both towers."""
    from cstp_tpu_torch.train.pretrain import create_pretrain_model

    base = dict(model_name="r21d", sample_duration=T, sample_size=S,
                quant="int8")
    m = create_pretrain_model(Config(quant_scope="target", **base).finalize(),
                              device="cpu")
    assert set(_conv_modes(m.online_net)) == {""}
    assert set(_conv_modes(m.target_net)) == {"int8"}
    assert len(_conv_modes(m.target_net)) == 24
    m = create_pretrain_model(Config(quant_scope="all", **base).finalize(),
                              device="cpu")
    assert set(_conv_modes(m.online_net)) == {"int8"}
    # the forward's activations: the online tower's int8 output differs
    x = torch.from_numpy(_clips(30))
    mf = create_pretrain_model(Config(model_name="r21d", sample_duration=T,
                                      sample_size=S).finalize(), device="cpu")
    mf.load_state_dict(m.state_dict())
    with torch.no_grad():
        assert not torch.equal(m.online_net(x, False)[0],
                               mf.online_net(x, False)[0])


def test_eval_only_modes_refused_on_training_steps():
    """As JAX's: refused at ``finalize`` on a training task, and by the
    step factories for a config that skipped it."""
    from cstp_tpu_torch.train.finetune import make_finetune_step
    from cstp_tpu_torch.train.pretrain import make_pretrain_step

    for mode in ("int8_static", "int8_calib"):
        kw = dict(model_name="r21d", sample_duration=T, sample_size=S,
                  batch_size=4, quant=mode, task="ft_all")
        said = f"--quant {mode} is an eval/serve/calibration mode"
        with pytest.raises(ValueError, match=said):
            JaxConfig(**kw).finalize()
        with pytest.raises(ValueError, match=said):
            Config(**kw).finalize()
        for build in (make_pretrain_step, make_finetune_step):
            with pytest.raises(ValueError, match="eval/serve/calibration"):
                build(None, None, Config(**kw))


def test_check_int8_calibrated_guards_match_jax():
    """The same trees pass or fail both guards with the same counts and the
    same messages (apart from the module the message names)."""
    good = {"backbone": {"conv1": {"act_scale": np.float32(0.04)},
                         "layer1": {"spatial_conv": {
                             "act_scale": np.float32(0.1)}}}}
    assert q.check_int8_calibrated(good, "test") == 2
    assert jq.check_int8_calibrated(good, "test") == 2
    for tree, match in (({"a": {"act_scale": np.float32(0.04)},
                          "b": {"act_scale": np.float32(0.0)}},
                         "uncalibrated"),
                        ({"bn": {"mean": np.zeros(4)}}, "no act_scale")):
        with pytest.raises(ValueError, match=match) as perr:
            q.check_int8_calibrated(tree, "test")
        with pytest.raises(ValueError, match=match) as jerr:
            jq.check_int8_calibrated(tree, "test")
        assert (str(perr.value).replace("cstp_tpu_torch", "cstp_tpu")
                == str(jerr.value))
    flat = {"online_net.conv1.spatial_conv.act_scale": torch.tensor(0.0),
            "online_net.conv1.bn.mean": torch.zeros(3)}
    with pytest.raises(ValueError, match="1/1 conv sites"):
        q.check_int8_calibrated(flat, "test")


def test_uncalibrated_int8_static_test_run_is_refused(tmp_path):
    """``run_test --quant int8_static`` on a float checkpoint: the restore
    leaves every ``act_scale`` at 0 and the guard refuses the run, as the
    JAX package's ``run_test`` does."""
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.train.finetune import create_finetune_state
    from cstp_tpu_torch.train.loops import run_test

    kw = dict(model_name="r21d", sample_duration=T, sample_size=S,
              compute_dtype="float32", n_classes=5, n_finetune_classes=5,
              data_backend="synthetic", synthetic_len=4, task="test",
              result_path=str(tmp_path))
    cfg = Config(**kw).finalize()
    _, state, _ = create_finetune_state(cfg, 5, device="cpu")
    path = ckpt_lib.save_checkpoint(str(tmp_path / "save_1_max"),
                                    ckpt_lib.state_tree(state),
                                    meta={"arch": cfg.arch})
    qcfg = dataclasses.replace(cfg, quant="int8_static",
                               test_md_path=path).finalize()
    with pytest.raises(ValueError, match="24/24 conv sites"):
        run_test(qcfg, max_videos=1, device="cpu")


def _n_jax_sites(arch, depth, x):
    """``act_scale`` leaves the JAX module tree declares for ``arch`` in
    int8_calib mode, from an abstract init (nothing is computed)."""
    from cstp_tpu.ssl.byol import CSTPClassify as JaxClassify

    m = JaxClassify(backbone=arch, depth=depth, num_classes=5,
                    dtype=jnp.float32, quant="int8_calib")
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x,
                                           train=False))
    return len(list(q.iter_scales(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes["batch_stats"]))))


@pytest.mark.parametrize("arch, depth", [("c3d", 1), ("r3d", 18), ("s3d", 1),
                                         ("i3d", 1), ("slowfast", 18)])
def test_every_family_calibrates_then_runs_int8_static(arch, depth):
    """Port only: calibrate (int8_calib), then int8_static runs, with as
    many sites as the JAX module tree declares, and its logits track the
    float model's."""
    from cstp_tpu_torch.ssl.byol import CSTPClassify

    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 8, 32, 32, 3)).astype(np.float32))
    kw = dict(backbone=arch, depth=depth, num_classes=5, dtype=torch.float32)
    models = {m: CSTPClassify(gen=torch.Generator().manual_seed(0), quant=m,
                              **kw) for m in ("", "int8_calib", "int8_static")}
    with torch.no_grad():
        out_f = models[""](x, train=False)
        models["int8_calib"](x, train=False)
        sd = models["int8_calib"].state_dict()
        n = q.check_int8_calibrated(sd, "test")
        models["int8_static"].load_state_dict(sd)
        out_q = models["int8_static"](x, train=False)
    assert n == _n_jax_sites(arch, depth, jnp.asarray(x.numpy())) > 0
    assert torch.isfinite(out_q).all()
    corr = np.corrcoef(out_f.numpy().ravel(), out_q.numpy().ravel())[0, 1]
    assert corr > 0.95, (arch, corr)
