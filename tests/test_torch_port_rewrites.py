"""Two of the JAX package's rewrite flags in the port, on the CPU:
``--mid_round`` (rounded (2+1)D mid widths) and ``--t_fold`` (the spatial
conv and the mid BatchNorm on T-folded frames), with the combinations of
all three rewrites (``--s2d_stem`` too: ``tests/test_torch_port_s2d_stem
.py``) that JAX takes or refuses and ``--remat`` with each. Inputs are made
from a seed with numpy, weights from the port's seeded init, and both cross
to JAX by ``models/bridge.py``. Everything runs in float32.

Tolerances, and why:
- widths: equal;
- the ``--mid_round 128`` pretrain step: ``tests/test_torch_port_pretrain
  .py``'s (losses and metrics rtol 1e-4, BN statistics rtol 1e-4, the
  update leaf by leaf in norm within 5e-2: the ill-conditioned BatchNorm
  backward of random weights);
- ``--t_fold``: JAX's own (``tests/test_flags.py test_t_fold_is_exact``):
  outputs rtol/atol 2e-4, batch and running statistics rtol 1e-4 atol
  1e-5; the port's folded model against its unfolded one likewise;
- the int8 layers (``--quant int8`` on a folded site, ``int8_store`` at a
  rounded width): within 1e-3 of the output's norm (the integer products
  are exact; a BatchNorm reduced in another order can move a value across
  a rounding half step, ``tests/test_torch_port_int8_store.py``);
- ``--remat`` with a rewrite: the loss equal to the step's without remat
  (the same forward), the update within 1e-4 of its norm.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.models import make_backbone as jax_backbone
from cstp_tpu.models import layers as jl
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models import make_backbone
from cstp_tpu_torch.models import layers as pl
from cstp_tpu_torch.models.bridge import export_jax_variables
from cstp_tpu_torch.models.layers import SpatioTemporalConv

from _torch_threads import torch_threads  # noqa: F401

B, T, S = 4, 4, 32
LR = 3e-4
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the other test files' processes share the cores
    (an R(2+1)D step at 32^2 takes ten times longer on eight threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return np.asarray(jax.device_get(a))


def _variables(module):
    """``(params, batch_stats)`` of ``module`` in JAX's layout, copied: the
    bridge's float32 arrays share the live tensors' memory, which JAX may
    read after the port's next forward has moved the statistics."""
    return jax.tree_util.tree_map(np.copy, export_jax_variables(module))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ --mid_round

@pytest.mark.parametrize("cin, cout, kernel, round_to", [
    (64, 64, (3, 3, 3), 128), (128, 128, (3, 3, 3), 128),
    (256, 256, (3, 3, 3), 128),     # 576 = 4.5 x 128: the tie, to 512
    (512, 512, (3, 3, 3), 128), (3, 64, (3, 7, 7), 128),
    (64, 128, (1, 1, 1), 128), (64, 128, (3, 3, 3), 1),
    (256, 512, (3, 3, 3), 64), (8, 16, (3, 3, 3), 32),
])
def test_mid_width_is_jax_s(cin, cout, kernel, round_to):
    got = pl.r21d_intermediate_channels(cin, cout, kernel, round_to)
    assert got == jl.r21d_intermediate_channels(cin, cout, kernel, round_to)
    if (cin, round_to) == (256, 128):
        assert got == 512


def test_mid_round_sites_take_jax_s_widths():
    """Every (2+1)D site of an R(2+1)D-18 tower with ``--mid_round 128``
    holds JAX's parameter shapes (JAX's read off ``eval_shape``): the fused
    sites' mids 128 / 256 / 512 / 1152, the stem's 128."""
    x = jnp.zeros((2, T, S, S, 3), jnp.float32)
    jm = jax_backbone("r21d", 18, dtype=jnp.float32, mid_round=128)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.PRNGKey(0), x)["params"]
    pm = make_backbone("r21d", 18, dtype=torch.float32, mid_round=128)
    params, _ = export_jax_variables(pm)
    got = {k: v.shape for k, v in _flat(params).items()}
    assert got == {jax.tree_util.keystr(p): v.shape for p, v in
                   jax.tree_util.tree_flatten_with_path(shapes)[0]}
    mids = {n: m.spatial_conv.weight.shape[0] for n, m in pm.named_modules()
            if isinstance(m, SpatioTemporalConv)}
    assert mids["conv1"] == 128
    assert [mids[f"conv{i}.block2.conv2"] for i in (2, 3, 4, 5)] == [
        128, 256, 512, 1152]


def _view(rng):
    noise = rng.uniform(-1, 1, (B, T, S, S, 3))
    off = rng.uniform(-0.8, 0.8, (B, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (B, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def mid_round_step():
    """One preaugmented ``--mid_round 128 --fused_conv 1`` pretrain step in
    both packages from the port's initial weights (JAX's ``init`` returns
    them): JAX's sites take its unfused chain on the CPU, the port's its
    fused sites' plain version."""
    import cstp_tpu.train.pretrain as jpre
    from cstp_tpu.ssl.byol import CSTPPretrain as JaxPretrain
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_preaugmented_step,
    )

    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              fused_conv=1, learning_rate=LR, mid_round=128)
    cfg = Config(**kw).finalize()
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    params0, stats0 = _variables(model)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 5, (B,)).astype(np.int32)
             for k in ("spa", "tem", "pb")}
    batch.update(rot1=rng.integers(0, 4, (B,)).astype(np.int32),
                 rot2=rng.integers(0, 4, (B,)).astype(np.int32),
                 view1=_view(rng), view2=_view(rng))
    jcfg = JaxConfig(**kw).finalize()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxPretrain, "init", lambda self, *a, **k: {
            "params": params0, "batch_stats": stats0})
        jmodel, jstate, jtx = jpre.create_pretrain_state(
            jcfg, jax.random.PRNGKey(0))
    _, jtrain = jpre.split_pretrain_step(jmodel, jtx, jcfg)
    jstate, jm = jtrain(jstate, tuple(jnp.asarray(batch[k]) for k in KEYS),
                        jnp.float32(LR))
    step = make_preaugmented_step(model, tx, cfg)
    state, pm = step(state, {k: _t(batch[k]) for k in KEYS}, LR)
    params, stats = _variables(model)
    return dict(jm={k: float(v) for k, v in jm.items()},
                pm={k: float(v) for k, v in pm.items()},
                params0=_flat(params0), params=_flat(params),
                jparams=_flat(jstate.params), stats=_flat(stats),
                jstats=_flat(jstate.batch_stats))


def test_mid_round_step_losses_match_jax(mid_round_step):
    jm, pm = mid_round_step["jm"], mid_round_step["pm"]
    assert pm.keys() == jm.keys()
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_mid_round_step_update_matches_jax(mid_round_step):
    r = mid_round_step
    assert r["params"].keys() == r["jparams"].keys()
    want = {k: r["jparams"][k] - r["params0"][k] for k in r["params0"]}
    floor = 1e-4 * np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                               for v in want.values()))
    moved = 0.0
    for k, w in want.items():
        g = r["params"][k] - r["params0"][k]
        err = np.linalg.norm(g - w)
        assert err <= 5e-2 * np.linalg.norm(w) + floor, (
            f"{k}: |got - want| {err:.3e}, |want| {np.linalg.norm(w):.3e}")
        moved = max(moved, float(np.abs(g).max()))
    assert moved > 0.0
    for k, w in r["jstats"].items():
        np.testing.assert_allclose(r["stats"][k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_int8_store_site_at_a_rounded_width_matches_jax():
    """A storage-chain block (``--quant int8_store``) at ``--mid_round 32``
    (mid 28 -> 32) against JAX's, its scales raised by one calibration
    pass first: the output and every batch-stats leaf after it."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T, 8, 8, 8)).astype(np.float32)
    layer = SpatioTemporalConv(8, 16, 3, 1, 1, dtype=torch.float32,
                               bn_groups=2, quant="int8_store", mid_round=32,
                               gen=torch.Generator().manual_seed(0))
    assert layer.spatial_conv.weight.shape[0] == 32
    layer.quant = "int8_store_calib"
    with torch.no_grad():
        layer(_t(x * 1.5), True)
    layer.quant = "int8_store"
    params, stats = _variables(layer)
    jlayer = jl.SpatioTemporalConv(16, (3, 3, 3), (1, 1, 1), (1, 1, 1),
                                   dtype=jnp.float32, bn_groups=2,
                                   quant="int8_store", mid_round=32)
    want, mut = jlayer.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = layer(_t(x), True)
    want = _np(want)
    assert np.linalg.norm(got.numpy() - want) <= 1e-3 * np.linalg.norm(want)
    _, got_stats = export_jax_variables(layer)
    got_flat = _flat(got_stats)
    for k, w in _flat(mut["batch_stats"]).items():
        np.testing.assert_allclose(got_flat[k], w, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# ------------------------------------------------------------ --t_fold

@pytest.mark.parametrize("groups", [1, 2])
def test_t_fold_matches_jax_and_the_unfolded_model(groups):
    """R(2+1)D depth 1 with ``--t_fold``: the train-mode output and batch
    statistics, then the eval-mode output, against JAX's ``t_fold`` model
    and the port's unfolded model on the same variables; the parameters
    are the unfolded model's."""
    x = _x((4, 4, 16, 16, 3))
    gen = torch.Generator().manual_seed(0)
    folded = make_backbone("r21d", 1, dtype=torch.float32, bn_groups=groups,
                           t_fold=True, gen=gen)
    plain = make_backbone("r21d", 1, dtype=torch.float32, bn_groups=groups)
    plain.load_state_dict(folded.state_dict())
    params, stats = _variables(folded)
    jm = jax_backbone("r21d", 1, dtype=jnp.float32, bn_groups=groups,
                      t_fold=True)
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    want, mut = apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=True, mutable=("batch_stats",))
    with torch.no_grad():
        got, ref = folded(_t(x), True), plain(_t(x), True)
    for out in (got, ref):
        np.testing.assert_allclose(out.numpy(), _np(want), rtol=2e-4,
                                   atol=2e-4)
    _, got_stats = export_jax_variables(folded)
    _, ref_stats = export_jax_variables(plain)
    jstats = _flat(mut["batch_stats"])
    for stats_ in (_flat(got_stats), _flat(ref_stats)):
        assert stats_.keys() == jstats.keys()
        for k, w in jstats.items():
            np.testing.assert_allclose(stats_[k], w, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    want = apply({"params": params, **mut}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got, ref = folded(_t(x), False), plain(_t(x), False)
    for out in (got, ref):
        np.testing.assert_allclose(out.numpy(), _np(want), rtol=2e-4,
                                   atol=2e-4)


def test_t_fold_int8_site_matches_jax():
    """The stem site with ``--t_fold --quant int8``: the folded spatial
    conv is the int8 conv on T = 1 (K6's shape on the card), in train mode,
    against JAX's folded int8 site and the port's unfolded one."""
    x = _x((B, T, 16, 16, 3), seed=4)
    kw = dict(dtype=torch.float32, bn_groups=2, quant="int8",
              gen=torch.Generator().manual_seed(1))
    folded = SpatioTemporalConv(3, 16, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                                t_fold=True, **kw)
    plain = SpatioTemporalConv(3, 16, (3, 7, 7), (1, 2, 2), (1, 3, 3), **kw)
    plain.load_state_dict(folded.state_dict())
    seen = []
    real = pl.int8_conv

    def spy(x, *a, **k):
        seen.append(tuple(x.shape))
        return real(x, *a, **k)

    params, stats = _variables(folded)
    want, _ = jl.SpatioTemporalConv(
        16, (3, 7, 7), (1, 2, 2), (1, 3, 3), dtype=jnp.float32, bn_groups=2,
        t_fold=True, quant="int8").apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            train=True, mutable=["batch_stats"])
    want = _np(want)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "int8_conv", spy)
        with torch.no_grad():
            got = folded(_t(x), True)
    assert seen[0] == (B * T, 1, 16, 16, 3)     # the folded spatial conv
    with torch.no_grad():
        ref = plain(_t(x), True)
    for out in (got, ref):
        assert (np.linalg.norm(out.numpy() - want)
                <= 1e-3 * np.linalg.norm(want))


# ------------------------------------------------ combinations and families

@pytest.mark.parametrize("flag", [
    dict(fused_conv=1, t_fold=1),
    dict(quant="int8_store", s2d_stem=True),
    dict(quant="int8_store", t_fold=1),
])
def test_refused_combinations_raise_as_jax_does(flag):
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(model_name="r21d", **flag).finalize()
    with pytest.raises(ValueError) as port_err:
        Config(model_name="r21d", **flag).finalize()
    assert type(port_err.value) is type(jax_err.value)


@pytest.mark.parametrize("flag", [
    dict(quant="int8_store", mid_round=128), dict(quant="int8", t_fold=1),
    dict(quant="int8", s2d_stem=True), dict(fused_conv=1, s2d_stem=True),
    dict(fused_conv=1, mid_round=128), dict(remat=True, t_fold=1),
    dict(remat=True, s2d_stem=True), dict(remat=True, mid_round=128),
])
def test_combinations_jax_takes_build(flag):
    JaxConfig(model_name="r21d", **flag).finalize()
    cfg = Config(model_name="r21d", **flag).finalize()
    for k, v in flag.items():
        assert getattr(cfg, k) == v


@pytest.mark.parametrize("flag", [dict(t_fold=1), dict(s2d_stem=True),
                                  dict(mid_round=128)])
def test_remat_runs_with_each_rewrite(flag):
    """``--remat`` with each flag: the step's forward is the step's without
    remat (losses equal) and its update close to it (the recompute runs
    the same operations)."""
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_preaugmented_step,
    )

    rng = np.random.default_rng(9)
    batch = {k: _t(rng.integers(0, 4, (2,)).astype(np.int64))
             for k in ("spa", "tem", "pb", "rot1", "rot2")}
    batch.update(view1=_t(_view(rng)[:2]), view2=_t(_view(rng)[:2]))
    runs = []
    for remat in (False, True):
        cfg = Config(model_name="r21d", model_depth=1, sample_duration=T,
                     sample_size=S, batch_size=2, compute_dtype="float32",
                     remat=remat, **flag).finalize()
        model, state, tx = create_pretrain_state(cfg, device="cpu")
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        state, m = make_preaugmented_step(model, tx, cfg)(state, batch, LR)
        update = torch.cat([(p.detach() - p0[n]).flatten()
                            for n, p in model.named_parameters()])
        runs.append((float(m["loss"]), update))
    (loss0, u0), (loss1, u1) = runs
    assert loss0 == loss1 and np.isfinite(loss0)
    assert float((u1 - u0).norm()) <= 1e-4 * float(u0.norm())
