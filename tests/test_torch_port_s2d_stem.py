"""The JAX package's ``--s2d_stem`` in the port, on the CPU: on R(2+1)D
the exact space-to-depth rewrite of the stride-2 (1, 7, 7) stem conv
(``models/layers.py s2d_conv``, the JAX package's ``SpatialS2DConv``), on
S3D the reference's legacy stem with its own parameter shapes
(``models/s3dg.py``); the families whose JAX constructors drop the flag
ignore it. Inputs are made from a seed with numpy, weights from the port's
seeded init or, for S3D, from numpy over JAX's variable tree, and cross by
``models/bridge.py``. Everything runs in float32.

Tolerances, and why:
- the s2d stem conv: 1e-5, JAX's own tolerance for the rewrite (the same
  products summed in another order); the stem site after its BatchNorm,
  ReLU and temporal conv: rtol 1e-4 atol 1e-5 (the normalisation divides
  by the batch's spread);
- S3D's stem (s2d, conv, BatchNorm, ReLU): 1e-5; the whole network in
  train mode is ill conditioned at 32^2 (its last BatchNorms see a few
  values per channel), so it is held to ten times the port's own float32
  spread (the change a 1e-7 relative change of the input makes), as
  ``tests/test_torch_port_inception.py`` holds S3D;
- a family that ignores the flag: bitwise.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cstp_tpu.models import layers as jl
from cstp_tpu.models import make_backbone as jax_backbone
from cstp_tpu_torch.models import layers as pl
from cstp_tpu_torch.models import make_backbone
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    load_jax_variables,
)
from cstp_tpu_torch.models.layers import SpatioTemporalConv

from _torch_threads import torch_threads  # noqa: F401

B, T = 4, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the other test files' processes share the
    cores."""
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


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_s2d_conv_is_the_strided_conv_and_jax_s():
    """The space-to-depth rewrite of the (1, 7, 7) stride-2 stem conv: the
    plain conv's output and JAX's ``SpatialS2DConv``'s, to 1e-5, from the
    same ``(1, 7, 7, 3, 45)`` parameter."""
    x = _x((2, 4, 32, 32, 3), seed=2)
    conv = pl.Conv3d(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), torch.float32,
                     torch.Generator().manual_seed(2))
    with torch.no_grad():
        plain = conv(_t(x)).numpy()
        got = pl.s2d_conv(_t(x), conv.weight, 3, torch.float32).numpy()
    params, _ = export_jax_variables(conv)
    want = _np(jl.SpatialS2DConv(45, kernel_hw=7, pad=3, dtype=jnp.float32)
               .apply({"params": params}, jnp.asarray(x)))
    assert got.shape == plain.shape == (2, 4, 16, 16, 45)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_s2d_stem_site_matches_jax():
    """R(2+1)D's stem site with ``--s2d_stem`` in train mode: the plain
    stem's output and JAX's s2d stem's, with the same parameters (the
    stem's spatial conv keeps its ``(1, 7, 7)`` weight)."""
    x = _x((B, T, 32, 32, 3), seed=5)
    stem = SpatioTemporalConv(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                              dtype=torch.float32, bn_groups=2, s2d=True,
                              gen=torch.Generator().manual_seed(3))
    plain = SpatioTemporalConv(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                               dtype=torch.float32, bn_groups=2)
    plain.load_state_dict(stem.state_dict())
    params, stats = _variables(stem)
    want, _ = jl.SpatioTemporalConv(
        64, (3, 7, 7), (1, 2, 2), (1, 3, 3), dtype=jnp.float32, bn_groups=2,
        s2d=True).apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got, ref = stem(_t(x), True), plain(_t(x), True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-5)


def test_s2d_stem_on_a_quantized_r21d_keeps_the_stem_conv_float():
    """JAX's ``SpatialS2DConv`` takes no ``--quant``: the s2d stem conv of
    an ``int8_static`` model holds no ``act_scale`` (the bridge maps the
    other sites' scales as before) and runs the float rewrite."""
    m = make_backbone("r21d", 1, dtype=torch.float32, s2d_stem=True,
                      quant="int8_static")
    sd = m.state_dict()
    assert "conv1.spatial_conv.act_scale" not in sd
    assert "conv1.temporal_conv.act_scale" in sd
    assert "conv2.block1.conv1.spatial_conv.act_scale" in sd


def _clips(rng, n, t=8, s=32):
    """Clips in [-1, 1] whose videos differ in colour offset and contrast,
    as augmented crops of different videos do."""
    noise = rng.uniform(-1, 1, (n, t, s, s, 3))
    off = rng.uniform(-0.8, 0.8, (n, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (n, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def test_s3d_s2d_stem_loads_jax_s_variables_and_matches_its_forward():
    """S3D with ``--s2d_stem`` (the reference's legacy stem): the bridge
    lays a variable tree of JAX's model, ``Conv_1a``'s ``(2, 4, 4, 24,
    64)`` kernel included, over the port's model, every leaf to one
    tensor; on the port's initial weights the stem's output then equals
    JAX's to 1e-5, and the network's train-mode output JAX's within ten
    times the port's own float32 spread."""
    from cstp_tpu.models.s3dg import BasicConv3d as JaxBasicConv3d
    from cstp_tpu.models.s3dg import space_to_depth_stem as jax_s2d
    from cstp_tpu_torch.models.s3dg import space_to_depth_stem

    x = _clips(np.random.default_rng(6), B)
    jm = jax_backbone("s3d", 1, dtype=jnp.float32, s2d_stem=True)
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(7)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    assert tree["params"]["Conv_1a"]["conv"]["kernel"].shape == (
        2, 4, 4, 24, 64)
    other = make_backbone("s3d", 1, dtype=torch.float32, s2d_stem=True)
    load_jax_variables(other, tree["params"], tree["batch_stats"])
    np.testing.assert_array_equal(
        other.Conv_1a.conv.weight.detach().numpy(),
        tree["params"]["Conv_1a"]["conv"]["kernel"].transpose(4, 3, 0, 1, 2))

    model = make_backbone("s3d", 1, dtype=torch.float32, s2d_stem=True,
                          gen=torch.Generator().manual_seed(0))
    params, stats = _variables(model)
    stem = {"params": params["Conv_1a"], "batch_stats": stats["Conv_1a"]}
    want, _ = JaxBasicConv3d(64, (2, 4, 4), (1, 1, 1), (1, 2, 2),
                             dtype=jnp.float32).apply(
        stem, jax_s2d(jnp.asarray(x)), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = model.Conv_1a(space_to_depth_stem(_t(x)), True)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)

    want = _np(jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), train=True,
                        mutable=["batch_stats"])[0])

    def run(v):
        with torch.no_grad():
            return model(_t(v), True).numpy()

    got = run(x)
    spread = float(np.abs(got - run(x * np.float32(1 + 1e-7))).max())
    size = 1 + float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= min(10 * spread, 1e-2 * size) + 1e-5 * size, (
        f"max |got - want| {err:.3e}, float32 spread {spread:.3e}")


@pytest.mark.parametrize("family", ["c3d", "r3d", "i3d", "slowfast"])
def test_families_without_the_s2d_stem_ignore_it(family):
    """c3d, r3d, i3d and slowfast take ``--s2d_stem`` and change nothing,
    as their JAX constructors pop the flag."""
    kw = dict(dtype=torch.float32)
    a = make_backbone(family, 1, gen=torch.Generator().manual_seed(0), **kw)
    b = make_backbone(family, 1, gen=torch.Generator().manual_seed(0),
                      s2d_stem=True, mid_round=128, t_fold=True, **kw)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    x = _t(_x((2, 8, 32, 32, 3), seed=8))
    with torch.no_grad():
        ya, yb = a(x, True), b(x, True)
    for u, v in zip(ya if isinstance(ya, tuple) else (ya,),
                    yb if isinstance(yb, tuple) else (yb,)):
        assert torch.equal(u, v)
