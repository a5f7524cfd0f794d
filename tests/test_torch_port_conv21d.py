"""The port's fused (2+1)D conv block (``cstp_tpu_torch/ops/conv21d.py``)
against the JAX package's Pallas kernels and reference chain.

On the CPU the port's ``fused_st_conv`` runs its plain version; the JAX side
runs the Pallas kernels in interpret mode, as ``tests/test_conv21d.py`` does.
Inputs come from ``numpy.random.default_rng``. The kernels themselves are
tested on the card by tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.models.layers import SpatioTemporalConv as JaxSTConv
from cstp_tpu.ops.pallas.conv21d import (
    fused_st_conv as jax_fused_st_conv,
    reference_chain as jax_reference_chain,
    reference_stats as jax_reference_stats,
)
from cstp_tpu_torch.models.bridge import export_jax_variables, load_jax_variables
from cstp_tpu_torch.models.layers import SpatioTemporalConv
from cstp_tpu_torch.ops import conv21d as C

def _inputs(seed, b=4, t=4, h=8, w=8, cin=8, m=16, cout=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, w, cin)).astype(np.float32),
            (0.1 * rng.normal(size=(3, 3, cin, m))).astype(np.float32),
            (0.1 * rng.normal(size=(3, m, cout))).astype(np.float32),
            (0.5 * rng.normal(size=(m,))).astype(np.float32),
            (0.1 * rng.normal(size=(m,))).astype(np.float32))


def _port(x, ws, wt, scale, bias, groups):
    """The port's CPU op on bf16 activations, as the kernels take them."""
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return C.fused_st_conv(xt, *map(torch.from_numpy, (ws, wt, scale, bias)),
                           groups)


def _jax(x, ws, wt, scale, bias, groups):
    return jax_fused_st_conv(*map(jnp.asarray, (x, ws, wt, scale, bias)),
                             groups, 1e-5, True)


@pytest.mark.parametrize("groups", [1, 2])
def test_fused_forward_matches_jax_kernel(groups):
    """Output and group statistics. Both round the spatial conv to bf16
    before the statistics; a different accumulation order can move a mid
    value by one bf16 ulp, so the statistics agree to 1e-2 and the bf16
    output to a few ulps (the tolerances of tests/test_conv21d.py)."""
    args = _inputs(0)
    out, gm, gv = _port(*args, groups)
    jout, jgm, jgv = _jax(*args, groups)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 4, 8, 8, 8)
    assert gm.shape == gv.shape == (groups, 16)
    np.testing.assert_allclose(gm.numpy(), np.asarray(jgm), rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=0.1, atol=0.05)


def test_temporal_boundary_frames_match_jax_kernel():
    """The first and last output frames see zero temporal padding."""
    args = _inputs(1, t=3)
    out, _, _ = _port(*args, 1)
    jout, _, _ = _jax(*args, 1)
    for frame in (0, 2):
        np.testing.assert_allclose(out[:, frame].float().numpy(),
                                   np.asarray(jout[:, frame], np.float32),
                                   rtol=0.1, atol=0.05)


def test_float32_plain_version_matches_jax_reference():
    """At float32 the plain version is the JAX reference chain with the
    statistics computed inside; float32 rounding only (rtol 1e-5)."""
    x, ws, wt, scale, bias = _inputs(2)
    out, gm, gv = C.fused_st_conv(*map(torch.from_numpy,
                                       (x, ws, wt, scale, bias)), 2)
    jm, jv = jax_reference_stats(jnp.asarray(x), jnp.asarray(ws),
                                 bn_groups=2, dtype=jnp.float32)
    jout = jax_reference_chain(*map(jnp.asarray, (x, ws, wt, scale, bias)),
                               jm, jv, bn_groups=2, dtype=jnp.float32)
    np.testing.assert_allclose(gm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def test_gradients_match_jax_reference_chain():
    """The autograd backward (recompute with the statistics inside) equals
    ``jax.grad`` of the reference chain, as tests/test_conv21d.py checks the
    JAX custom VJP. Float32 on both sides, so float32 rounding only."""
    x, ws, wt, scale, bias = _inputs(3, b=2, t=3, h=6, w=6, cin=4, m=8,
                                     cout=4)

    def jloss(*a):
        gm, gv = jax_reference_stats(a[0], a[1], bn_groups=2,
                                     dtype=jnp.float32)
        out = jax_reference_chain(*a, gm, gv, bn_groups=2, dtype=jnp.float32)
        return jnp.sum(jnp.sin(3.0 * out))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, ws, wt, scale, bias)))
    inputs = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, ws, wt, scale, bias)]
    out, _, _ = C.fused_st_conv(*inputs, 2)
    got = torch.autograd.grad(torch.sin(3.0 * out).sum(), inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("groups", [1, 2])
def test_fused_module_matches_flax_module(groups):
    """A fused ``SpatioTemporalConv`` site against the Flax module (which
    takes the unfused chain on the CPU) from the same weights: the output,
    and the BN running statistics updated from the op's ``(gmean, gvar)``
    (momentum 0.9, biased variance)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 4, 8, 8, 8)).astype(np.float32)
    jmod = JaxSTConv(16, (3, 3, 3), padding=(1, 1, 1), dtype=jnp.float32,
                     bn_groups=groups)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    jout, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    mod = SpatioTemporalConv(8, 16, 3, 1, 1, torch.float32, groups,
                             fused=True)
    load_jax_variables(mod, jax.tree_util.tree_map(np.asarray,
                                                   variables["params"]),
                       jax.tree_util.tree_map(np.asarray,
                                              variables["batch_stats"]))
    assert mod.fused_eligible(True)
    out = mod(torch.from_numpy(x), True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    _, stats = export_jax_variables(mod)
    want = mutated["batch_stats"]["bn"]["bn"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats["bn"]["bn"][k],
                                   np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_running_update_uses_biased_group_variance():
    """A fused site updates its BN running statistics from the op's
    ``(gmean, gvar)``: 0.9 * old + 0.1 * the mean over groups of the group
    mean and of the *biased* group variance of the spatial conv."""
    x = torch.from_numpy(_inputs(5)[0])
    mod = SpatioTemporalConv(8, 8, 3, 1, 1, torch.float32, 2, fused=True)
    with torch.no_grad():
        mid = mod.spatial_conv(x)
        mod(x, True)
    groups = mid.reshape(2, -1, mid.shape[-1])
    np.testing.assert_allclose(
        mod.bn.mean.numpy(), 0.1 * groups.mean(1).mean(0).numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        mod.bn.var.numpy(),
        0.9 + 0.1 * groups.var(dim=1, unbiased=False).mean(0).numpy(),
        rtol=1e-5, atol=1e-6)


def test_kernel_wrappers_refuse_shapes_they_do_not_take():
    """The wrappers check shapes before anything reaches a kernel."""
    x = torch.zeros((2, 2, 4, 4, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Cin % 32"):
        C.run_stats(x, torch.zeros((72, 16), dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="ws"):
        C.fused_st_conv_cuda(x, torch.zeros(1, 3, 8, 16), torch.zeros(3, 16, 8),
                             torch.zeros(16), torch.zeros(16))


def test_cpu_tensors_never_reach_a_kernel():
    """The wrappers take the plain version only for CPU tensors."""
    from cstp_tpu_torch.ops import augment as A

    before = (dict(C.launches), A.launches)
    x = torch.zeros((2, 2, 4, 4, 8))
    C.fused_st_conv(x, torch.zeros(3, 3, 8, 16), torch.zeros(3, 16, 8),
                    torch.ones(16), torch.zeros(16))
    assert (dict(C.launches), A.launches) == before
