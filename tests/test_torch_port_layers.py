"""The port's layers and R(2+1)D backbone against the JAX package's Flax
modules, in float32 on the CPU, from weights bridged out of Flax.

Forward outputs and BN running statistics are well conditioned and agree
to float32 rounding (rtol 1e-5 on the layers, 1e-4 through the network).
Gradients are compared on one residual block under a random cotangent,
where they are well conditioned too (see tests/test_torch_port_pretrain.py
for why whole-network gradients are compared in norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.models.layers import BatchNorm as JaxBN
from cstp_tpu.models.layers import SpatioTemporalConv as JaxSTConv
from cstp_tpu.models.layers import r21d_intermediate_channels as jax_mid
from cstp_tpu.models.r21d import R2Plus1DNet as JaxNet
from cstp_tpu.models.r21d import SpatioTemporalResBlock as JaxBlock
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    export_named,
    load_jax_variables,
)
from cstp_tpu_torch.models.layers import (
    BatchNorm,
    SpatioTemporalConv,
    r21d_intermediate_channels,
)
from cstp_tpu_torch.models.r21d import R2Plus1DNet, SpatioTemporalResBlock


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bridge(module, variables):
    load_jax_variables(module, _np(variables["params"]),
                       _np(variables.get("batch_stats", {})))
    return module


def _assert_tree_close(got, want, rtol, atol):
    w = {jax.tree_util.keystr(p): v
         for p, v in jax.tree_util.tree_flatten_with_path(_np(want))[0]}
    g = {jax.tree_util.keystr(p): v
         for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _clips(seed, shape, channels_vary=True):
    """Activations whose clips differ in offset and scale."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    off = rng.uniform(-1, 1, (shape[0],) + (1,) * (len(shape) - 2)
                      + ((shape[-1],) if channels_vary else (1,)))
    scale = rng.uniform(0.3, 1.5, (shape[0],) + (1,) * (len(shape) - 1))
    return (off + scale * x).astype(np.float32)


@pytest.mark.parametrize("groups", [1, 2])
def test_batchnorm_matches_flax(groups):
    x = _clips(0, (8, 3, 4, 4, 6))
    jbn = JaxBN(dtype=jnp.float32, groups=groups)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    jy, mutated = jbn.apply(variables, jnp.asarray(x), False,
                            mutable=["batch_stats"])
    bn = _bridge(BatchNorm(6, groups), variables)
    y = bn(torch.from_numpy(x), True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    _assert_tree_close(export_jax_variables(bn)[1], mutated["batch_stats"],
                       1e-5, 1e-6)
    ey = bn(torch.from_numpy(x), False)
    jey = jbn.apply(mutated | {"params": variables["params"]},
                    jnp.asarray(x), True)
    np.testing.assert_allclose(ey.detach().numpy(), np.asarray(jey),
                               rtol=1e-5, atol=1e-5)


def test_grouped_bn_is_two_separate_calls_with_biased_running_var():
    """Per-view statistics: one grouped call over the concatenated views
    equals two single-group calls, one per view (the law of
    tests/test_pretrain_step.py); the running variance is the biased one."""
    x = _clips(1, (8, 2, 3, 3, 5))
    both = BatchNorm(5, groups=2)
    halves = [BatchNorm(5, groups=1) for _ in range(2)]
    for h in halves:
        h.load_state_dict(both.state_dict())
    y = both(torch.from_numpy(x), True)
    y1 = halves[0](torch.from_numpy(x[:4]), True)
    y2 = halves[1](torch.from_numpy(x[4:]), True)
    torch.testing.assert_close(y, torch.cat([y1, y2]), rtol=1e-5, atol=1e-5)
    per_view = [x[:4].reshape(-1, 5), x[4:].reshape(-1, 5)]
    want_var = 0.9 + 0.1 * np.mean([v.var(0) for v in per_view], 0)
    np.testing.assert_allclose(both.var.numpy(), want_var, rtol=1e-5)
    np.testing.assert_allclose(
        both.var.numpy(), 0.5 * (halves[0].var + halves[1].var).numpy(),
        rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_spatiotemporal_conv_matches_flax(fused):
    x = _clips(2, (4, 4, 8, 8, 16))
    jmod = JaxSTConv(32, (3, 3, 3), padding=(1, 1, 1), dtype=jnp.float32,
                     bn_groups=2)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)
    jy, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    mod = _bridge(SpatioTemporalConv(16, 32, 3, 1, 1, torch.float32, 2,
                                     fused=fused), variables)
    y = mod(torch.from_numpy(x), True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    _assert_tree_close(export_jax_variables(mod)[1], mutated["batch_stats"],
                       1e-5, 1e-6)


def test_intermediate_channels_match():
    for cin, cout, k in ((3, 64, (3, 7, 7)), (64, 64, (3, 3, 3)),
                         (64, 128, (1, 1, 1)), (256, 512, (3, 3, 3))):
        assert r21d_intermediate_channels(cin, cout, k) == jax_mid(cin, cout,
                                                                   k)


@pytest.fixture(scope="module")
def flax_net():
    """R(2+1)D depth 1 with the projector at T=4, S=32, two BN groups:
    input, variables and the Flax train-mode outputs."""
    x = np.clip(_clips(3, (4, 4, 32, 32, 3)) / 3.0, -1, 1)
    jnet = JaxNet(dtype=jnp.float32, bn_groups=2, proj_flag=True)
    variables = jax.jit(lambda k, v: jnet.init(k, v, train=True))(
        jax.random.PRNGKey(2), jnp.asarray(x))
    out, mutated = jax.jit(lambda var, v: jnet.apply(
        var, v, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    return x, variables, out, mutated["batch_stats"]


@pytest.mark.parametrize("fused_conv", [False, True])
def test_r21d_net_matches_flax(flax_net, fused_conv):
    """Features, projection and every updated running statistic."""
    x, variables, (jfeat, jproj), jstats = flax_net
    net = _bridge(R2Plus1DNet(proj_flag=True, dtype=torch.float32,
                              bn_groups=2, fused_conv=fused_conv), variables)
    feat, proj = net(torch.from_numpy(x), True)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(jfeat),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(proj.detach().numpy(), np.asarray(jproj),
                               rtol=1e-4, atol=1e-4)
    _assert_tree_close(export_jax_variables(net)[1], jstats, 1e-4, 1e-5)


def test_residual_block_gradients_match_flax():
    """Parameter and input gradients of a downsampling block under a random
    cotangent (float32 rounding only: rtol 1e-4)."""
    x = _clips(4, (4, 4, 8, 8, 16))
    rng = np.random.default_rng(5)
    jblock = JaxBlock(32, downsample=True, dtype=jnp.float32, bn_groups=2)
    variables = jblock.init(jax.random.PRNGKey(3), jnp.asarray(x), train=True)

    def fwd(params, xx):
        y, _ = jblock.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return y

    ct = rng.normal(size=(4, 2, 4, 4, 32)).astype(np.float32)
    jgp, jgx = jax.jit(lambda p, v, c: jax.vjp(fwd, p, v)[1](c))(
        variables["params"], jnp.asarray(x), jnp.asarray(ct))
    block = _bridge(SpatioTemporalResBlock(16, 32, True, torch.float32, 2),
                    variables)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = block(xt, True)
    params = dict(block.named_parameters())
    grads = torch.autograd.grad(y, [xt, *params.values()],
                                torch.from_numpy(ct))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5)
    _assert_tree_close(export_named(block, dict(zip(params, grads[1:]))),
                       jgp, 1e-4, 1e-5)


def test_bridge_refuses_unused_leaves_and_unset_tensors():
    x = _clips(6, (2, 2, 4, 4, 4))
    jmod = JaxSTConv(8, (3, 3, 3), padding=(1, 1, 1), dtype=jnp.float32)
    variables = _np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              train=True))
    mod = SpatioTemporalConv(4, 8, 3, 1, 1, torch.float32)
    extra = dict(variables["params"], stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="stray"):
        load_jax_variables(mod, extra, variables["batch_stats"])
    missing = {k: v for k, v in variables["params"].items()
               if k != "temporal_conv"}
    with pytest.raises(ValueError, match="temporal_conv.weight"):
        load_jax_variables(mod, missing, variables["batch_stats"])
