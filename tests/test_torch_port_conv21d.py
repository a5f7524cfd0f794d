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
    _pad_hw as jax_pad_hw,
    fused_st_conv as jax_fused_st_conv,
    reference_chain as jax_reference_chain,
    reference_stats as jax_reference_stats,
)
from cstp_tpu_torch.models.bridge import export_jax_variables, load_jax_variables
from cstp_tpu_torch.models.layers import SpatioTemporalConv
from cstp_tpu_torch.ops import conv21d as C

from _torch_threads import torch_threads  # noqa: F401

def _inputs(seed, b=4, t=4, h=8, w=8, cin=8, m=16, cout=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, w, cin)).astype(np.float32),
            (0.1 * rng.normal(size=(3, 3, cin, m))).astype(np.float32),
            (0.1 * rng.normal(size=(3, m, cout))).astype(np.float32),
            (0.5 * rng.normal(size=(m,))).astype(np.float32),
            (0.1 * rng.normal(size=(m,))).astype(np.float32))


def _port(x, ws, wt, scale, bias, groups, tiling="clip"):
    """The port's CPU op on bf16 activations, as the kernels take them."""
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return C.fused_st_conv(xt, *map(torch.from_numpy, (ws, wt, scale, bias)),
                           groups, 1e-5, tiling)


def _jax(x, ws, wt, scale, bias, groups, tiling="clip"):
    """JAX's Pallas kernels of the same tiling, in interpret mode."""
    return jax_fused_st_conv(*map(jnp.asarray, (x, ws, wt, scale, bias)),
                             groups, 1e-5, True, tiling)


@pytest.mark.parametrize("tiling", ["clip", "taps9"])
@pytest.mark.parametrize("groups", [1, 2])
def test_fused_forward_matches_jax_kernel(groups, tiling):
    """Output and group statistics, against JAX's kernels of each tiling
    (the port's CPU op is one plain version for both). Both round the
    spatial conv to bf16 before the statistics; a different accumulation
    order can move a mid value by one bf16 ulp, so the statistics agree to
    1e-2 and the bf16 output to a few ulps (the tolerances of
    tests/test_conv21d.py)."""
    args = _inputs(0)
    out, gm, gv = _port(*args, groups, tiling)
    jout, jgm, jgv = _jax(*args, groups, tiling)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 4, 8, 8, 8)
    assert gm.shape == gv.shape == (groups, 16)
    np.testing.assert_allclose(gm.numpy(), np.asarray(jgm), rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-2,
                               atol=1e-3)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=0.1, atol=0.05)


@pytest.mark.parametrize("tiling", ["clip", "taps9"])
def test_temporal_boundary_frames_match_jax_kernel(tiling):
    """The first and last output frames see zero temporal padding."""
    args = _inputs(1, t=3)
    out, _, _ = _port(*args, 1, tiling)
    jout, _, _ = _jax(*args, 1, tiling)
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
    with pytest.raises(ValueError, match="Cin % 16"):
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


def test_unknown_tiling_raises():
    """Only "clip" and "taps9" are tilings; JAX reads any other value as
    taps9, the port refuses it."""
    x, ws, wt, scale, bias = map(torch.from_numpy, _inputs(6))
    with pytest.raises(ValueError, match="tiling"):
        C.fused_st_conv(x, ws, wt, scale, bias, 1, 1e-5, "bogus")


def test_taps9_on_cpu_tensors_launches_nothing():
    before = dict(C.launches)
    x, ws, wt, scale, bias = map(torch.from_numpy, _inputs(7))
    out, _, _ = C.fused_st_conv(x, ws, wt, scale, bias, 2, 1e-5, "taps9")
    assert out.shape == (4, 4, 8, 8, 8)
    assert dict(C.launches) == before


def _taps9_args(cin=16, m=16, cout=16, groups=1, hp=6, ws_shape=None):
    bf = torch.bfloat16
    gm = torch.zeros((groups, m))
    return (torch.zeros((2, 2, hp, hp, cin), dtype=bf),
            torch.zeros(ws_shape or (3, 3, cin, m), dtype=bf),
            torch.zeros((3, m, cout), dtype=bf), gm, gm, torch.ones(m),
            torch.zeros(m), groups)


# (shape change, the refusal's message); the dims check names all three
_REFUSED = {"cin": (dict(cin=8), "Cin % 16"), "mid": (dict(m=24), "M % 16"),
            "cout": (dict(cout=8), "Cout % 16"),
            "groups": (dict(groups=3), "BN groups"),
            "ws": (dict(ws_shape=(1, 3, 16, 16)), "ws must be"),
            "frame": (dict(hp=2), "no pixels")}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_taps9_wrappers_refuse_shapes_they_do_not_take(case):
    """run_stats_taps9 / run_fwd_taps9 take Cin a multiple of 16 (their K
    step), M and Cout multiples of 16, whole BN groups, ws (3, 3, Cin, M)
    and padded frames that hold at least one pixel; they refuse anything
    else before a launch."""
    change, msg = _REFUSED[case]
    x_pad, ws, wt, gm, gv, scale, bias, groups = _taps9_args(**change)
    before = dict(C.launches)
    with pytest.raises(ValueError, match=msg):
        C.run_fwd_taps9(x_pad, ws, wt, gm, gv, scale, bias, groups)
    if case != "cout":
        with pytest.raises(ValueError, match=msg):
            C.run_stats_taps9(x_pad, ws, groups)
    assert dict(C.launches) == before


def test_taps9_wrappers_take_cuda_tensors_only():
    """Well-shaped CPU tensors reach no kernel: the wrappers raise."""
    x_pad, ws, wt, gm, gv, scale, bias, groups = _taps9_args()
    with pytest.raises(ValueError, match="CUDA"):
        C.run_stats_taps9(x_pad, ws, groups)
    with pytest.raises(ValueError, match="CUDA"):
        C.run_fwd_taps9(x_pad, ws, wt, gm, gv, scale, bias, groups)


def test_pad_hw_matches_jax():
    """The taps9 kernels' padded input is JAX's ``_pad_hw``: one zero row
    and column on each side of every frame."""
    x = _inputs(8, b=2, t=2, h=5, w=7)[0]
    np.testing.assert_array_equal(C.pad_hw(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_pad_hw(jnp.asarray(x), 3, 3)))


# (name, N, T, H=W, Cin, M, Cout): the pretrain step's four sites at N=32,
# the conv-block benchmark's default shape and the card tests' edge shapes
_PLAN_SHAPES = [
    ("conv2", 32, 16, 56, 64, 144, 64),
    ("conv3", 32, 8, 28, 128, 288, 128),
    ("conv4", 32, 4, 14, 256, 576, 256),
    ("conv5", 32, 2, 7, 512, 1152, 512),
    ("bench", 128, 16, 56, 64, 144, 64),
    ("two_groups_one_tile", 2, 3, 7, 32, 16, 16),
    ("t1", 2, 1, 5, 32, 16, 16),
    ("t2", 4, 2, 6, 32, 48, 32),
    ("ragged_chunks", 2, 3, 7, 32, 560, 16),
    ("cluster2", 2, 3, 14, 32, 288, 32),
    ("cluster4", 4, 4, 14, 256, 576, 256),
]


@pytest.mark.parametrize("shape", _PLAN_SHAPES,
                         ids=[s[0] for s in _PLAN_SHAPES])
def test_fwd_plan_fits_and_covers_every_row_once(shape):
    """K3's plan: shared memory within the card's 232,448 bytes per block
    (the same sum csrc/conv21d.cu checks), whole 32-row warp strips, every
    (clip, pixel) row in exactly one tile with less than one tile over, a
    ring of min(3, T) frames of the block's mid slice, and chunks of the
    block's M and Cout slices within the kernel's warp tiles."""
    _, n, t, hw, cin, m, cout = shape
    p = C.plan_fwd(n, t, hw, hw, cin, m, cout)
    rows = n * hw * hw
    assert p["smem"] <= C.SMEM_MAX == 232448
    assert p["P"] % 32 == 0 and p["P"] in C.FWD_P
    assert p["blocks"] * p["P"] >= rows > (p["blocks"] - 1) * p["P"]
    assert p["ring_slots"] == min(3, t)
    assert p["stages"] >= 3 and p["cluster"] in C.FWD_CLUSTER
    c = p["cluster"]
    assert m % (16 * c) == 0 and cout % (16 * c) == 0
    wn = 256 // p["P"]
    assert p["ni"] in C.FWD_NI
    for width, chunk in ((m // c, p["bn"]), (cout // c, p["bno"])):
        assert chunk % 16 == 0 and 0 < chunk <= width
        assert 2 * -(-chunk // (16 * wn)) <= p["ni"]
    ring = 2 * min(3, t) * p["P"] * (m // c + 8)
    ldb = max(p["bn"], p["bno"]) + 8
    assert p["smem"] >= ring + p["stages"] * 2 * 64 * ldb
    plans = C.fwd_plans(n, t, hw, hw, cin, m, cout)
    assert p in plans and all(q["smem"] <= C.SMEM_MAX for q in plans)


def test_fwd_plan_buys_wide_row_tiles_with_clusters():
    """Where the ring of a wide mid does not fit one block at the largest
    row tile, the plan splits the tile over a cluster: none at conv2, 2
    blocks at conv3, 4 at conv4 and conv5 of the pretrain step at N=32."""
    plans = [C.plan_fwd(n, t, hw, hw, cin, m, cout)
             for _, n, t, hw, cin, m, cout in _PLAN_SHAPES[:4]]
    assert [(p["P"], p["cluster"]) for p in plans] == [
        (128, 1), (128, 2), (128, 4), (64, 4)]
    assert all(p["ni"] == 10 for p in plans)


def test_fwd_plan_sweep_needs_a_card():
    """The plan sweep entry exits with an error where there is no card."""
    from cstp_tpu_torch.perf import sweep_conv21d_fwd as sweep

    if torch.cuda.is_available():
        pytest.skip("a card is present; the sweep would run")
    with pytest.raises(SystemExit, match="CUDA"):
        sweep.main(["--sites", "conv5"])


def test_fwd_plan_refuses_a_mid_too_wide_for_the_ring():
    """M so wide that a 32-row ring of three mid frames and three stages
    overflow the shared memory: refused before any launch, on the CPU too."""
    with pytest.raises(ValueError, match="no plan fits"):
        C.plan_fwd(2, 4, 7, 7, 32, 4096, 16)
    x = torch.zeros((2, 4, 7, 7, 32), dtype=torch.bfloat16)
    ws = torch.zeros((9 * 32, 4096), dtype=torch.bfloat16)
    wt = torch.zeros((3, 4096, 16), dtype=torch.bfloat16)
    gm = torch.zeros((1, 4096))
    before = dict(C.launches)
    with pytest.raises(ValueError, match="no plan fits"):
        C.run_fwd(x, ws, wt, gm, gm, torch.ones(4096), torch.zeros(4096), 1)
    assert dict(C.launches) == before


# (name, N, T, H=W, Cin, M, G): the pretrain step's four sites and the
# benchmark's shape at N=32 or 128 in two groups, then T = 1 and 2, 7x7
# frames, G = 1, 2 and 4, and groups whose rows end inside a row tile
_STATS_SHAPES = [
    ("conv2", 32, 16, 56, 64, 144, 2),
    ("conv3", 32, 8, 28, 128, 288, 2),
    ("conv4", 32, 4, 14, 256, 576, 2),
    ("conv5", 32, 2, 7, 512, 1152, 2),
    ("bench", 128, 16, 56, 64, 144, 2),
    ("conv2_g1", 32, 16, 56, 64, 144, 1),
    ("conv5_g4", 32, 2, 7, 512, 1152, 4),
    ("t1_7x7_g1", 2, 1, 7, 32, 16, 1),
    ("t2_14x14_g2", 4, 2, 14, 32, 48, 2),
    ("t1_5x5_g4_ragged", 8, 1, 5, 32, 1152, 4),
]


def _stats_blocks(plan, n, t, h, w, m, groups):
    """Per block of one mid chunk, as csrc/conv21d.cu stats_kernel reads
    its indices: (group, first row, end of its rows, end of its tiles) in
    the flat (frame, pixel) index; rows past the group's end are
    zero-filled."""
    rows = n // groups * t * h * w
    p, tpb = plan["P"], plan["tpb"]
    tpg = -(-rows // p)
    bpg = -(-tpg // tpb)
    out = []
    for blk in range(groups * bpg):
        g = blk // bpg
        t0 = (blk - g * bpg) * tpb
        start = g * rows + t0 * p
        tiles_end = start + min(tpb, tpg - t0) * p
        out.append((g, start, min(tiles_end, (g + 1) * rows), tiles_end))
    return out


@pytest.mark.parametrize("shape", _STATS_SHAPES,
                         ids=[s[0] for s in _STATS_SHAPES])
def test_stats_plan_fits_and_covers_every_group_row_once(shape):
    """K2's plans (plan_stats's and every other of stats_plans): shared
    memory within 232,448 bytes (the sum csrc/conv21d.cu checks) that
    leaves room for two resident blocks per SM, chunks within the warp
    tiles and covering M, and row tiles that cover every row of every
    group exactly once, never cross a group and overrun it by less than
    one tile."""
    _, n, t, hw, cin, m, groups = shape
    chosen = C.plan_stats(n, t, hw, hw, cin, m, groups)
    plans = C.stats_plans(n, t, hw, hw, cin, m, groups)
    assert chosen in plans
    rows = n // groups * t * hw * hw
    for p in plans:
        assert p["smem"] <= C.SMEM_MAX == 232448
        assert C.STATS_PER_SM * (p["smem"] + 1024) <= C.SMEM_SM == 233472
        assert p["P"] in C.FWD_P and p["stages"] in C.STATS_STAGES
        assert p["ni"] in C.FWD_NI and p["bn"] % 16 == 0
        assert 2 * -(-p["bn"] // (16 * (256 // p["P"]))) <= p["ni"]
        nch = -(-m // p["bn"])
        assert nch * p["bn"] >= m > (nch - 1) * p["bn"]
        blocks = _stats_blocks(p, n, t, hw, hw, m, groups)
        assert p["blocks"] == nch * len(blocks) and p["partials"] == len(
            blocks)
        assert p["tiles"] == nch * groups * -(-rows // p["P"])
        pos = 0
        for g, start, stop, tiles_end in blocks:
            assert start == pos < stop <= (g + 1) * rows
            assert g * rows <= start and tiles_end - stop < p["P"]
            pos = stop
        assert pos == n * t * hw * hw


def test_stats_plan_at_the_sites():
    """At the pretrain step's sites the rule takes 128-row tiles, one
    144-wide mid chunk per block, 3 stages and two resident blocks per SM,
    with one wave of blocks."""
    for _, n, t, hw, cin, m, groups in _STATS_SHAPES[:4]:
        p = C.plan_stats(n, t, hw, hw, cin, m, groups)
        assert (p["P"], p["bn"], p["stages"]) == (128, 144, 3)
        assert p["blocks"] <= C.STATS_PER_SM * C.SM_COUNT


@pytest.mark.parametrize("shape,msg", [
    ((2, 1, 5, 5, 32, 24, 1), "M % 16"),
    ((2, 1, 5, 5, 8, 16, 1), "Cin % 16"),
    ((3, 1, 5, 5, 32, 16, 2), "BN groups"),
    ((2, 0, 5, 5, 32, 16, 1), "BN groups"),
    ((2 ** 15, 16, 64, 64, 32, 16, 1), "32 bits"),
], ids=["mid", "cin", "groups", "empty", "rows"])
def test_stats_plan_refuses_shapes_no_plan_fits(shape, msg):
    with pytest.raises(ValueError, match=msg):
        C.plan_stats(*shape)


def test_run_stats_on_cpu_tensors_launches_nothing():
    """Well-shaped CPU tensors reach no K2 launch: run_stats raises."""
    x = torch.zeros((2, 2, 7, 7, 32), dtype=torch.bfloat16)
    ws2 = torch.zeros((9 * 32, 16), dtype=torch.bfloat16)
    before = dict(C.launches)
    with pytest.raises(ValueError, match="CUDA"):
        C.run_stats(x, ws2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        C.run_stats(x, ws2, 2, plan=C.plan_stats(2, 2, 7, 7, 32, 16, 2))
    assert dict(C.launches) == before and C.launches["stats"] == 0


def test_stats_plan_sweep_needs_a_card():
    """The sweep's K2 mode exits with an error where there is no card."""
    from cstp_tpu_torch.perf import sweep_conv21d_fwd as sweep

    if torch.cuda.is_available():
        pytest.skip("a card is present; the sweep would run")
    with pytest.raises(SystemExit, match="CUDA"):
        sweep.main(["--pass", "stats", "--sites", "conv5"])


# (name, N, T, H=W, Cin, M, Cout, G): the shapes K4a/K4b take on the card
# (tests/test_torch_port_cuda.py: frames smaller than a tile, tiles crossing
# image rows, T = 1, Cin = 16) and the conv-block benchmark's default
_TAPS9_SHAPES = [
    ("frame_below_tile_t1", 4, 1, 5, 32, 16, 16, 2),
    ("cin16_rows_cross", 2, 3, 9, 16, 48, 32, 2),
    ("cin16_3x3", 2, 2, 3, 16, 16, 16, 2),
    ("bench", 128, 16, 56, 64, 144, 64, 2),
]


@pytest.mark.parametrize("shape", _TAPS9_SHAPES,
                         ids=[s[0] for s in _TAPS9_SHAPES])
def test_taps9_plans_fit_the_unpadded_shape(shape):
    """K4a/K4b run K2's and K3's kernels with the plans of the unpadded
    shape: plan_stats gives a plan that fits and covers every group row
    once, and plan_fwd one that fits and covers every (clip, pixel) row
    once."""
    _, n, t, hw, cin, m, cout, groups = shape
    ps = C.plan_stats(n, t, hw, hw, cin, m, groups)
    assert ps in C.stats_plans(n, t, hw, hw, cin, m, groups)
    assert C.STATS_PER_SM * (ps["smem"] + 1024) <= C.SMEM_SM
    rows = n // groups * t * hw * hw
    pos = 0
    for g, start, stop, _ in _stats_blocks(ps, n, t, hw, hw, m, groups):
        assert start == pos < stop <= (g + 1) * rows
        pos = stop
    assert pos == n * t * hw * hw
    pf = C.plan_fwd(n, t, hw, hw, cin, m, cout)
    assert pf["smem"] <= C.SMEM_MAX
    assert pf["blocks"] * pf["P"] >= n * hw * hw > (pf["blocks"] - 1) * pf["P"]


class _Recorder:
    """A stand-in for the conv21d library: records each call's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((fn, args))
            return 0
        return call


def test_taps9_wrappers_launch_the_conv21d_library_with_the_plans(monkeypatch):
    """run_stats_taps9 / run_fwd_taps9 call cstp_conv21d_taps9_* of the
    conv21d library with x_pad, the unpadded H and W and the plans of the
    unpadded shape, one int per field of the C signature (here with the
    library and the CUDA checks stubbed, so that CPU tensors get as far as
    the call)."""
    from types import SimpleNamespace

    lib = _Recorder()
    monkeypatch.setattr(C, "_lib", lambda: lib)
    monkeypatch.setattr(C, "_require_cuda", lambda dev: None)
    monkeypatch.setattr(C.torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    x_pad, ws, wt, gm, gv, scale, bias, groups = _taps9_args(groups=2)
    before = dict(C.launches)
    C.run_stats_taps9(x_pad, ws, groups)
    C.run_fwd_taps9(x_pad, ws, wt, gm, gv, scale, bias, groups)
    assert [fn for fn, _ in lib.calls] == ["cstp_conv21d_taps9_stats",
                                           "cstp_conv21d_taps9_fwd"]
    (_, a), (_, b) = lib.calls
    assert len(a) == len(C._STATS_SIG[0]) and len(b) == len(C._FWD_SIG[0])
    ps = C.plan_stats(2, 2, 4, 4, 16, 16, 2)
    pf = C.plan_fwd(2, 2, 4, 4, 16, 16, 16)
    assert a[0] == x_pad.data_ptr() and b[0] == x_pad.data_ptr()
    assert a[6:-1] == (2, 2, 4, 4, 16, 16, 2,
                       *(ps[k] for k in C._STATS_PLAN))
    assert b[8:-1] == (2, 2, 4, 4, 16, 16, 16, 2,
                       *(pf[k] for k in C._FWD_PLAN))
    assert {k: C.launches[k] - before[k] for k in C.launches} == {
        "stats": 0, "fwd": 0, "stats_taps9": 1, "fwd_taps9": 1}
