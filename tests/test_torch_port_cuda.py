"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; every test skips without a CUDA GPU. This file imports no
JAX, so it also runs on a machine that has PyTorch only:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from cstp_tpu_torch.ops import augment as A
from cstp_tpu_torch.ops import conv21d as C

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def _conv_inputs(dev, rng, n, t, hw, cin, m, cout):
    x = _t(rng.normal(size=(n, t, hw, hw, cin)), dev, torch.bfloat16)
    ws = _t(rng.normal(size=(3, 3, cin, m)) * (9 * cin) ** -0.5, dev,
            torch.float32)
    wt = _t(rng.normal(size=(3, m, cout)) * (3 * m) ** -0.5, dev,
            torch.float32)
    scale = _t(rng.uniform(0.5, 1.5, m), dev, torch.float32)
    bias = _t(rng.normal(size=m) * 0.1, dev, torch.float32)
    return x, ws, wt, scale, bias


def _check_fused(tiling, x, ws, wt, scale, bias, groups=2):
    """One fused forward in ``groups`` BN groups launches the tiling's pair
    once each (and no other kernel) and matches the plain version.
    Tolerances as tests/test_conv21d.py: the spatial conv's bf16 rounding
    can differ by an ulp with the summation order."""
    keys = {"clip": ("stats", "fwd"),
            "taps9": ("stats_taps9", "fwd_taps9")}[tiling]
    before = dict(C.launches)
    out, gm, gv = C.fused_st_conv(x, ws, wt, scale, bias, groups, 1e-5,
                                  tiling)
    assert {k: C.launches[k] - before[k] for k in C.launches} == {
        k: int(k in keys) for k in C.launches}
    pm, pv = C.reference_stats(x, ws, groups)
    pout = C.reference_chain(x, ws, wt, scale, bias, gm, gv, groups)
    torch.testing.assert_close(gm, pm, rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(gv, pv, rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(out.float(), pout.float(), rtol=0.1,
                               atol=0.05)


@pytest.mark.parametrize("tiling", ["clip", "taps9"])
@pytest.mark.parametrize("shape", [(8, 16, 56, 64, 144, 64),
                                   (8, 8, 28, 128, 288, 128),
                                   (8, 2, 7, 512, 1152, 512)])
def test_conv21d_kernels_match_plain_version(dev, shape, tiling):
    """K2/K3 ("clip") and K4a/K4b ("taps9") at main-path site shapes, bf16,
    two BN groups."""
    rng = np.random.default_rng(0)
    _check_fused(tiling, *_conv_inputs(dev, rng, *shape))


@pytest.mark.parametrize("site", [(16, 56, 64, 144, 64),
                                  (8, 28, 128, 288, 128),
                                  (4, 14, 256, 576, 256),
                                  (2, 7, 512, 1152, 512)])
@pytest.mark.parametrize("n", [60, 64])
def test_conv21d_kernels_in_one_bn_group_of_a_finetune_batch(dev, n, site):
    """K2/K3 at the finetune step's four site shapes, in one BN group of 60
    clips (the canonical UCF finetune batch) and of 64 (bench.py's)."""
    rng = np.random.default_rng(8)
    _check_fused("clip", *_conv_inputs(dev, rng, n, *site), groups=1)


@pytest.mark.parametrize("site", [(16, 56, 64, 144, 64),
                                  (8, 28, 128, 288, 128),
                                  (4, 14, 256, 576, 256),
                                  (2, 7, 512, 1152, 512)])
@pytest.mark.parametrize("n", [16, 128])
def test_conv21d_kernels_in_two_bn_groups_of_other_pretrain_batches(
        dev, n, site):
    """K2/K3 at the pretrain step's four site shapes, in two BN groups: of
    8 clips (a grad_accum=2 microbatch at per-view batch 16) and of 64
    (bench_step's pretrain mode, per-view batch 64)."""
    rng = np.random.default_rng(10)
    _check_fused("clip", *_conv_inputs(dev, rng, n, *site), groups=2)


@pytest.mark.parametrize("shape", [(4, 1, 5, 32, 16, 16),
                                   (2, 3, 9, 16, 48, 32),
                                   (2, 2, 3, 16, 16, 16)])
def test_conv21d_taps9_edge_shapes(dev, shape):
    """K4a/K4b where a frame is smaller than a pixel tile, a tile crosses
    image rows, T = 1 leaves only the centre temporal tap, and Cin = 16."""
    rng = np.random.default_rng(3)
    _check_fused("taps9", *_conv_inputs(dev, rng, *shape))


@pytest.mark.parametrize("shape", [
    (16, 16, 28, 56, 64, 144, 64), (16, 8, 14, 28, 128, 288, 128),
    (16, 4, 7, 14, 256, 576, 256), (16, 2, 4, 7, 512, 1152, 512),
    (16, 2, 3, 7, 512, 1152, 512), (4, 16, 1, 9, 64, 144, 64)])
def test_conv21d_taps9_on_padded_h_shards(dev, shape):
    """K4a/K4b on the padded H shards of ``--shard_spatial`` (H rows of a
    W-wide frame plus one halo row above and below, zero columns at the
    sides; 16 clips of two per-view groups, R(2+1)D's shard shapes at
    112^2 over two ranks, and a one-row shard): one launch each, the plain
    version's statistics and output, and a backward through the plain
    chain."""
    n, t, h, w, cin, m, cout = shape
    rng = np.random.default_rng(h * w + cin)
    x = _t(rng.normal(size=(n, t, h + 2, w + 2, cin)), dev, torch.bfloat16)
    x[:, :, :, 0] = 0
    x[:, :, :, -1] = 0
    _, ws, wt, scale, bias = _conv_inputs(dev, rng, 1, 1, 1, cin, m, cout)
    before = dict(C.launches)
    x.requires_grad_(True)
    out, gm, gv = C.fused_st_conv(x, ws, wt, scale, bias, 2, 1e-5, "taps9",
                                  spatial=True)
    assert out.shape == (n, t, h, w, cout)
    assert {k: C.launches[k] - before[k] for k in C.launches} == {
        k: int(k in ("stats_taps9", "fwd_taps9")) for k in C.launches}
    pm, pv = C.reference_stats(x.detach(), ws, 2, padded=True)
    pout = C.reference_chain(x.detach(), ws, wt, scale, bias, gm, gv, 2,
                             padded=True)
    torch.testing.assert_close(gm, pm, rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(gv, pv, rtol=1e-2, atol=1e-3)
    torch.testing.assert_close(out.float(), pout.float(), rtol=0.1,
                               atol=0.05)
    (dx,) = torch.autograd.grad(out.float().square().sum(), x)
    assert dx.shape == x.shape and bool(torch.isfinite(dx).all())


@pytest.mark.parametrize("shape", [(8, 8, 28, 128, 288, 128),
                                   (4, 3, 9, 32, 48, 32),
                                   (2, 3, 9, 16, 48, 32)])
def test_conv21d_taps9_is_bitwise_the_clip_pair(dev, shape):
    """K4a/K4b are K2/K3 with the padded A source: the same K order and
    the same order of every sum, so on the same x the two tilings give
    bitwise the same statistics and output (conv3's widths, where K3 runs a
    cluster of 2; a ragged shape with a tile across image rows; and Cin =
    16, where the last K step is 16 rows)."""
    rng = np.random.default_rng(7)
    x, ws, wt, scale, bias = _conv_inputs(dev, rng, *shape)
    clip = C.fused_st_conv(x, ws, wt, scale, bias, 2, 1e-5, "clip")
    taps9 = C.fused_st_conv(x, ws, wt, scale, bias, 2, 1e-5, "taps9")
    for a, b in zip(clip, taps9):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [
    (2, 3, 7, 32, 16, 16),      # a tile spans both clips, of two BN groups
    (2, 1, 5, 32, 16, 16),      # T = 1: the centre temporal tap only; a
                                # frame smaller than a tile
    (4, 2, 6, 32, 48, 32),      # T = 2: a ring of two mid frames
    (2, 3, 7, 32, 560, 16),     # ragged last tile, three mid chunks, the
                                # last one ragged
    (2, 3, 14, 32, 288, 32),    # a cluster of 2 blocks per row tile, ragged
                                # last tile
    (4, 4, 14, 256, 576, 256),  # a cluster of 4 at conv4's widths
])
def test_conv21d_fwd_edge_shapes(dev, shape):
    """K3 where a tile spans two clips of different BN groups, a frame is
    smaller than a tile, T is 1 or 2, the last tile and the last mid chunk
    are ragged, and a row tile is split over a cluster of 2 or 4 blocks."""
    rng = np.random.default_rng(4)
    _check_fused("clip", *_conv_inputs(dev, rng, *shape))


def test_conv21d_fwd_plan_fills_each_sm_once(dev):
    """The plan's shared memory leaves one resident K3 block per SM at the
    conv2 site (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    plan = C.plan_fwd(32, 16, 56, 56, 64, 144, 64)
    assert C.fwd_occupancy(plan) == 1


@pytest.mark.parametrize("shape", [
    (2, 1, 7, 32, 16, 1),       # 7x7, T = 1, one group, M = 16, Cin = 32
    (4, 2, 14, 32, 48, 2),      # 14x14, T = 2, two groups
    (8, 1, 5, 32, 1152, 4),     # four groups of 50 rows: each ends mid-tile;
                                # M = 1152 in several chunks
    (4, 2, 7, 512, 1152, 2),    # conv5's widths
    (4, 3, 9, 64, 144, 4),      # conv2's widths, four groups of 243 rows
])
def test_conv21d_stats_edge_shapes(dev, shape):
    """K2 under every plan of stats_plans (row tiles of 32 to 128 rows,
    every chunk width, 3 or 4 stages) against the plain statistics, where
    frames are smaller than a tile, T is 1 or 2, groups are 1, 2 or 4 and
    end inside a tile, and M is 16 or 1152. Tolerances as chip_smoke.py."""
    n, t, hw, cin, m, groups = shape
    rng = np.random.default_rng(5)
    x, ws = _conv_inputs(dev, rng, n, t, hw, cin, m, 16)[:2]
    ws2 = ws.to(torch.bfloat16).reshape(9 * cin, m)
    pm, pv = C.reference_stats(x, ws, groups)
    for plan in C.stats_plans(n, t, hw, hw, cin, m, groups):
        before = C.launches["stats"]
        gm, gv = C.run_stats(x, ws2, groups, plan=plan)
        assert C.launches["stats"] == before + 1
        torch.testing.assert_close(gm, pm, rtol=1e-2, atol=1e-3)
        torch.testing.assert_close(gv, pv, rtol=1e-2, atol=1e-3)


def test_conv21d_stats_is_bitwise_deterministic(dev):
    """Two launches of K2 give bitwise the same statistics: a fixed order of
    sums throughout, no float atomics."""
    rng = np.random.default_rng(6)
    x, ws = _conv_inputs(dev, rng, 8, 4, 28, 128, 288, 16)[:2]
    ws2 = ws.to(torch.bfloat16).reshape(9 * 128, 288)
    first = C.run_stats(x, ws2, 2)
    for _ in range(3):
        again = C.run_stats(x, ws2, 2)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_conv21d_stats_plan_has_its_resident_blocks(dev):
    """At the pretrain step's four sites, K2's plan has the resident blocks
    per SM it assumes (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    for t, hw, cin, m in ((16, 56, 64, 144), (8, 28, 128, 288),
                          (4, 14, 256, 576), (2, 7, 512, 1152)):
        plan = C.plan_stats(32, t, hw, hw, cin, m, 2)
        assert C.stats_occupancy(plan) == C.STATS_PER_SM == 2


def test_conv21d_backward_runs_on_the_card(dev):
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(4, 4, 8, 8, 32)), dev,
           torch.bfloat16).requires_grad_(True)
    ws = _t(rng.normal(size=(3, 3, 32, 16)) * 0.1, dev,
            torch.float32).requires_grad_(True)
    wt = _t(rng.normal(size=(3, 16, 16)) * 0.1, dev, torch.float32)
    scale, bias = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    out, _, _ = C.fused_st_conv(x, ws, wt, scale, bias, 2)
    gx, gws = torch.autograd.grad(out.float().square().sum(), [x, ws])
    assert gx.dtype == torch.bfloat16 and gws.dtype == torch.float32
    assert torch.isfinite(gx.float()).all() and torch.isfinite(gws).all()


def _aug_args(dev, rng, n, t, h0, w0, null, box=None):
    frames = rng.integers(0, 256, (n, t, h0, w0, 3)).astype(np.uint8)
    if box is None:
        # boxes inside the frame, from a third of it to all of it
        bw = rng.uniform(w0 / 3, w0, n)
        bh = rng.uniform(h0 / 3, h0, n)
        box = np.stack([rng.uniform(0, 1, n) * (w0 - bw),
                        rng.uniform(0, 1, n) * (h0 - bh), bw, bh], 1)
    rotk = rng.integers(0, 4, n)
    flip = rng.integers(0, 2, n).astype(bool)
    if null:
        angle, sigma = np.zeros(n), np.zeros(n)
        factors = np.tile([1.0, 1.0, 1.0, 0.0], (n, 1))
        graymix = np.tile(np.eye(3), (n, t, 1, 1))
    else:
        angle, sigma = rng.uniform(-10, 10, n), rng.uniform(0.1, 2.0, n)
        factors = np.stack([rng.uniform(0.6, 1.4, n), rng.uniform(0.6, 1.4, n),
                            rng.uniform(0.6, 1.4, n),
                            rng.uniform(-0.1, 0.1, n)], 1)
        gray = np.eye(3)[rng.integers(0, 3, (n, t))][:, :, None, :]
        graymix = np.broadcast_to(gray, (n, t, 3, 3))
    return [_t(frames, dev), _t(box, dev, torch.float32),
            _t(rotk, dev, torch.int32), _t(angle, dev, torch.float32),
            _t(factors, dev, torch.float32), _t(graymix, dev, torch.float32),
            _t(sigma, dev, torch.float32), _t(flip, dev)]


# K5's tolerance against the plain float32 chain, by output dtype: half an
# ulp of the output type below |v| = 4 (bf16 7.8e-3, f16 9.8e-4), plus the
# float32 summation-order differences of the resample, blur and luma mean
# (about 1e-5 on normalised values: some 30 roundings of values <= 255,
# each within 2^-24 relative, over a scale of 127.5); f32 keeps that margin
# tenfold. This holds because the kernel rounds the resample's scale and
# sample positions as the plain version does on the card.
AUG_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-3, torch.float32: 1e-4}


def _check_augment(args, s, out_dtype=torch.bfloat16, norm="tf"):
    before = A.launches
    got = A.fused_augment_clips(*args, sample_size=s, norm_method=norm,
                                out_dtype=out_dtype)
    assert A.launches == before + 1 and got.dtype == out_dtype
    want = A.fused_augment_clips_plain(*args, sample_size=s,
                                       norm_method=norm,
                                       out_dtype=torch.float32)
    torch.testing.assert_close(got.float(), want, atol=AUG_TOL[out_dtype],
                               rtol=0)
    return got


@pytest.mark.parametrize("out_dtype", list(AUG_TOL))
@pytest.mark.parametrize("norm", ["tf", "imagenet"])
@pytest.mark.parametrize("null", [True, False])
def test_augment_kernel_matches_plain_version(dev, null, norm, out_dtype):
    """K5 at 16 x 128 x 171 -> 112 frames in each output dtype, at AUG_TOL."""
    rng = np.random.default_rng(2)
    _check_augment(_aug_args(dev, rng, 4, 16, 128, 171, null), 112,
                   out_dtype, norm)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw", [(336, 448), (400, 400), (256, 340)])
def test_augment_kernel_native_frames(dev, hw, out_dtype):
    """Frames 3x or more the output size on their longer side: resample
    rows of 17 to 21 taps, beyond the first kernel's cap of 16."""
    rng = np.random.default_rng(8)
    _check_augment(_aug_args(dev, rng, 3, 4, *hw, False), 112, out_dtype)


def test_augment_kernel_boxes_on_the_frame_edges(dev):
    """Boxes that are the whole frame, or touch its right and bottom edges,
    or its left and top ones: taps clamped at every edge of the frame."""
    h0, w0 = 128, 171
    box = np.array([[0.0, 0.0, w0, h0], [w0 - 70.5, h0 - 60.25, 70.5, 60.25],
                    [0.0, 0.0, 90.0, 100.0], [w0 - 171.0, 0.0, 171.0, 40.0]])
    rng = np.random.default_rng(9)
    for null in (True, False):
        args = _aug_args(dev, rng, 4, 3, h0, w0, null, box=box)
        _check_augment(args, 112, torch.float32)


def test_augment_kernel_is_bitwise_deterministic(dev):
    """Two launches write bitwise the same views: no atomics, fixed sums."""
    rng = np.random.default_rng(10)
    args = _aug_args(dev, rng, 4, 8, 128, 171, False)
    first = A.fused_augment_clips(*args, sample_size=112)
    for _ in range(2):
        assert torch.equal(first, A.fused_augment_clips(*args,
                                                        sample_size=112))


def test_augment_kernel_refuses_what_it_cannot_take(dev):
    """An S whose buffers do not fit one block's shared memory even beside
    a device-memory frame, and an integer dtype, raise ValueError before
    any launch; the Python copy of the kernel's shared-memory formula
    agrees with the kernel's own, with the frame in either place."""
    rng = np.random.default_rng(11)
    args = _aug_args(dev, rng, 2, 2, 128, 171, True)
    before = A.launches
    with pytest.raises(ValueError, match="sample_size 1200"):
        A.fused_augment_clips(*args, sample_size=1200)
    with pytest.raises(ValueError, match="int32"):
        A.fused_augment_clips(*args, sample_size=112, out_dtype=torch.int32)
    assert A.launches == before
    lib = A._lib()
    for s, w0 in ((112, 171), (112, 400), (112, 1920), (128, 171),
                  (130, 171), (140, 171), (32, 150), (224, 340),
                  (1200, 340)):
        assert lib.cstp_augment_frame_bytes(s) == A.frame_bytes(s)
        for smem_frame in (True, False):
            c = lib.cstp_augment_chunk_rows(s, w0, int(smem_frame))
            try:
                assert c == A.chunk_rows(s, w0, smem_frame)
            except ValueError:
                assert c == 0
                continue
            assert lib.cstp_augment_smem_bytes(
                s, w0, c, int(smem_frame)) == A.smem_bytes(s, w0, c,
                                                           smem_frame)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_augment_kernel_at_sample_size_224(dev, out_dtype):
    """K5 at I3D's S = 224 from native 256x340 frames, whose f32 frame does
    not fit shared memory: the device-memory frame, at AUG_TOL. With a
    scratch of one clip per launch too, so the clips are walked in several
    launches."""
    rng = np.random.default_rng(12)
    args = _aug_args(dev, rng, 3, 4, 256, 340, False)
    assert A.launch_plan(3, 4, 224, 340)[1] == 3
    got = _check_augment(args, 224, out_dtype)
    scratch_bytes = A.SCRATCH_BYTES
    try:
        A.SCRATCH_BYTES = 4 * A.frame_bytes(224)
        assert A.launch_plan(3, 4, 224, 340)[1] == 1
        assert torch.equal(got, _check_augment(args, 224, out_dtype))
    finally:
        A.SCRATCH_BYTES = scratch_bytes


def test_augment_kernel_on_a_float32_pretrain_step(dev):
    """The trainer's path that used to raise on the card: compute_dtype
    float32 with pallas_augment "on" hands out_dtype float32 to K5, which
    launches once for the step; the loss is finite."""
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    b, t, s, h0, w0 = 4, 4, 32, 40, 53
    cfg = Config(model_name="r21d", model_depth=1, sample_duration=t,
                 sample_size=s, batch_size=b, compute_dtype="float32",
                 fused_conv=0, pallas_augment="on",
                 task="loss_com").finalize()
    model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
    step = make_pretrain_step(model, tx, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)

    def labels(k):
        return torch.randint(0, k, (b,), generator=gen, device=dev)

    batch = dict(frames1=torch.randint(0, 256, (b, t, h0, w0, 3),
                                       generator=gen, device=dev,
                                       dtype=torch.uint8),
                 frames2=torch.randint(0, 256, (b, t, h0, w0, 3),
                                       generator=gen, device=dev,
                                       dtype=torch.uint8),
                 rot1=labels(4), rot2=labels(4), tem=labels(5), pb=labels(5))
    before = A.launches
    state, metrics = step(state, gen, batch, cfg.learning_rate)
    assert A.launches == before + 1
    assert torch.isfinite(metrics["loss"]).item()


def test_finetune_step_with_a_frozen_prefix_on_the_card(dev):
    """One ft_begin_index=3 finetune step with fused sites on the card: 5 +
    5 K2/K3 launches (the frozen stages still run their forward in train
    mode), the frozen leaves (stem, cls_bn's affine parameters, conv2,
    conv3) bitwise unchanged, every trainable leaf moved, the frozen
    stages' BN running statistics moved, a finite loss."""
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.train import finetune as ft
    from cstp_tpu_torch.train.optim import is_frozen

    b, t, s = 8, 4, 32
    cfg = Config(model_name="r21d", model_depth=1, sample_duration=t,
                 sample_size=s, batch_size=b, compute_dtype="bfloat16",
                 fused_conv=1, task="scratch", ft_begin_index=3).finalize()
    model, state, tx = ft.create_finetune_state(cfg, 11, seed=0, device=dev)
    frozen = ft.finetune_frozen_prefixes(cfg)
    step = ft.make_finetune_step(model, tx, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = dict(frames=torch.randint(0, 256, (b, t, 40, 48, 3),
                                      generator=gen, device=dev,
                                      dtype=torch.uint8),
                 labels=torch.randint(0, 11, (b,), generator=gen,
                                      device=dev))
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    s0 = {n: v.clone() for n, v in model.named_buffers()}
    before = dict(C.launches)
    state, metrics = step(state, gen, batch, cfg.learning_rate)
    assert C.launches["stats"] - before["stats"] == 5
    assert C.launches["fwd"] - before["fwd"] == 5
    assert torch.isfinite(metrics["loss"]).item()
    for n, p in model.named_parameters():
        if is_frozen(n, frozen):
            assert torch.equal(p, p0[n]), n
        else:
            assert not torch.equal(p, p0[n]), n
    assert not torch.equal(model.online_net.conv2.block1.conv1.bn.mean,
                           s0["online_net.conv2.block1.conv1.bn.mean"])
    assert not torch.equal(model.cls_bn.var, s0["cls_bn.var"])


def test_prefetched_batches_are_the_host_batches(dev):
    """prefetch_to_device on the card: each batch lands through the pinned
    ring and the side stream equal to its host arrays, in order, on the
    card; an echoed batch (the same host object) reuses the landed
    tensors."""
    from cstp_tpu_torch.data.loader import PretrainLoader, prefetch_to_device
    from cstp_tpu_torch.data.synthetic import SyntheticVideoDataset

    ds = SyntheticVideoDataset(n_videos=12, n_classes=5, ingest_hw=(40, 53))
    host = list(PretrainLoader(ds, 3, 8, seed=1, num_workers=2,
                               echo=2).epoch(1))
    got = list(prefetch_to_device(iter(host), dev, depth=2))
    assert len(got) == len(host) == 8
    for g, h in zip(got, host):
        for k in h:
            assert g[k].device.type == "cuda"
            np.testing.assert_array_equal(g[k].cpu().numpy(), h[k])
    for a, b in zip(got[::2], got[1::2]):
        assert a is b and all(a[k] is b[k] for k in a)


def test_a_two_step_pretrain_loop_with_the_kernels(dev, tmp_path):
    """run_pretrain on the card with K2/K3 (fused_conv=1) and K5
    (pallas_augment="on") at a small size: 2 steps, 10 + 10 + 1 launches a
    step, a finite CSV row and the checkpoint."""
    import csv
    import os

    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.train.loops import run_pretrain

    cfg = Config(model_name="r21d_byol", model_depth=1, sample_duration=4,
                 sample_size=32, batch_size=4, compute_dtype="bfloat16",
                 fused_conv=1, pallas_augment="on", data_backend="synthetic",
                 synthetic_len=8, n_epochs=1, ckpt_every_epochs=1,
                 learning_rate=0.03, result_path=str(tmp_path),
                 n_workers=2, log_every=0).finalize()
    before, aug = dict(C.launches), A.launches
    out = run_pretrain(cfg)
    assert C.launches["stats"] - before["stats"] == 20
    assert C.launches["fwd"] - before["fwd"] == 20
    assert A.launches - aug == 2
    log_dir = tmp_path / "UCF101" / "loss_com"
    assert (log_dir / "save_1").is_dir()
    logs = [f for f in os.listdir(log_dir) if f.endswith(".log")]
    rows = list(csv.reader(open(log_dir / logs[0]), delimiter="\t"))
    assert len(rows) == 2
    assert all(np.isfinite(float(c)) for c in rows[1])
    assert out["timing"][0]["steps"] == 2


def _flag_config(**over):
    from cstp_tpu_torch.config import Config

    kw = dict(model_name="r21d", model_depth=1, sample_duration=4,
              sample_size=32, batch_size=8, compute_dtype="bfloat16",
              fused_conv=1, pallas_augment="on", task="loss_com")
    kw.update(over)
    return Config(**kw).finalize()


def _flag_step(dev, cfg, n_pb=5, hw=(40, 53)):
    """One pretrain step of ``cfg`` from seed-0 weights on a seeded batch
    of ``hw`` frames (playback labels below ``n_pb``): (metrics, BN
    buffers after it, K2/K3/K5 launches)."""
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    b, t = cfg.batch_size, cfg.sample_duration
    model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def labels(k):
        return torch.randint(0, k, (b,), generator=gen, device=dev)

    batch = dict(frames1=torch.randint(0, 256, (b, t, *hw, 3),
                                       generator=gen, device=dev,
                                       dtype=torch.uint8),
                 frames2=torch.randint(0, 256, (b, t, *hw, 3),
                                       generator=gen, device=dev,
                                       dtype=torch.uint8),
                 rot1=labels(4), rot2=labels(4), tem=labels(5),
                 pb=labels(n_pb))
    before, aug = dict(C.launches), A.launches
    state, m = make_pretrain_step(model, tx, cfg)(state, gen, batch,
                                                  cfg.learning_rate)
    torch.cuda.synchronize()
    counts = (C.launches["stats"] - before["stats"],
              C.launches["fwd"] - before["fwd"], A.launches - aug)
    return ({k: float(v) for k, v in m.items()},
            {n: v.clone() for n, v in model.named_buffers()}, counts)


def test_per_view_calls_with_kernels_match_the_plain_path(dev):
    """--concat_views 0 with K2/K3/K5: 4 tower calls x 5 fused sites, one
    BN group of the per-view batch each, and one K5 launch; the loss terms
    within 2e-2 of the plain bf16 step's from the same weights, generator
    and frames (phase 4's rule in chip_smoke.py)."""
    mk, _, counts = _flag_step(dev, _flag_config(concat_views=0))
    mp, _, plain = _flag_step(dev, _flag_config(
        concat_views=0, fused_conv=0, pallas_augment="off"))
    assert counts == (20, 20, 1) and plain == (0, 0, 0)
    for k in mk:
        assert np.isfinite(mk[k]), k
        if k.startswith("loss"):
            assert abs(mk[k] - mp[k]) <= 2e-2 * abs(mp[k]), k


@pytest.mark.parametrize("over, launches", [
    (dict(remat=True), 15), (dict(remat_policy="bnrelu"), 15),
    (dict(remat=True, concat_views=0), 30), (dict(fused_conv=2), 5)],
    ids=["remat", "bnrelu", "remat-concat_views0", "fused_conv2"])
def test_remat_and_fused_conv2_launch_counts(dev, over, launches):
    """The fused sites of the online tower recompute under remat (5 per
    tower call; under "bnrelu" too, since no policy can name the fused
    site's output); fused_conv=2 fuses the target tower only."""
    m, _, counts = _flag_step(dev, _flag_config(**over))
    assert counts == (launches, launches, 1)
    assert np.isfinite(m["loss"])


@pytest.mark.parametrize("over", [dict(remat=True),
                                  dict(remat_policy="bnrelu")],
                         ids=["remat", "bnrelu"])
def test_remat_leaves_the_running_statistics_as_without_it(dev, over):
    """The recompute in the backward pass restores the BN running
    statistics: after one step they are bitwise those of the step without
    remat (they come from the forward alone, which is the same); the loss
    terms agree within 2e-2."""
    m0, stats0, _ = _flag_step(dev, _flag_config())
    m1, stats1, _ = _flag_step(dev, _flag_config(**over))
    assert stats1.keys() == stats0.keys()
    for n, v in stats0.items():
        assert torch.equal(stats1[n], v), n
    for k in m0:
        if k.startswith("loss"):
            assert abs(m1[k] - m0[k]) <= 2e-2 * abs(m0[k]), k


@pytest.mark.parametrize("model_name, depth, shortcut", [
    ("c3d_byol", 1, "B"), ("r3d_byol", 18, "B"), ("r3d_byol", 18, "A")],
    ids=["c3d", "r3d18-B", "r3d18-A"])
def test_family_pretrain_steps_with_k5_match_the_plain_path(
        dev, model_name, depth, shortcut):
    """C3D and r3d-18 pretrain steps with K5 (``pallas_augment`` on, and
    ``fused_conv`` 1, which these families ignore) launch 0/0/1; the plain
    step 0/0/0; loss terms within 2e-2 of the plain bf16 step's from the
    same weights, generator and frames (phase 4's rule in
    chip_smoke.py). 8 frames: C3D pools time three times; playback labels
    below 4, the loader's range (these families' heads have 4 classes)."""
    over = dict(model_name=model_name, model_depth=depth,
                resnet_shortcut=shortcut, sample_duration=8)
    mk, _, counts = _flag_step(dev, _flag_config(**over), n_pb=4)
    mp, _, plain = _flag_step(dev, _flag_config(
        fused_conv=0, pallas_augment="off", **over), n_pb=4)
    assert counts == (0, 0, 1) and plain == (0, 0, 0)
    for k in mk:
        assert np.isfinite(mk[k]), k
        if k.startswith("loss"):
            assert abs(mk[k] - mp[k]) <= 2e-2 * abs(mp[k]), k


@pytest.mark.parametrize("model_name, size, hw", [
    ("s3d_byol", 112, (128, 171)), ("i3d_byol", 224, (256, 340))],
    ids=["s3d-112", "i3d-224"])
def test_inception_pretrain_steps_with_k5_match_the_plain_path(
        dev, model_name, size, hw):
    """S3D-G and I3D pretrain steps at 16 frames, per-view batch 16, with
    K5 (``fused_conv`` 1, which these families ignore) launch 0/0/1 and the
    plain step 0/0/0; loss terms within 2e-2 of the plain bf16 step's
    (phase 4's rule). At 224^2 from 256x340 frames K5 keeps its frame in
    device memory and its one call makes two launches for the 32 clips (27,
    then 5): the counter counts the call."""
    over = dict(model_name=model_name, sample_duration=16,
                sample_size=size, batch_size=16)
    mk, _, counts = _flag_step(dev, _flag_config(**over), n_pb=4, hw=hw)
    mp, _, plain = _flag_step(dev, _flag_config(
        fused_conv=0, pallas_augment="off", **over), n_pb=4, hw=hw)
    assert counts == (0, 0, 1) and plain == (0, 0, 0)
    for k in mk:
        assert np.isfinite(mk[k]), k
        if k.startswith("loss"):
            assert abs(mk[k] - mp[k]) <= 2e-2 * abs(mp[k]), k


@pytest.mark.parametrize("model_name, depth", [("c3d_byol", 1),
                                               ("r3d_byol", 18)])
def test_a_reference_pth_loads_on_the_card_bitwise(dev, tmp_path,
                                                   model_name, depth):
    """A pretrain state exported to a reference .pth, then laid over a
    finetune model on the card: its ``online_net`` tensors bitwise."""
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.models import torch_import
    from cstp_tpu_torch.models.bridge import export_state_dict
    from cstp_tpu_torch.train import finetune as ft
    from cstp_tpu_torch.train.pretrain import create_pretrain_state

    kw = dict(model_name=model_name, model_depth=depth, sample_duration=8,
              sample_size=32, batch_size=4, compute_dtype="bfloat16")
    model, _, _ = create_pretrain_state(
        Config(task="loss_com", **kw).finalize(), seed=1, device=dev)
    path = str(tmp_path / "save_1.pth")
    torch_import.save_torch_checkpoint(
        path, export_state_dict(model.state_dict()), model_name)
    cls, _, _ = ft.create_finetune_state(
        Config(task="ft_all", **kw).finalize(), 11, seed=2, device=dev)
    tree, meta = torch_import.load_torch_checkpoint(path, model_name)
    torch_import.load_into(cls, tree)
    assert meta["arch"] == model_name
    got, want = cls.state_dict(), model.state_dict()
    online = [n for n in want if n.startswith("online_net.")]
    assert online and all(got[n].device.type == "cuda" for n in online)
    for n in online:
        assert torch.equal(got[n], want[n]), n


# K6 (csrc/int8_conv.cu): (Cin, Cout, kernel, stride, (lo pads), (hi pads)):
# the R(2+1)D stem's spatial conv (Cin 3), its odd mid widths, the strided
# (2+1)D downsample, an I3D TF-SAME stem (asymmetric pads), a 1x1x1 conv
# and a wide C3D-like 3x3x3 conv (the 16-byte gather path)
K6_CASES = [
    (3, 83, (1, 7, 7), (1, 2, 2), (0, 3, 3), (0, 3, 3)),
    (83, 64, (3, 1, 1), (1, 1, 1), (1, 0, 0), (1, 0, 0)),
    (64, 42, (1, 1, 1), (1, 2, 2), (0, 0, 0), (0, 0, 0)),
    (42, 128, (1, 1, 1), (2, 1, 1), (0, 0, 0), (0, 0, 0)),
    (128, 230, (1, 3, 3), (1, 2, 2), (0, 1, 1), (0, 1, 1)),
    (3, 64, (7, 7, 7), (2, 2, 2), (2, 2, 2), (3, 3, 3)),
    (192, 96, (1, 1, 1), (1, 1, 1), (0, 0, 0), (0, 0, 0)),
    (256, 256, (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
]


@pytest.mark.parametrize("case", K6_CASES, ids=[
    "stem-cin3", "temporal-cin83", "down-spatial", "down-temporal",
    "spatial-stride2", "i3d-stem-asym", "i3d-1x1", "c3d-3x3x3"])
def test_k6_matches_its_plain_version_bitwise(dev, case):
    """K6's int32 accumulators and its bf16 and f32 outputs equal the plain
    version's bitwise (the sums are exact, the epilogue rounds once); one
    launch per call."""
    from cstp_tpu_torch.ops import quant as Q

    cin, cout, k, stride, lo, hi = case
    rng = np.random.default_rng(cin + cout)
    xq = _t(rng.integers(-127, 128, (2, 6, 15, 15, cin)), dev, torch.int8)
    wq = _t(rng.integers(-127, 128, (cout, cin, *k)), dev, torch.int8)
    scale = _t(rng.uniform(1e-5, 1e-3, cout), dev, torch.float32)
    for out_dtype in (torch.int32, torch.bfloat16, torch.float32):
        before = Q.launches
        got = torch.ops.cstp.int8_conv3d(xq, wq, scale, list(stride),
                                         list(lo), list(hi), out_dtype)
        torch.cuda.synchronize()
        assert Q.launches == before + 1
        want = Q.int8_conv3d_plain(xq, wq, scale, list(stride), list(lo),
                                   list(hi), out_dtype)
        assert got.dtype == out_dtype and got.shape == want.shape
        assert torch.equal(got, want), out_dtype


# K6 on the halo-extended H shards of --shard_spatial in C3D and the
# 3D-ResNets: (Cin, Cout, kernel, stride, padding, bias, frame rows); the
# stem's 30 rows give rank 1 the odd first row 15
K6_SHARD_SITES = {"c3d-3x3x3-bias": (64, 128, 3, 1, 1, True, 16),
                  "r3d-stem-7x7x7-s122": (3, 64, 7, (1, 2, 2), 3, False, 30)}


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("site", sorted(K6_SHARD_SITES))
def test_k6_on_a_halo_extended_shard_is_bitwise(dev, site, rank):
    """A ``--quant int8`` conv site of C3D (3x3x3 with its bias added
    after the int8 conv) and r3d's Cin-3 7x7x7 stride-(1, 2, 2) stem on
    rank ``rank``'s halo-extended rows of a frame split over two 'model'
    ranks (zeros outside the frame; the scale the whole frame's, as the
    maximum over the ranks gives it): one K6 launch, bitwise its plain
    version on the same s8 input, and bitwise the rows of the conv on the
    whole frame."""
    from cstp_tpu_torch.models.layers import Conv3d
    from cstp_tpu_torch.ops import quant as Q
    from cstp_tpu_torch.parallel.mesh import SpatialShard, halo_plan

    cin, cout, k, stride, p, bias, h = K6_SHARD_SITES[site]
    conv = Conv3d(cin, cout, k, stride, p, torch.bfloat16,
                  gen=torch.Generator().manual_seed(0), use_bias=bias,
                  quant="int8").to(dev)
    if bias:
        with torch.no_grad():
            conv.bias.uniform_(-1, 1)
    rng = np.random.default_rng(rank)
    x = _t(rng.normal(size=(2, 8, h, 20, cin)), dev, torch.bfloat16)
    with torch.no_grad():
        whole = conv(x)
        shard = SpatialShard(h, rank, 2)
        lo, hi, _ = halo_plan(shard, 1, conv.h_window[0], conv.h_window[1],
                              p)
        ext = torch.zeros((2, 8, hi - lo, 20, cin), dtype=x.dtype,
                          device=dev)
        a, b = max(lo, 0), min(hi, h)
        ext[:, :, a - lo:b - lo] = x[:, :, a:b]
        calls, real = [], Q.int8_conv3d_cuda

        def recording(*args):
            calls.append(args)
            return real(*args)

        Q.int8_conv3d_cuda = recording
        try:
            got = conv(ext, h_halo=True, held=x)
        finally:
            Q.int8_conv3d_cuda = real
        torch.cuda.synchronize()
    assert len(calls) == 1
    (xq, *rest), = calls
    assert xq.shape[2] == hi - lo and (rank == 0) == (lo < 0)
    assert torch.equal(real(xq, *rest), Q.int8_conv3d_plain(xq, *rest))
    o0, o1 = shard.rows(conv.h_window[1])
    assert torch.equal(got, whole[:, :, o0:o1])


def test_k6_refuses_what_it_does_not_take(dev):
    from cstp_tpu_torch.ops import quant as Q

    xq = torch.zeros((1, 2, 4, 4, 3), dtype=torch.int8, device=dev)
    wq = torch.zeros((5, 3, 1, 3, 3), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="int8"):
        Q.int8_conv3d_cuda(xq.float(), wq, torch.ones(5, device=dev),
                           [1, 1, 1], [0, 1, 1], [0, 1, 1])
    with pytest.raises(ValueError, match="CUDA"):
        Q.int8_conv3d_cuda(xq, wq.cpu(), torch.ones(5), [1, 1, 1],
                           [0, 1, 1], [0, 1, 1])


def test_int8_static_classify_on_the_card_matches_the_plain_path(dev):
    """An R(2+1)D ``int8_static`` eval forward in bf16: through K6 on the
    card (24 launches) and through the plain version on the same bf16
    inputs on the CPU, bitwise at every site's accumulator, so the logits
    agree to float rounding of the float ops between the convs."""
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.ops import quant as Q
    from cstp_tpu_torch.perf.bench_step import fill_act_scales
    from cstp_tpu_torch.train.finetune import create_classify_model

    cfg = Config(model_name="r21d", sample_duration=8, sample_size=32,
                 quant="int8_static", task="test").finalize()
    model = create_classify_model(cfg, 11, device=dev)
    assert fill_act_scales(model) == 24
    x = _t(np.random.default_rng(0).uniform(-1, 1, (4, 8, 32, 32, 3)), dev,
           torch.bfloat16)
    before = Q.launches
    with torch.no_grad():
        got = model(x, train=False).float()
    torch.cuda.synchronize()
    assert Q.launches == before + 24
    assert torch.isfinite(got).all()
    cpu = create_classify_model(cfg, 11, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        want = cpu(x.cpu(), train=False).float()
    torch.testing.assert_close(got.cpu(), want, rtol=5e-2, atol=5e-2)


def test_int8_pretrain_step_on_the_card_runs_k6(dev):
    """A ``--quant int8`` pretrain step at 8 x 32^2: K6 in both towers'
    forward (24 sites each), finite losses, a moved online tower."""
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.ops import launch_counts, reset_launch_counts
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    cfg = Config(model_name="r21d", sample_duration=8, sample_size=32,
                 batch_size=4, quant="int8", pallas_augment="on").finalize()
    model, state, tx = create_pretrain_state(cfg, device=dev)
    before = [p.detach().clone() for p in model.online_net.parameters()]
    step = make_pretrain_step(model, tx, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    batch = {k: _t(rng.integers(0, 256, (4, 8, 64, 80, 3)), dev, torch.uint8)
             for k in ("frames1", "frames2")}
    batch.update({k: _t(rng.integers(0, 4, (4,)), dev, torch.int64)
                  for k in ("rot1", "rot2", "tem", "pb")})
    reset_launch_counts()
    state, metrics = step(state, gen, batch, 0.03)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["int8_conv"] == 48 and counts["augment"] == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(p, b) for p, b in
               zip(model.online_net.parameters(), before))


# The storage chain (--quant int8_store): its 12 sites per R(2+1)D tower at
# 16 x 112^2, batch 4
def _store_sites():
    from cstp_tpu_torch.models.r21d import chain_sites

    return chain_sites(4, 16, 112)


def _site_ids():
    return [s[0] for s in _store_sites()]


def _store_inputs(dev, site, seed=0):
    """Random s8 input and spatial weights of ``site``, its scale, and the
    spatial conv's stride and pads."""
    from cstp_tpu_torch.models.layers import r21d_intermediate_channels

    _, shape, cout, k, stride, pad = site
    m = r21d_intermediate_channels(shape[-1], cout, k)
    rng = np.random.default_rng(seed)
    xq = _t(rng.integers(-127, 128, shape), dev, torch.int8)
    wq = _t(rng.integers(-127, 128, (m, shape[-1], 1, k[1], k[2])), dev,
            torch.int8)
    scale = _t(rng.uniform(1e-5, 1e-3, m), dev, torch.float32)
    geo = ([1, stride[1], stride[2]], [0, pad[1], pad[2]],
           [0, pad[1], pad[2]])
    return xq, wq, scale, geo


@pytest.mark.parametrize("site", range(12), ids=_site_ids())
def test_k6_storage_epilogue_matches_its_plain_version_bitwise(dev, site):
    """K6 with the storage epilogue at each chain site: hq, the int64 sums
    of hq and hq^2 per (sample, channel) and the absmax equal the plain
    version's bitwise (integers and a maximum); one launch per call, none
    of the dequantizing kind; without observing, the absmax stays 0."""
    from cstp_tpu_torch.ops import quant as Q

    xq, wq, scale, geo = _store_inputs(dev, _store_sites()[site])
    _, _, _, amax = Q.int8_conv3d_store_plain(xq, wq, scale,
                                              torch.ones((), device=dev),
                                              *geo)
    # a mid scale that clips every value above half the absmax
    s_mid = (amax / 254.0).reshape(())
    for observe in (True, False):
        before = (Q.launches, Q.store_launches)
        got = Q.int8_conv3d_store(xq, wq, scale, s_mid, *geo, observe)
        torch.cuda.synchronize()
        assert (Q.launches, Q.store_launches) == (before[0], before[1] + 1)
        want = Q.int8_conv3d_store_plain(xq, wq, scale, s_mid, *geo,
                                         observe)
        for name, a, b in zip(("hq", "sums", "sq_sums", "amax"), got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), (name, observe)
        assert int(got[0].abs().max()) == 127


@pytest.mark.parametrize("site", range(12), ids=_site_ids())
def test_k7_matches_its_plain_version_bitwise(dev, site):
    """K7 at each chain site's mid (N, T, Ho, Wo, M): yq and max y1 equal
    the plain version's bitwise (every operation rounded on its own, in
    the same order); one launch per call."""
    from cstp_tpu_torch.models.layers import r21d_intermediate_channels
    from cstp_tpu_torch.ops import quant as Q

    _, shape, cout, k, stride, pad = _store_sites()[site]
    m = r21d_intermediate_channels(shape[-1], cout, k)
    n, t, h = shape[0], shape[1], shape[2]
    ho = (h + 2 * pad[1] - k[1]) // stride[1] + 1
    rng = np.random.default_rng(site)
    hq = _t(rng.integers(-127, 128, (n, t, ho, ho, m)), dev, torch.int8)
    mean = _t(rng.normal(size=(n, m)) * 0.1, dev, torch.float32)
    inv = _t(rng.uniform(0.5, 2.0, (n, m)), dev, torch.float32)
    gamma = _t(1 + 0.2 * rng.normal(size=m), dev, torch.float32)
    beta = _t(0.2 * rng.normal(size=m), dev, torch.float32)
    s_mid = torch.tensor(0.013, device=dev)
    s_act = torch.tensor(0.011, device=dev)
    for observe in (True, False):
        before = Q.bnrelu_launches
        got = Q.bn_relu_requant(hq, s_mid, mean, inv, gamma, beta, s_act,
                                observe)
        torch.cuda.synchronize()
        assert Q.bnrelu_launches == before + 1
        want = Q.bn_relu_requant_plain(hq, s_mid, mean, inv, gamma, beta,
                                       s_act, observe)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(got[0].max()) == 127 and int(got[0].min()) == 0


def test_k7_takes_unaligned_and_ragged_tensors(dev):
    """A view 1 byte into its storage (no 16-byte vectors) and an element
    count that is no multiple of 16: still bitwise the plain version."""
    from cstp_tpu_torch.ops import quant as Q

    rng = np.random.default_rng(1)
    n, m = 3, 83
    buf = _t(rng.integers(-127, 128, 1 + n * 5 * 7 * 7 * m), dev, torch.int8)
    hq = buf[1:].view(n, 5, 7, 7, m)
    args = (torch.tensor(0.02, device=dev),
            _t(rng.normal(size=(n, m)) * 0.1, dev, torch.float32),
            _t(rng.uniform(0.5, 2.0, (n, m)), dev, torch.float32),
            torch.ones(m, device=dev), torch.zeros(m, device=dev),
            torch.tensor(0.02, device=dev))
    got = Q.bn_relu_requant_cuda(hq, *args)
    want = Q.bn_relu_requant_plain(hq, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="K7"):
        Q.bn_relu_requant_cuda(hq, args[0], args[1][:, :5], *args[2:])


def test_int8_store_pretrain_step_on_the_card(dev):
    """A ``--quant int8_store`` pretrain step at 8 x 32^2 with K5: the
    bootstrap launches nothing, the step 24 K6 with the storage epilogue,
    24 K7 and 24 dequantizing K6 (12 sites per tower); every scale is
    positive and the losses finite. The same step with the plain versions
    in the kernels' place gives bitwise the same forward (loss terms,
    scales, running statistics: the kernels are bitwise their plain
    versions) and the same update to cosine 0.9999 (cuDNN's bf16 backward
    convs may sum in another order from run to run)."""
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.ops import launch_counts, reset_launch_counts
    from cstp_tpu_torch.ops import quant as Q
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    cfg = Config(model_name="r21d", sample_duration=8, sample_size=32,
                 batch_size=4, quant="int8_store",
                 pallas_augment="on").finalize()
    rng = np.random.default_rng(0)
    batch = {k: _t(rng.integers(0, 256, (4, 8, 64, 80, 3)), dev, torch.uint8)
             for k in ("frames1", "frames2")}
    batch.update({k: _t(rng.integers(0, 4, (4,)), dev, torch.int64)
                  for k in ("rot1", "rot2", "tem", "pb")})

    def run():
        model, state, tx = create_pretrain_state(cfg, device=dev)
        sd0 = {k: v.clone() for k, v in model.state_dict().items()}
        step = make_pretrain_step(model, tx, cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_launch_counts()
        state, metrics = step(state, gen, batch, 0.03)
        torch.cuda.synchronize()
        sd = model.state_dict()
        update = torch.cat([(v - sd0[k]).double().flatten()
                            for k, v in sd.items() if v.is_floating_point()
                            and v.dim() > 0 and k.startswith("online_net")
                            and not k.endswith(("mean", "var"))])
        return sd, metrics, launch_counts(), update

    sd, metrics, counts, update = run()
    assert (counts["int8_conv"], counts["int8_conv_store"],
            counts["int8_bn_relu"], counts["augment"]) == (24, 24, 24, 1)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    scales = [v for k, v in sd.items() if "act_scale" in k]
    assert len(scales) == 72 and all(float(v) > 0 for v in scales)
    real = (Q.int8_conv3d_cuda, Q.int8_conv3d_store_cuda,
            Q.bn_relu_requant_cuda)
    try:
        Q.int8_conv3d_cuda = Q.int8_conv3d_plain
        Q.int8_conv3d_store_cuda = Q.int8_conv3d_store_plain
        Q.bn_relu_requant_cuda = Q.bn_relu_requant_plain
        sd_plain, metrics_plain, counts_plain, update_plain = run()
    finally:
        (Q.int8_conv3d_cuda, Q.int8_conv3d_store_cuda,
         Q.bn_relu_requant_cuda) = real
    assert counts_plain["int8_conv_store"] == counts_plain["int8_bn_relu"] \
        == 0
    for k, v in metrics.items():
        if k.startswith("loss"):
            assert torch.equal(v, metrics_plain[k]), k
    for k, v in sd.items():
        if k.endswith(("mean", "var")) or "act_scale" in k:
            assert torch.equal(v, sd_plain[k]), k
    assert float(torch.nn.functional.cosine_similarity(
        update, update_plain, dim=0)) >= 0.9999
