"""``--shard_spatial`` on C3D and the 3D-ResNets (``models/sharded.py``,
``models/c3d.py``, ``models/r3d.py``) on the CPU, with gloo ranks, each a
subprocess running this file as a script (``_shard_harness.worker``),
against the port's own one-process step on the global batch and against
the JAX package's (1, 2) mesh program from the same bridged weights and
views.

Sizes: C3D at 8 x 32^2 and 8 x 56^2 (where conv4b's pool sees 7 rows and
gives 3), per-view batch 2; r3d-10 with shortcuts "A" and "B" at 4 x 64^2,
per-view batch 4; float32, seed-0 weights made alike in every process.

What is held, and how:

* every new H site on (1, 2) shards (C3D's biased 3x3x3 conv and both
  VALID pools, r3d's 7x7x7 stride-(1, 2, 2) stem, its 3x3x3 stride-2
  ``-inf``-padded pool, a stride-2 3x3x3 conv, the 1x1x1 stride-2 conv of
  shortcut "B" and the subsample of "A"), also where a rank's first row
  is odd, equals the whole-frame op in the forward and in dx to 1e-6
  relative, the conv's summed dw to 1e-3 (JAX's bounds,
  ``tests/test_cross_topology.py``); the pool's rows at the frame's top
  and bottom are among them;
* one r3d-50 bottleneck block (stride 2, shortcut "B", its BatchNorms
  summing moments over the shards) in the forward and backward, to 1e-5
  relative (the moments' summation order);
* the (1, 2) pretrain steps of every model and the (2, 2) steps of C3D
  at 32^2 (with ``--shard_opt_state``) and r3d-10 "A" (``--sync_bn 0``)
  and "B" (``--grad_accum 2 --concat_views 0 --ntxent_weight 0.5``),
  against one process, with
  ``test_torch_port_model_axis``'s tolerances: the first loss within 1e-5
  relative, the update within 5e-2 leaf by leaf in norm, BN running
  statistics within 1e-4; the target tower (an EMA of the weights before
  the step) bitwise; every rank bitwise the same whole state;
* ``--quant int8`` on (1, 2) within ``INT8_LIMITS``, the limits
  ``test_torch_port_shard_flags`` set from what the BatchNorms' summation
  order alone moves a whole int8 step by;
* an r3d-10 finetune step and the eval logits on (1, 2) (the logits
  within 1e-5);
* JAX's (1, 2) ``--shard_spatial`` program for C3D at 56^2 and r3d-10 "B"
  with the float step's tolerances, outside ``JAX_MESH12_DEPARTS``.

The ranks and two one-process workers start in the background before the
JAX side compiles, every launch has its own timeout, and the temporary
directory is removed at the end. The workers import no JAX.
"""

import shutil
import sys

import numpy as np
import pytest
import torch

from _shard_harness import (
    ROOT,
    assert_ranks_agree,
    assert_stats_close,
    assert_step_close,
    assert_updates_close,
    cos,
    digest,
    is_stat,
    jax_steps,
    join,
    launch,
    randn,
    rel,
    split_state,
    to_torch,
    views,
    worker,
)

from _torch_threads import torch_threads  # noqa: F401

LR = 3e-4
N_CLASSES = 5
M12 = dict(mesh_shape=(1, 2), shard_spatial=1)
M22 = dict(mesh_shape=(2, 2), shard_spatial=1)
# model -> (its flags, frames, size, per-view batch)
MODELS = {
    "c3d32": (dict(model_name="c3d"), 8, 32, 2),
    "c3d56": (dict(model_name="c3d"), 8, 56, 2),
    "r3dA": (dict(model_name="r3d", model_depth=10, resnet_shortcut="A"),
             4, 64, 4),
    "r3dB": (dict(model_name="r3d", model_depth=10, resnet_shortcut="B"),
             4, 64, 4),
}
# the mesh steps: name -> (model, mesh flags, step flags)
STEPS = {
    "c3d32_12": ("c3d32", M12, {}),
    "c3d32_22": ("c3d32", M22, dict(shard_opt_state=1)),
    "c3d56_12": ("c3d56", M12, {}),
    "r3dA_12": ("r3dA", M12, {}),
    "r3dA_22": ("r3dA", M22, dict(sync_bn=0)),
    "r3dB_12": ("r3dB", M12, {}),
    "r3dB_22": ("r3dB", M22, dict(grad_accum=2, concat_views=0,
                                  ntxent_weight=0.5)),
    "c3d32_int8": ("c3d32", M12, dict(quant="int8")),
    "r3dB_int8": ("r3dB", M12, dict(quant="int8")),
}
FINETUNE = ("r3dB",)
# the processes, all started together: job -> (world size, its cases); a
# one-process job runs a step case's reference (its flags without the
# mesh's) and a mesh job the case itself on its ranks
JOBS = {
    "one_a": (1, ("c3d32_12", "c3d32_int8", "r3dA_12", "r3dA_22",
                  "block")),
    "one_b": (1, ("c3d56_12", "r3dB_12", "r3dB_22", "r3dB_int8",
                  "ft r3dB")),
    "mesh12a": (2, ("sites", "block", "c3d32_12", "c3d56_12")),
    "mesh12b": (2, ("r3dA_12", "r3dB_12", "c3d32_int8", "r3dB_int8",
                    "ft r3dB")),
    "mesh22": (4, ("c3d32_22", "r3dA_22", "r3dB_22")),
}
# the cases whose one-process reference is another case's (the mesh flags
# and --shard_opt_state change nothing there)
SAME_REFERENCE = {"c3d32_22": "c3d32_12"}
# (name, module, H): the H sites, each on (1, 2) shards of an (N, T, H, W,
# C) input; 10 and 14 rows give rank 1 the odd first row 5 and 7, 30 rows
# the stem's odd first input row 15
SITES = [
    ("c3d_conv_3x3x3_bias", ("conv", 4, 5, 3, 1, 1, True), 16),
    ("c3d_pool_1x2x2", ("pool", (1, 2, 2), (1, 2, 2), 0), 16),
    ("c3d_pool_2x2x2_odd", ("pool", 2, 2, 0), 10),
    ("c3d_pool_2x2x2_7rows", ("pool", 2, 2, 0), 7),
    ("r3d_stem_7x7x7_s122", ("conv", 3, 5, 7, (1, 2, 2), 3, False), 32),
    ("r3d_stem_odd", ("conv", 3, 5, 7, (1, 2, 2), 3, False), 30),
    ("r3d_pool_3x3x3_s2", ("pool", 3, 2, 1), 16),
    ("r3d_pool_3x3x3_s2_odd", ("pool", 3, 2, 1), 14),
    ("r3d_conv_3x3x3_s2", ("conv", 4, 5, 3, 2, 1, False), 14),
    ("r3d_B_1x1x1_s2", ("conv", 4, 5, 1, 2, 0, False), 14),
    ("r3d_A_subsample_s2", ("subsample", 2), 14),
]
# the whole int8 steps against one process, as in
# tests/test_torch_port_shard_flags.py (1.5 times the largest departure
# that the one-process step with only its BatchNorm sums reordered showed
# there): (loss terms rtol, 1 - the update's cosine, BN running statistics
# over their leaf's largest value)
INT8_LIMITS = (1.04e-2, 1.1e-4, 0.077)
BLOCK_H = 14            # the bottleneck block's input rows, 7 a rank
# --grad_accum 2 on 2 data rows of 2 clips a view: data row r's microbatch
# k is clip 2 r + k, so the one-process step whose contiguous microbatches
# hold the same clips takes them in this order
ACCUM_ORDER = [0, 2, 1, 3]


# ------------------------------------------------ shared by both sides

def _config(model, **over):
    from cstp_tpu_torch.config import Config

    flags, t, s, b = MODELS[model]
    kw = dict(flags, sample_duration=t, sample_size=s, batch_size=b,
              compute_dtype="float32", learning_rate=LR)
    kw.update(over)
    return Config(**kw).finalize()


def _ft_config(model, **over):
    return _config(model, task="ft_all", n_finetune_classes=N_CLASSES,
                   **over)


def _pretrain_run(model, over, order=None):
    """One preaugmented pretrain step of ``_config(model, **over)`` on this
    rank's rows of the model's batch (its clips in ``order``), from the
    seed-0 weights."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_preaugmented_step,
    )

    cfg = _config(model, **over)
    net, state, tx = create_pretrain_state(cfg, device="cpu")
    step = make_preaugmented_step(net, tx, cfg)
    batch = _INPUTS["batch"][model]
    if order is not None:
        batch = {k: v[order] for k, v in batch.items()}
    state, m = step(state, mesh.shard_batch(batch), LR)
    sd = mesh.full_state_dict(net)
    out = split_state(sd)
    out.update(metrics={k: float(v) for k, v in m.items()},
               whole=digest(sd))
    return out


def _finetune_run(model):
    """One preaugmented finetune step and the eval logits on its clips."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train.finetune import (
        create_finetune_state,
        make_preaugmented_finetune_step,
    )

    cfg = _ft_config(model, **(M12 if mesh.is_distributed() else {}))
    net, state, tx = create_finetune_state(cfg, N_CLASSES, seed=3,
                                           device="cpu")
    step = make_preaugmented_finetune_step(net, tx, cfg)
    rows = mesh.shard_batch(_INPUTS["ft_batch"][model])
    state, m = step(state, rows, LR)
    with torch.no_grad():
        logits = net(rows["clips"], train=False)
    sd = mesh.full_state_dict(net)
    out = split_state(sd)
    out.update(metrics={k: float(v) for k, v in m.items()},
               whole=digest(sd), logits=logits)
    return out


def _site_module(spec, weights):
    from cstp_tpu_torch.models.layers import Conv3d, MaxPool3d, Subsample

    kind, *a = spec
    if kind == "pool":
        return MaxPool3d(*a)
    if kind == "subsample":
        return Subsample(*a)
    cin, cout, k, s, p, bias = a
    conv = Conv3d(cin, cout, k, s, p, torch.float32, use_bias=bias)
    with torch.no_grad():
        conv.weight.copy_(weights[0])
        if bias:
            conv.bias.copy_(weights[1])
    return conv


def _site_run(spec, x, weights):
    """The site on this 'model' rank's rows of ``x`` (its ``shard`` set):
    its output rows and the gradients of the summed ``sum(out^2)`` for
    this rank's input rows and (summed over the ranks) for its
    parameters."""
    from cstp_tpu_torch.parallel import mesh

    site = _site_module(spec, weights)
    ax = mesh.mesh_axis("model")
    h = x.shape[2]
    k, s, p = site.h_window
    shard = mesh.SpatialShard(h, ax.index, ax.size,
                              ((1, h), (s, (h + 2 * p - k) // s + 1)))
    site.shard = (shard, 1)
    lo, hi = shard.rows()
    xs = x[:, :, lo:hi].clone().requires_grad_(True)
    out = site(xs)
    params = list(site.parameters())
    grads = torch.autograd.grad(out.square().sum(), [xs] + params)
    dw = list(grads[1:])
    mesh.all_reduce_sum_(dw, "model")
    return dict(out=out.detach(), dx=grads[0], dw=dw, rows=(lo, hi),
                out_rows=shard.rows(s))


def _block_run(x, sd):
    """One r3d-50 bottleneck block (stride 2, shortcut "B") in train mode
    on this rank's rows of ``x`` (whole ``x`` without a group): its output
    rows and the gradients of ``sum(out^2)`` for ``x`` (non-zero on the
    rank's rows) and (summed over 'model') for the parameters."""
    from cstp_tpu_torch.models.r3d import _Bottleneck
    from cstp_tpu_torch.models.sharded import ShardedTower
    from cstp_tpu_torch.parallel import mesh

    class Tower(ShardedTower, torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.block = _Bottleneck(256, 128, 2, "B", torch.float32)

        def h_sites(self):
            return self.block.h_sites(1)

        def forward(self, x):
            if self.spatial:
                x = self.own_rows(x)
            return self.block(x, True)

    tower = Tower()
    tower.load_state_dict(sd)
    x = x.clone().requires_grad_(True)
    if mesh.is_distributed():
        tower.shard_spatially()
    out = tower(x)
    params = [p for _, p in sorted(tower.named_parameters())]
    grads = torch.autograd.grad(out.square().sum(), [x] + params)
    dw = list(grads[1:])
    mesh.all_reduce_sum_(dw, "model")
    return dict(out=out.detach(), dx=grads[0], dw=dw)


# ------------------------------------------------------------- workers

_INPUTS = {}


def _run(name):
    """Case ``name`` of JOBS on this process."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train import pretrain as pt_mod

    if name == "sites":
        return {n: _site_run(spec, *_INPUTS["sites"][n])
                for n, spec, _ in SITES}
    if name == "block":
        return _block_run(*_INPUTS["block"])
    if name.startswith("ft "):
        return _finetune_run(name[3:])
    model, m, over = STEPS[name]
    if mesh.is_distributed():
        return _pretrain_run(model, dict(m, **over))
    ref = {k: v for k, v in over.items() if k != "shard_opt_state"}
    with pytest.MonkeyPatch.context() as mp:
        if ref.get("sync_bn") == 0:
            # --sync_bn 0 on 2 data rows: a BN group per row and view
            mp.setattr(pt_mod, "local_bn_groups", lambda config: 2)
        return _pretrain_run(model, ref, ACCUM_ORDER if "grad_accum" in ref
                             else None)


# ---------------------------------------------------------- test side

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from cstp_tpu_torch.models.r3d import _Bottleneck
    from cstp_tpu_torch.train.finetune import create_finetune_state
    from cstp_tpu_torch.train.pretrain import create_pretrain_state

    tmp = tmp_path_factory.mktemp("shard_families")
    procs = {}
    threads = torch.get_num_threads()
    try:
        rng = np.random.default_rng(0)
        batch = {m: views(rng, *MODELS[m][1:]) for m in MODELS}
        ft_batch = {}
        for m in FINETUNE:
            _, t, s, b = MODELS[m]
            ft_batch[m] = dict(
                clips=rng.uniform(-1, 1, (b, t, s, s, 3)).astype(np.float32),
                labels=rng.integers(0, N_CLASSES, (b,)).astype(np.int64))
        sites = {}
        for name, spec, h in SITES:
            cin = spec[1] if spec[0] == "conv" else 4
            x = randn(rng, 2, 4, h, 6, cin)
            weights = ()
            if spec[0] == "conv":
                _, cin, cout, k, *_ = spec
                weights = (randn(rng, cout, cin, k, k, k),
                           randn(rng, cout))
            sites[name] = (x, weights)
        block = _Bottleneck(256, 128, 2, "B", torch.float32,
                            gen=torch.Generator().manual_seed(1))
        block_sd = {f"block.{k}": v for k, v in block.state_dict().items()}
        torch.save(dict(batch={m: to_torch(v) for m, v in batch.items()},
                        ft_batch={m: to_torch(v) for m, v in
                                  ft_batch.items()},
                        sites=sites,
                        block=(randn(rng, 2, 4, BLOCK_H, 6, 256),
                               block_sd)),
                   tmp / "inputs.pt")
        torch.set_num_threads(1)    # the workers and JAX share the cores
        procs = {job: launch(__file__, tmp, job, JOBS[job][0])
                 for job in JOBS}
        # the seed-0 weights (C3D's alike at both sizes) and the finetune
        # models' seed-3 weights
        nets, sd0 = {}, {}
        for m in ("c3d56", "r3dA", "r3dB"):
            nets[m], _, _ = create_pretrain_state(_config(m), device="cpu")
            sd0[m] = split_state(nets[m].state_dict())["params"]
        sd0["c3d32"] = sd0["c3d56"]
        for m in FINETUNE:
            net, _, _ = create_finetune_state(_ft_config(m), N_CLASSES,
                                              seed=3, device="cpu")
            sd0[f"ft {m}"] = split_state(net.state_dict())["params"]
        jax_runs = jax_steps({m: (m, (1, 2)) for m in ("c3d56", "r3dB")},
                             nets, batch, MODELS, LR)
        got = {job: join(group, tmp, job) for job, group in procs.items()}
    finally:
        torch.set_num_threads(threads)
        for p in (p for group in procs.values() for p in group):
            if p.poll() is None:
                p.kill()
                p.wait()
    one = dict(got.pop("one_a")[0])
    one.update(got.pop("one_b")[0])
    ranks = {case: got[job] for job in got for case in JOBS[job][1]}
    yield dict(sd0=sd0, one=one, jax=jax_runs, ranks=ranks, sites=sites)
    shutil.rmtree(tmp, ignore_errors=True)


def _whole_site(name, spec, x, weights):
    site = _site_module(spec, weights)
    x = x.clone().requires_grad_(True)
    out = site(x)
    params = list(site.parameters())
    grads = torch.autograd.grad(out.square().sum(), [x] + params)
    return out.detach(), grads[0], list(grads[1:])


@pytest.mark.parametrize("case", [c[0] for c in SITES])
def test_h_site_on_shards_is_the_whole_op(runs, case):
    """Each H site of C3D and the 3D-ResNets on two H shards (its halo
    rows fetched from the neighbour, ``-inf`` outside the frame for the
    pools) is the op on the whole frame: each rank's output rows and
    input-row gradients to 1e-6 relative, a conv's summed weight and bias
    gradients to 1e-3; with a rank whose first row is odd (10, 14 and 30
    rows) and a VALID pool on 7 rows (3 out, rows 0..3 on rank 0)."""
    _, spec, h = next(c for c in SITES if c[0] == case)
    out, dx, dw = _whole_site(case, spec, *runs["sites"][case])
    got = [r["sites"][case] for r in runs["ranks"]["sites"]]
    assert got[0]["out_rows"][0] == 0
    assert got[-1]["out_rows"][1] == out.shape[2]
    assert got[0]["out_rows"][1] == got[1]["out_rows"][0]
    if h in (10, 14, 30):
        assert got[1]["rows"][0] % 2 == 1, got[1]["rows"]
    if case.endswith("7rows"):
        assert [g["out_rows"] for g in got] == [(0, 2), (2, 3)]
    for g in got:
        (lo, hi), (o0, o1) = g["rows"], g["out_rows"]
        assert g["out"].shape[2] == o1 - o0
        assert rel(g["out"], out[:, :, o0:o1]) <= 1e-6, case
        assert rel(g["dx"], dx[:, :, lo:hi]) <= 1e-6, case
        assert len(g["dw"]) == len(dw)
        for a, b in zip(g["dw"], dw):
            assert rel(a, b) <= 1e-3, case


def test_bottleneck_block_on_shards(runs):
    """An r3d-50 bottleneck block (1x1x1, 3x3x3 stride 2, 1x1x1, the
    1x1x1 stride-2 shortcut "B", BatchNorms over the shards) on (1, 2):
    each rank's output rows, input-row gradients and the summed parameter
    gradients within 1e-5 relative of one process."""
    from cstp_tpu_torch.parallel import SpatialShard

    want = runs["one"]["block"]
    for r, rank in enumerate(runs["ranks"]["block"]):
        got = rank["block"]
        shard = SpatialShard(BLOCK_H, r, 2)
        (lo, hi), (o0, o1) = shard.rows(), shard.rows(2)
        assert rel(got["out"], want["out"][:, :, o0:o1]) <= 1e-5
        assert rel(got["dx"][:, :, lo:hi], want["dx"][:, :, lo:hi]) <= 1e-5
        assert len(got["dw"]) == len(want["dw"]) == 12
        for a, b in zip(got["dw"], want["dw"]):
            assert rel(a, b) <= 1e-5


@pytest.mark.parametrize("case", [n for n, (_, _, over) in STEPS.items()
                                  if "quant" not in over])
def test_pretrain_steps_on_shards_match_one_process(runs, case):
    """(1, 2) --shard_spatial steps of C3D (8 x 32^2, and 8 x 56^2 where
    conv4b's pool takes 7 rows to 3) and r3d-10 "A" and "B" (4 x 64^2),
    and (2, 2) steps of C3D at 32^2 with --shard_opt_state, r3d-10 "A"
    with --sync_bn 0 and "B" with --grad_accum 2 --concat_views 0
    --ntxent_weight 0.5, against one process on the global batch with the
    same flags."""
    ranks = runs["ranks"][case]
    assert_ranks_agree(ranks, case)
    assert_step_close(ranks[0][case],
                      runs["one"][SAME_REFERENCE.get(case, case)],
                      runs["sd0"][STEPS[case][0]], case)


@pytest.mark.parametrize("case", ["c3d32_int8", "r3dB_int8"])
def test_int8_steps_on_shards_match_one_process(runs, case):
    """--quant int8 on (1, 2) H shards (K6's plain version here, every
    conv's dynamic scale a maximum over 'model' of the rows each rank
    holds) against one process, within ``INT8_LIMITS``: the loss terms, 1
    - the update's cosine, every BN running statistic over its leaf's
    largest value; the target tower bitwise, every rank the same state."""
    assert_ranks_agree(runs["ranks"][case], case)
    got, want = runs["ranks"][case][0][case], runs["one"][case]
    sd0 = runs["sd0"][STEPS[case][0]]
    assert all(np.isfinite(v) for v in got["metrics"].values())
    loss = max(abs(got["metrics"][k] / v - 1)
               for k, v in want["metrics"].items() if k.startswith("loss"))
    assert got["target"] == want["target"]

    def update(p):
        return torch.cat([(p[k] - sd0[k]).flatten().double()
                          for k in sorted(sd0)])

    dev = 1 - cos(update(got["params"]), update(want["params"]))
    stats = max(float((got["stats"][k] - v).abs().max() / v.abs().max())
                for k, v in want["stats"].items())
    for value, limit, what in zip((loss, dev, stats), INT8_LIMITS,
                                  ("loss", "1 - cosine", "statistics")):
        assert value <= limit, (case, what, value)


@pytest.mark.parametrize("model", FINETUNE)
def test_finetune_and_eval_on_shards(runs, model):
    """A finetune step and the eval forward under (1, 2) --shard_spatial
    against one process: the step within the sharded step's tolerances,
    the eval logits (the pool a sum over 'model') within 1e-5."""
    case = f"ft {model}"
    ranks = runs["ranks"][case]
    assert_ranks_agree(ranks, case)
    want = runs["one"][case]
    assert_step_close(ranks[0][case], want, runs["sd0"][case], case)
    for r in ranks:
        torch.testing.assert_close(r[case]["logits"], want["logits"],
                                   rtol=1e-5, atol=1e-5)


# JAX's own (1, 2) --shard_spatial programs of C3D and r3d-10 depart from
# their one-device programs in no BN running statistic beyond 1e-4 with
# this file's inputs; a leaf that did would be named here and held to the
# port's one-process step instead
# (``test_pretrain_steps_on_shards_match_one_process``)
JAX_MESH12_DEPARTS = ()


@pytest.mark.parametrize("model", ["c3d56", "r3dB"])
def test_mesh12_steps_match_jax_mesh12(runs, model):
    """The port's (1, 2) --shard_spatial step against JAX's train program
    on a (1, 2) mesh from the same weights and views: the first loss
    within 1e-5, the update within 5e-2 leaf by leaf, BN running
    statistics within 1e-4 outside ``JAX_MESH12_DEPARTS``."""
    case = f"{model}_12"
    got, want = runs["ranks"][case][0][case], runs["jax"][model]
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=1e-5)
    assert_updates_close(got["params"], want["params"], runs["sd0"][model],
                         5e-2, f"JAX (1, 2) {model}")
    skipped = assert_stats_close(got["stats"], want["stats"],
                                 f"JAX (1, 2) {model}", JAX_MESH12_DEPARTS)
    assert skipped == 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    worker(sys.argv[1], sys.argv[2], sys.argv[3], JOBS, _run, _INPUTS)
