"""``--shard_spatial`` on SlowFast and SlowFast-FB (``models/sharded.py``,
``models/slowfast.py``) on the CPU, with gloo ranks, each a subprocess
running this file as a script (``_shard_harness.worker``), against the
port's own one-process step on the global batch and against the JAX
package's one-device train program from the same bridged weights and
views.

Sizes: 8 fast frames of 64^2 at alpha 4 (2 slow frames), so the last
stage of both pathways has 2 rows, one a rank (at 32^2 it has one row,
and rank 1 would hold none: ``SpatialShard.check`` raises
``ValueError``); depth 18 and 50 at per-view batch 4 (at depth 50 and
per-view 2, two clips a BatchNorm group, the one-process step with only
its BatchNorm sums reordered departs from itself by 0.55 of the update's
tolerance, the (1, 2) step by 1.004); float32, seed-0 weights made alike
in every process.

What is held, and how:

* every kind of SlowFast H site on (1, 2) shards equals the whole-frame
  op in the forward and in dx to 1e-6 relative, a conv's summed dw to
  1e-3 (JAX's bounds, ``tests/test_cross_topology.py``): the slow stem
  (1,7,7)/s2/p3 and the fast stem (5,7,7)/s2/p(2,3,3), each also where a
  rank's first row is odd (30 rows), and a stem pool
  (1,3,3)/(1,2,2)/p(0,1,1) with its ``-inf`` halo;
* the units with BatchNorms, each in train mode on (1, 2) and 14 rows
  (rank 1's first row 7, odd): a basic block of stride 2 with its
  projection (a 1x1 stride-2 conv), a bottleneck block of stride 2 with
  its projection, and a lateral ((5,1,1) conv of T stride alpha, no H
  halo) whose BatchNorm takes its moments over the shards: each rank's
  output rows, input-row gradients and running statistics within 1e-6
  relative of one process, the parameter gradients summed over 'model'
  within 1e-5 (a lateral whose BatchNorm kept per-rank moments departs
  by percents);
* the (1, 2) pretrain steps at depth 18 and 50, and at depth 18 with
  ``--grad_accum 2``, and the (2, 2) steps at depth 18 with
  ``--shard_opt_state`` and with ``--sync_bn 0 --concat_views 0
  --ntxent_weight 0.5``, against one process on the global batch with
  the same flags, within ``test_torch_port_model_axis``'s tolerances
  (the first loss within 1e-5 relative, the update within 5e-2 leaf by
  leaf in norm, BN running statistics within 1e-4, the target tower
  bitwise, every rank bitwise the same whole state);
* the (1, 2) and (2, 2) float steps at depth 18 also against JAX's
  one-device train program with the same tolerances but the target
  tower's bits. JAX's (1, 2) program is not compiled: its gradient of a
  max pool under the sharding constraint is not its one-device gradient
  (``test_torch_port_shard_inception.test_jax_mesh12_stride1_pool_
  gradient_departs``), and the one-device program is what
  ``--shard_spatial`` promises;
* ``--quant int8`` on (1, 2) within ``INT8_LIMITS``: 1.5 times what the
  one-process step departs from itself with only its BatchNorm sums
  reordered (H or W reversed); the ``--quant int8_static`` eval logits (running
  statistics, calibrated scales) within 1e-5;
* a SlowFast-FB finetune step (``--ft_begin_index 3``: ``cls_bn``
  frozen) at batch 8 and the eval logits on (1, 2).

The ranks and three one-process workers start in the background before
the JAX side compiles; every launch has its own timeout, and the
temporary directory is removed at the end. The workers import no JAX.
"""

import shutil
import sys

import numpy as np
import pytest
import torch

from _shard_harness import (
    ROOT,
    assert_ranks_agree,
    assert_step_close,
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
    "sf": (dict(model_name="slowfast", model_depth=18), 8, 64, 4),
    "sf50": (dict(model_name="slowfast", model_depth=50), 8, 64, 4),
}
FT_MODEL = dict(model_name="slowfast_fb", model_depth=18)
# the finetune batch: one BatchNorm group of 8 clips (at 4 the (1, 2)
# step's worst leaf departed from one process by 1.02 of the update's
# tolerance; at 8 by 0.006, the one-process step with its BatchNorm sums
# reordered by 0.039, measured on this host)
FT_BATCH = 8
# the mesh steps: name -> (model, mesh flags, step flags)
STEPS = {
    "sf_12": ("sf", M12, {}),
    "sf_22": ("sf", M22, dict(shard_opt_state=1)),
    "sf50_12": ("sf50", M12, {}),
    "sf_accum_12": ("sf", M12, dict(grad_accum=2)),
    "sf_sbn0_22": ("sf", M22, dict(sync_bn=0, concat_views=0,
                                   ntxent_weight=0.5)),
    "sf_int8": ("sf", M12, dict(quant="int8")),
}
# the processes, all started together: job -> (world size, its cases); a
# one-process job runs a step case's reference (its flags without the
# mesh's, or, "... reordered_h" / "_w", with its BatchNorm sums
# reordered) and a mesh job the case itself on its ranks
JOBS = {
    "one_a": (1, ("sf_12", "units", "sf_int8", "sf_int8 reordered_h",
                  "sf_int8 reordered_w")),
    "one_b": (1, ("sf50_12", "ft")),
    "one_c": (1, ("sf_accum_12", "sf_sbn0_22", "eval_int8")),
    "mesh12a": (2, ("sites", "units", "sf_12", "sf_int8", "eval_int8")),
    "mesh12b": (2, ("sf50_12", "ft")),
    "mesh12c": (2, ("sf_accum_12",)),
    "mesh22": (4, ("sf_22", "sf_sbn0_22")),
}
# the cases whose one-process reference is another case's: the mesh flags
# and --shard_opt_state change nothing there
SAME_REFERENCE = {"sf_22": "sf_12"}
# JAX's one-device train program: key -> (model, mesh shape)
JAX_PROGRAMS = {"sf": ("sf", (1, 1))}
# the mesh steps held against it (the others' flags change JAX's program)
JAX_HELD = ("sf_12", "sf_22")
# (name, module, H): the H sites, each on (1, 2) shards of an (N, T, H, W,
# C) input; 30 rows give rank 1 the odd first row 15
SITES = [
    ("slow_stem_1x7x7_s2", ("conv", 3, 5, (1, 7, 7), (0, 3, 3)), 32),
    ("slow_stem_odd", ("conv", 3, 5, (1, 7, 7), (0, 3, 3)), 30),
    ("fast_stem_5x7x7_s2", ("conv", 3, 5, (5, 7, 7), (2, 3, 3)), 32),
    ("fast_stem_odd", ("conv", 3, 5, (5, 7, 7), (2, 3, 3)), 30),
    ("stem_pool_1x3x3_s122", ("pool",), 14),
]
# (name, H): the units with BatchNorms, each in a one-unit tower; 14 rows
# give rank 1 the odd first row 7
UNITS = [("basic_s2", 14), ("bottleneck_s2", 14), ("lateral", 14)]
UNIT_C = 8              # the units' input channels
ALPHA = 4
# The whole --quant int8 step. Every conv of both towers quantizes (45 a
# tower at depth 18), so a BatchNorm sum reassociated over the shards
# flips a round-half decision at the next site's quantize, as in
# tests/test_torch_port_shard_flags.py. The one-process step with only its
# BatchNorms' summation order changed (H or W reversed) departs from
# itself by loss terms up to 1.76e-3 (H) and BN running statistics up to
# 1.78e-2 of their leaf's largest value (both), the (1, 2) step by 7.2e-4
# and 2.42e-2 (measured on this host with this file's inputs): the update
# is not held (the float steps hold it), and the limits are 1.5 times the
# largest reordered readings: (loss terms rtol, statistics).
INT8_LIMITS = (2.64e-3, 2.67e-2)
# the H-reversed one-process step fills at least this share of each limit
INT8_LIMIT_USED = 0.25


# ------------------------------------------------ shared by both sides

def _config(model, **over):
    from cstp_tpu_torch.config import Config

    flags, t, s, b = MODELS[model]
    kw = dict(flags, sample_duration=t, sample_size=s, batch_size=b,
              compute_dtype="float32", learning_rate=LR)
    kw.update(over)
    return Config(**kw).finalize()


def _ft_config(**over):
    return _config("sf", n_finetune_classes=N_CLASSES, batch_size=FT_BATCH,
                   **dict(FT_MODEL, **over))


def _mesh():
    from cstp_tpu_torch.parallel import mesh

    return M12 if mesh.is_distributed() else {}


def _pretrain_run(model, over):
    """One preaugmented pretrain step of ``_config(model, **over)`` on this
    rank's rows of the model's batch, from the seed-0 weights."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_preaugmented_step,
    )

    cfg = _config(model, **over)
    net, state, tx = create_pretrain_state(cfg, device="cpu")
    step = make_preaugmented_step(net, tx, cfg)
    state, m = step(state, mesh.shard_batch(_INPUTS["batch"][model]), LR)
    sd = mesh.full_state_dict(net)
    out = split_state(sd)
    out.update(metrics={k: float(v) for k, v in m.items()},
               whole=digest(sd))
    return out


def _finetune_run():
    """One preaugmented slowfast_fb finetune step (``--ft_begin_index 3``)
    and the eval logits on its clips."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train.finetune import (
        create_finetune_state,
        make_preaugmented_finetune_step,
    )

    cfg = _ft_config(task="scratch", ft_begin_index=3, **_mesh())
    net, state, tx = create_finetune_state(cfg, N_CLASSES, seed=3,
                                           device="cpu")
    step = make_preaugmented_finetune_step(net, tx, cfg)
    rows = mesh.shard_batch(_INPUTS["ft_batch"])
    state, m = step(state, rows, LR)
    with torch.no_grad():
        logits = net(rows["clips"], train=False)
    sd = mesh.full_state_dict(net)
    out = split_state(sd)
    out.update(metrics={k: float(v) for k, v in m.items()},
               whole=digest(sd), logits=logits)
    return out


def _eval_int8_run():
    """The ``--quant int8_static`` eval logits of the slowfast_fb classify
    model (seed-3 weights, the running statistics and activation scales of
    ``_INPUTS["eval_state"]``) on the finetune clips: with the BatchNorms
    on running statistics and the scales fixed, only the global pool sums
    over 'model', so each conv quantizes the values one process does."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train.finetune import create_classify_model

    cfg = _ft_config(quant="int8_static", task="test", **_mesh())
    net = create_classify_model(cfg, N_CLASSES, seed=3, device="cpu")
    net.load_state_dict(_INPUTS["eval_state"], strict=False)
    with torch.no_grad():
        return net(mesh.shard_batch(_INPUTS["ft_batch"])["clips"],
                   train=False)


def _site_module(spec, weights):
    from cstp_tpu_torch.models.layers import Conv3d, MaxPool3d

    if spec[0] == "pool":
        return MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
    _, cin, cout, k, p = spec
    conv = Conv3d(cin, cout, k, (1, 2, 2), p, torch.float32)
    with torch.no_grad():
        conv.weight.copy_(weights[0])
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
    lo, hi = mesh.pad_pair(p)
    shard = mesh.SpatialShard(h, ax.index, ax.size,
                              ((1, h), (s, (h + lo + hi - k) // s + 1)))
    site.shard = (shard, 1)
    r0, r1 = shard.rows()
    xs = x[:, :, r0:r1].clone().requires_grad_(True)
    out = site(xs)
    params = list(site.parameters())
    grads = torch.autograd.grad(out.square().sum(), [xs] + params)
    dw = list(grads[1:])
    mesh.all_reduce_sum_(dw, "model")
    return dict(out=out.detach(), dx=grads[0], dw=dw, rows=(r0, r1),
                out_rows=shard.rows(s))


def _unit_tower(name):
    """A one-unit ``ShardedTower`` (seed-1 weights): ``basic_s2`` a basic
    block (UNIT_C -> 16, T kernel 3, stride 2, projection); ``bottleneck_
    s2`` a bottleneck block (UNIT_C -> 4 x 4, stride 2, projection);
    ``lateral`` a lateral (UNIT_C -> 2 UNIT_C, T stride ALPHA)."""
    from cstp_tpu_torch.models.sharded import ShardedTower
    from cstp_tpu_torch.models.slowfast import _Lateral, _SFBasic, _SFBottleneck

    gen = torch.Generator().manual_seed(1)
    kw = dict(dtype=torch.float32, gen=gen)

    class Tower(ShardedTower, torch.nn.Module):
        def __init__(self):
            super().__init__()
            if name == "basic_s2":
                self.unit = _SFBasic(UNIT_C, 16, 3, 2, **kw)
            elif name == "bottleneck_s2":
                self.unit = _SFBottleneck(UNIT_C, 4, 3, 2, **kw)
            else:
                self.unit = _Lateral(UNIT_C, ALPHA, **kw)

        def h_sites(self):
            return [] if name == "lateral" else self.unit.h_sites(1)

        def forward(self, x):
            if self.spatial:
                x = self.own_rows(x)
            return self.unit(x, True)

    return Tower()


def _unit_run(name, x):
    """Unit ``name`` in train mode on this rank's rows of ``x`` (whole
    ``x`` without a group): its output rows, the gradients of
    ``sum(out^2)`` for ``x`` (non-zero on the rank's rows) and for the
    parameters (summed over 'model'), and the running statistics."""
    from cstp_tpu_torch.models.sharded import spatially_partial_names
    from cstp_tpu_torch.parallel import mesh

    tower = _unit_tower(name)
    if mesh.is_distributed():
        tower.shard_spatially()
    x = x.clone().requires_grad_(True)
    out = tower(x)
    named = sorted(tower.named_parameters())
    grads = torch.autograd.grad(out.square().sum(),
                                [x] + [p for _, p in named])
    partial = spatially_partial_names(tower)
    mesh.all_reduce_sum_([g for (n, _), g in zip(named, grads[1:])
                          if n in partial], "model")
    return dict(out=out.detach(), dx=grads[0], dw=list(grads[1:]),
                partial=sorted(partial),
                stats={k: v.clone() for k, v in tower.state_dict().items()
                       if is_stat(k)})


# ------------------------------------------------------------- workers

_INPUTS = {}


def _run(name):
    """Case ``name`` of JOBS on this process."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train import pretrain as pt_mod

    if name == "sites":
        return {n: _site_run(spec, *_INPUTS["sites"][n])
                for n, spec, _ in SITES}
    if name == "units":
        return {n: _unit_run(n, _INPUTS["units"][n]) for n, _ in UNITS}
    if name == "ft":
        return _finetune_run()
    if name == "eval_int8":
        return _eval_int8_run()
    case, _, reordered = name.partition(" ")
    model, m, over = STEPS[case]
    if mesh.is_distributed():
        return _pretrain_run(model, dict(m, **over))
    with pytest.MonkeyPatch.context() as mp:
        if reordered:
            _reorder_bn_sums(mp, 2 if reordered == "reordered_h" else 3)
        if over.get("sync_bn") == 0 and m is M22:
            mp.setattr(pt_mod, "local_bn_groups", lambda config: 2)
        return _pretrain_run(model, over)


def _reorder_bn_sums(mp, dim):
    """Every ``BatchNorm``'s moments taken over the same values summed in
    another order (axis ``dim``, H or W, reversed in a 5-D input, the rows
    of each group reversed in a 2-D one), as the ranks change it
    (``test_torch_port_shard_flags._reordered``)."""
    from cstp_tpu_torch.models.layers import BatchNorm

    made = BatchNorm.batch_stats

    def batch_stats(self, xf):
        if xf.dim() == 5:
            return made(self, xf.flip(dim))
        b = xf.shape[0]
        return made(self, xf.reshape(self.groups, b // self.groups, -1)
                    .flip(1).reshape(xf.shape))

    mp.setattr(BatchNorm, "batch_stats", batch_stats)


# ---------------------------------------------------------- test side

def _eval_state(clips):
    """The slowfast_fb classify model's (seed 3) running statistics set to
    the batch statistics of ``clips`` (one train-mode forward with the
    running averages' momentum at 0), then its int8 activation scales
    calibrated on them (an ``int8_calib`` eval forward): the int8_static
    forward's state, whose activations keep their scale through the
    towers."""
    from cstp_tpu_torch.models import layers
    from cstp_tpu_torch.train.finetune import create_classify_model

    net = create_classify_model(_ft_config(quant="int8_calib", task="test"),
                                N_CLASSES, seed=3, device="cpu")
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(layers, "BN_MOMENTUM", 0.0)
        net(clips, train=True)
    for k, v in net.state_dict().items():
        if k.endswith("act_scale"):
            v.zero_()
    with torch.no_grad():
        net(clips, train=False)
    state = {k: v.clone() for k, v in net.state_dict().items()
             if is_stat(k) or k.endswith("act_scale")}
    assert all(float(v) > 0 for k, v in state.items()
               if k.endswith("act_scale"))
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from cstp_tpu_torch.train.finetune import create_finetune_state
    from cstp_tpu_torch.train.pretrain import create_pretrain_state

    tmp = tmp_path_factory.mktemp("shard_slowfast")
    procs = {}
    threads = torch.get_num_threads()
    try:
        rng = np.random.default_rng(0)
        batch = {m: views(rng, *MODELS[m][1:]) for m in MODELS}
        _, t, s, _ = MODELS["sf"]
        ft_batch = to_torch(dict(
            clips=rng.uniform(-1, 1, (FT_BATCH, t, s, s, 3)).astype(
                np.float32),
            labels=rng.integers(0, N_CLASSES, (FT_BATCH,)).astype(np.int64)))
        sites = {}
        for name, spec, h in SITES:
            if spec[0] == "pool":
                sites[name] = (randn(rng, 2, 4, h, 6, UNIT_C), ())
                continue
            _, cin, cout, k, _ = spec
            sites[name] = (randn(rng, 2, 8, h, 6, cin),
                           (randn(rng, cout, cin, *k),))
        units = {n: randn(rng, 2, 8, h, 6, UNIT_C) for n, h in UNITS}
        torch.save(dict(batch={m: to_torch(v) for m, v in batch.items()},
                        ft_batch=ft_batch, sites=sites, units=units,
                        eval_state=_eval_state(ft_batch["clips"])),
                   tmp / "inputs.pt")
        torch.set_num_threads(1)    # the workers and JAX share the cores
        procs = {job: launch(__file__, tmp, job, JOBS[job][0])
                 for job in JOBS}
        # the seed-0 weights and the finetune model's seed-3 weights
        nets, sd0 = {}, {}
        for m in MODELS:
            nets[m], _, _ = create_pretrain_state(_config(m), device="cpu")
            sd0[m] = split_state(nets[m].state_dict())["params"]
        net, _, _ = create_finetune_state(_ft_config(task="scratch",
                                                     ft_begin_index=3),
                                          N_CLASSES, seed=3, device="cpu")
        sd0["ft"] = split_state(net.state_dict())["params"]
        jax_runs = jax_steps(JAX_PROGRAMS, nets, batch, MODELS, LR)
        got = {job: join(group, tmp, job) for job, group in procs.items()}
    finally:
        torch.set_num_threads(threads)
        for p in (p for group in procs.values() for p in group):
            if p.poll() is None:
                p.kill()
                p.wait()
    one = {}
    for job in ("one_a", "one_b", "one_c"):
        one.update(got.pop(job)[0])
    ranks = {case: got[job] for job in got for case in JOBS[job][1]}
    yield dict(sd0=sd0, one=one, jax=jax_runs, ranks=ranks, sites=sites)
    shutil.rmtree(tmp, ignore_errors=True)


def _whole_site(spec, x, weights):
    site = _site_module(spec, weights)
    x = x.clone().requires_grad_(True)
    out = site(x)
    params = list(site.parameters())
    grads = torch.autograd.grad(out.square().sum(), [x] + params)
    return out.detach(), grads[0], list(grads[1:])


@pytest.mark.parametrize("case", [c[0] for c in SITES])
def test_h_site_on_shards_is_the_whole_op(runs, case):
    """Each H site of SlowFast on two H shards (its halo rows fetched from
    the neighbour, zeros or ``-inf`` outside the frame) is the op on the
    whole frame: each rank's output rows and input-row gradients to 1e-6
    relative, a conv's summed weight gradient to 1e-3; the slow and the
    fast stem also where rank 1's first row is odd (30 rows)."""
    _, spec, h = next(c for c in SITES if c[0] == case)
    x, weights = runs["sites"][case]
    out, dx, dw = _whole_site(spec, x, weights)
    got = [r["sites"][case] for r in runs["ranks"]["sites"]]
    assert got[0]["out_rows"][0] == 0
    assert got[-1]["out_rows"][1] == out.shape[2]
    assert got[0]["out_rows"][1] == got[1]["out_rows"][0]
    if h == 30:
        assert got[1]["rows"][0] % 2 == 1, got[1]["rows"]
    for g in got:
        (lo, hi), (o0, o1) = g["rows"], g["out_rows"]
        assert g["out"].shape[2] == o1 - o0
        assert rel(g["out"], out[:, :, o0:o1]) <= 1e-6, case
        assert rel(g["dx"], dx[:, :, lo:hi]) <= 1e-6, case
        assert len(g["dw"]) == len(dw)
        for a, b in zip(g["dw"], dw):
            assert rel(a, b) <= 1e-3, case


@pytest.mark.parametrize("case", [n for n, _ in UNITS])
def test_unit_on_shards_is_the_whole_unit(runs, case):
    """A basic and a bottleneck block of stride 2 with their projections
    (the 1x1 stride-2 conv on rank 1's rows, whose first is odd) and a
    lateral, each in train mode on (1, 2) with its BatchNorms' moments
    over the shards: each rank's output rows, input-row gradients and
    running statistics within 1e-6 relative of one process, the parameter
    gradients (summed over 'model') within 1e-5 (they sum over N, T, W and
    the ranks in another order: 2.1e-6, 3.6e-6 and 1.0e-6 measured)."""
    from cstp_tpu_torch.parallel import SpatialShard

    h = dict(UNITS)[case]
    want = runs["one"]["units"][case]
    for r, rank in enumerate(runs["ranks"]["units"]):
        got = rank["units"][case]
        lo, hi = SpatialShard(h, r, 2).rows()
        o0, o1 = SpatialShard(h, r, 2).rows(1 if case == "lateral" else 2)
        if r == 1:
            assert lo % 2 == 1, lo
        out = want["out"][:, :, o0:o1]
        assert got["out"].shape == out.shape
        assert rel(got["out"], out) <= 1e-6, (case, r)
        assert rel(got["dx"][:, :, lo:hi], want["dx"][:, :, lo:hi]) <= 1e-6
        assert not got["dx"][:, :, :lo].any()
        assert not got["dx"][:, :, hi:].any()
        assert len(got["dw"]) == len(want["dw"]) > 0
        for a, b in zip(got["dw"], want["dw"]):
            assert rel(a, b) <= 1e-5, (case, r)
        assert got["stats"].keys() == want["stats"].keys()
        assert got["stats"]
        for k, v in want["stats"].items():
            assert rel(got["stats"][k], v) <= 1e-6, (case, k)
        assert len(got["partial"]) == len(got["dw"])


@pytest.mark.parametrize("case", [n for n, (_, _, over) in STEPS.items()
                                  if "quant" not in over])
def test_pretrain_steps_on_shards_match_one_process(runs, case):
    """(1, 2) --shard_spatial steps of SlowFast-18 (also with --grad_accum
    2) and SlowFast-50, and (2, 2) steps of SlowFast-18 with
    --shard_opt_state and with --sync_bn 0 --concat_views 0
    --ntxent_weight 0.5, against one process on the global batch with
    the same flags."""
    ranks = runs["ranks"][case]
    assert_ranks_agree(ranks, case)
    assert_step_close(ranks[0][case],
                      runs["one"][SAME_REFERENCE.get(case, case)],
                      runs["sd0"][STEPS[case][0]], case)


@pytest.mark.parametrize("case", JAX_HELD)
def test_steps_on_shards_match_jax_one_device(runs, case):
    """The port's (1, 2) SlowFast-18 step and its (2, 2) step with
    --shard_opt_state against JAX's train program on one device from the
    same weights and views, with the float step's tolerances: the first
    loss within 1e-5, the update within 5e-2 leaf by leaf, BN running
    statistics within 1e-4."""
    model = STEPS[case][0]
    assert_step_close(runs["ranks"][case][0][case], runs["jax"][model],
                      runs["sd0"][model], f"JAX one device {case}",
                      target=False)


def _int8_gaps(got, want):
    """``(loss terms, statistics)``: the largest relative departure of the
    loss terms and of a BN running statistic (over its leaf's largest
    value) of the step ``got`` from ``want``."""
    loss = max(abs(got["metrics"][k] / v - 1)
               for k, v in want["metrics"].items() if k.startswith("loss"))
    stats = max(float((got["stats"][k] - v).abs().max() / v.abs().max())
                for k, v in want["stats"].items())
    return loss, stats


def test_int8_step_on_shards_matches_one_process(runs):
    """--quant int8 on (1, 2) H shards (K6's plain version here, every
    conv's dynamic scale a maximum over 'model' of the rows each rank
    holds, the laterals' too) against one process, within
    ``INT8_LIMITS``: the loss terms and every BN running statistic over
    its leaf's largest value; the target tower bitwise, every rank the
    same state and a finite update. The one-process steps with their
    BatchNorm sums reordered (H or W reversed) depart from one process by
    at least ``INT8_LIMIT_USED`` of each limit."""
    case = "sf_int8"
    assert_ranks_agree(runs["ranks"][case], case)
    got, want = runs["ranks"][case][0][case], runs["one"][case]
    assert all(np.isfinite(v) for v in got["metrics"].values())
    assert got["target"] == want["target"]
    assert all(torch.isfinite(v).all() for v in got["params"].values())
    reordered = [max(g) for g in zip(*(
        _int8_gaps(runs["one"][f"{case} reordered_{a}"], want)
        for a in "hw"))]
    for value, noise, limit, what in zip(_int8_gaps(got, want), reordered,
                                         INT8_LIMITS, ("loss", "statistics")):
        assert value <= limit, (case, what, value)
        assert noise >= INT8_LIMIT_USED * limit, (case, what, noise)


def test_int8_static_eval_logits_on_shards_match_one_process(runs):
    """The --quant int8_static eval forward of slowfast_fb on (1, 2) H
    shards against one process: with the BatchNorms on running statistics
    and the activation scales calibrated, only the global pool is summed
    in another order; the logits within 1e-5."""
    want = runs["one"]["eval_int8"]
    for rank in runs["ranks"]["eval_int8"]:
        torch.testing.assert_close(rank["eval_int8"], want, rtol=1e-5,
                                   atol=1e-5)


def test_finetune_and_eval_on_shards(runs):
    """A slowfast_fb finetune step (--ft_begin_index 3) and the eval
    forward under (1, 2) --shard_spatial against one process: the step
    within the sharded step's tolerances, the eval logits (the pool a sum
    over 'model') within 1e-5."""
    ranks = runs["ranks"]["ft"]
    assert_ranks_agree(ranks, "ft")
    want = runs["one"]["ft"]
    assert_step_close(ranks[0]["ft"], want, runs["sd0"]["ft"], "ft")
    for r in ranks:
        torch.testing.assert_close(r["ft"]["logits"], want["logits"],
                                   rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    worker(sys.argv[1], sys.argv[2], sys.argv[3], JOBS, _run, _INPUTS)
