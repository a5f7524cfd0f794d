"""The 'model' mesh axis of the port (``cstp_tpu_torch/parallel``) on the
CPU: ``--shard_spatial`` (H split over 'model' with halo-exchanged convs),
tensor-parallel 4096-wide MLPs and ``--shard_opt_state`` (ZeRO-1), with
gloo ranks, each a subprocess running this file as a script (the worker
below), against the JAX package's ``(2, 2)`` train program and against the
port's own one-process step on the global batch.

Size: R(2+1)D depth 1 at 4 x 32^2 (and 4 x 56^2, where conv4's 7 rows
split 4 / 3), float32, fused (2+1)D sites on (their plain version here, on
the padded H shards), global per-view batch 4. The JAX side runs one
program, the pretrain step on a ``(2, 2)`` mesh of 4 of the conftest's 8
CPU devices with ``shard_spatial=1, shard_opt_state=1``, from the same
bridged weights and views; its ``spatial_constraint_fn`` builds its mesh
from every device, so the test hands it the first four.

Tolerances are the JAX package's own for these mechanisms
(``tests/test_cross_topology.py``): a halo-exchanged conv holds the whole
conv to 1e-6 relative in the forward and in dx and to 1e-3 in dw; a
sharded step's first loss holds to 1e-5 relative, its parameter update to
5e-2 (H sharding reassociates the BatchNorm sums of every sample, which a
near-cancelling gradient amplifies), its BN running statistics to 1e-4;
tensor-parallel MLPs hold to 5e-4. At this learning rate (3e-4) a step
moves each parameter by far less than JAX's absolute 5e-2, so the update
(parameters after the step minus before) is held leaf by leaf in norm,
``|got - want| <= tol |want| + 1e-4 |all of want|`` (the second term for
leaves whose exact gradient is zero, as ``test_torch_port_pretrain.py``
does). Every rank of a mesh ends the step with bitwise the same whole
state. ZeRO-1 is bitwise: every step of the update rule is elementwise.

The ranks start in the background before the JAX side compiles, every
launch has its own timeout, and the temporary directory is removed at the
end. The workers import no JAX.
"""

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
B, T, S = 4, 4, 32          # global per-view batch, frames, size
S_UNEVEN = 56               # conv4's 7 rows split 4 / 3 over 2 ranks
B_FT, N_CLASSES = 4, 5
LR = 3e-4
TIMEOUT_S = 240
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")
# (name, H, k, s, p): the halo-exchanged conv cases
HALO_CASES = [("3x3_s1", 16, 3, 1, 1), ("3x3_s2", 16, 3, 2, 1),
              ("stem_7x7_s2", 32, 7, 2, 3), ("1x1_s2", 16, 1, 2, 0),
              ("7rows_3x3_s1", 7, 3, 1, 1)]
SPATIAL = dict(mesh_shape=(1, 2), shard_spatial=1)


# ------------------------------------------------ shared by both sides

def _config(**over):
    from cstp_tpu_torch.config import Config

    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              fused_conv=1, learning_rate=LR)
    kw.update(over)
    return Config(**kw).finalize()


def _ft_config(**over):
    return _config(task="ft_all", n_finetune_classes=N_CLASSES,
                   batch_size=B_FT, **over)


def _snapshot(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def _pretrain_run(over, sd, batch, tree=None):
    """One preaugmented pretrain step of ``_config(**over)`` on this rank's
    rows of ``batch``, from ``sd`` (or a checkpoint ``tree``): the
    metrics, the whole state dict and optimizer state after it (gathered
    on a mesh that splits them), and the state to go on from."""
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train import loops
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_preaugmented_step,
    )

    cfg = _config(**over)
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    if sd is not None:
        model.load_state_dict(sd)
    if tree is not None:
        loops._restore_state(state, tree, torch.device("cpu"), tx)
    mesh.replicate(model)
    step = make_preaugmented_step(model, tx, cfg)
    state, m = step(state, mesh.shard_batch(batch), LR)
    after = ckpt_lib.state_tree(state, tx)
    return dict(metrics={k: float(v) for k, v in m.items()},
                sd=_snapshot(after["model"]), opt=after["opt_state"],
                held=sum(t.numel() for t in state.opt_state["trace"].values()))


def _finetune_run(over, sd, batch):
    """One preaugmented finetune step and the eval step on its clips."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train.finetune import (
        create_finetune_state,
        make_preaugmented_finetune_step,
    )

    cfg = _ft_config(**over)
    model, state, tx = create_finetune_state(cfg, N_CLASSES, device="cpu")
    model.load_state_dict(sd)
    mesh.replicate(model)
    step = make_preaugmented_finetune_step(model, tx, cfg)
    rows = mesh.shard_batch(batch)
    state, m = step(state, rows, LR)
    with torch.no_grad():
        logits = model(rows["clips"], train=False)
    return dict(metrics={k: float(v) for k, v in m.items()},
                sd=_snapshot(mesh.full_state_dict(model)), logits=logits)


def _halo_run(x, w, h, k, s, p):
    """The conv of ``w`` (1 x k x k, stride s, padding p) on this 'model'
    rank's rows of ``x`` through ``halo_rows``: its output rows, and the
    gradients of the summed ``sum(out^2)`` for this rank's input rows and
    for ``w`` (summed over the ranks)."""
    from cstp_tpu_torch.parallel import mesh

    ax = mesh.mesh_axis("model")
    shard = mesh.SpatialShard(h, ax.index, ax.size)
    lo, hi = shard.rows()
    xs = x[:, :, lo:hi].clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    ext = mesh.halo_rows(xs, shard, 1, k, s, p)
    out = F.conv3d(ext.permute(0, 4, 1, 2, 3), w, stride=(1, s, s),
                   padding=(0, 0, p)).permute(0, 2, 3, 4, 1)
    dx, dw = torch.autograd.grad(out.square().sum(), (xs, w))
    mesh.all_reduce_sum_([dw], "model")
    return dict(out=out.detach(), dx=dx, dw=dw, rows=(lo, hi),
                out_rows=shard.rows(s))


# ------------------------------------------------------------- workers

def _worker(store: str, tmp: str, world: int) -> None:
    """One rank: the cases of its launch; results to
    ``out<world>_<rank>.pt``."""
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.maybe_initialize_distributed(init_method=f"file://{store}",
                                      device="cpu")
    tmp = Path(tmp)
    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    sd, batch = inp["sd"], inp["batch"]
    out = {}
    if world == 4:
        out["mesh22"] = _pretrain_run(dict(mesh_shape=(2, 2),
                                           shard_spatial=1,
                                           shard_opt_state=1), sd, batch)
        out["mesh22_sync0"] = _pretrain_run(dict(mesh_shape=(2, 2),
                                                 shard_spatial=1, sync_bn=0),
                                            sd, batch)
    else:
        mesh.use_mesh((1, 2))
        out["halo"] = {name: _halo_run(*inp["halo"][name], h, k, s, p)
                       for name, h, k, s, p in HALO_CASES}
        out["uneven"] = _pretrain_run(dict(sample_size=S_UNEVEN, **SPATIAL),
                                      sd, inp["batch56"])
        out["zero"] = _pretrain_run(dict(mesh_shape=(2, 1),
                                         shard_opt_state=1), sd, batch)
        out["no_zero"] = _pretrain_run(dict(mesh_shape=(2, 1)), sd, batch)
        out["tp"] = _pretrain_run(dict(mesh_shape=(1, 2)), sd, batch)
        out["ft"] = _finetune_run(SPATIAL, inp["ft_sd"], inp["ft_batch"])
        # a (2, 1) ZeRO checkpoint, restored onto (1, 2) --shard_spatial
        from cstp_tpu_torch.train import loops

        first = out["zero"]
        tree = dict(model=first["sd"], opt_state=first["opt"], step=1)
        if mesh.is_main():
            ckpt_lib.save_checkpoint(str(tmp / "ckpt_zero"), tree)
        restored, _ = loops._restore_on_rank0(str(tmp / "ckpt_zero"))
        out["resumed"] = _pretrain_run(SPATIAL, None, inp["batch2"],
                                       tree=restored)
        out["resumed"]["restored_bitwise"] = _same_tree(
            _restored_tree(SPATIAL, restored), restored)
        out["zero_bitwise"] = _same_tree(
            dict(model=out["zero"]["sd"], opt_state=out["zero"]["opt"]),
            dict(model=out["no_zero"]["sd"], opt_state=out["no_zero"]["opt"]))
        for case in ("zero", "no_zero"):
            for k in ("sd", "opt"):
                out[case].pop(k)
    torch.save(_slim(out, mesh.rank()), tmp / f"out{world}_{mesh.rank()}.pt")
    mesh.shutdown()


def _same_tree(a, b) -> bool:
    """Two checkpoint trees' model tensors and momentum bit for bit."""
    pairs = [(a["model"], b["model"]),
             (a["opt_state"]["trace"], b["opt_state"]["trace"])]
    return all(x.keys() == y.keys() and all(torch.equal(x[k], y[k])
                                             for k in x) for x, y in pairs)


def _digest(t) -> str:
    """A tensor's bytes, hashed (or the hash already)."""
    if isinstance(t, str):
        return t
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def _slim(out, rank: int):
    """What a rank writes (a whole state is about 130 MB): rank 0 its
    states and the optimizer states the ZeRO and checkpoint cases read;
    the other ranks hashes of them, for the bitwise checks."""
    for run in out.values():
        if isinstance(run, dict) and "sd" in run:
            run.pop("opt", None)
            if rank:
                run["sd"] = {k: _digest(v) for k, v in run["sd"].items()}
    return out


def _restored_tree(over, tree):
    """A checkpoint ``tree`` restored into a fresh state of
    ``_config(**over)`` and gathered back whole."""
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.train import loops
    from cstp_tpu_torch.train.pretrain import create_pretrain_state

    _, state, tx = create_pretrain_state(_config(**over), device="cpu")
    loops._restore_state(state, tree, torch.device("cpu"), tx)
    return ckpt_lib.state_tree(state, tx)


def _launch(tmp: Path, world: int):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CSTP_", "MASTER_"))}
    env["PYTHONPATH"] = str(ROOT)
    return [subprocess.Popen(
        [sys.executable, __file__, str(tmp / f"store{world}"), str(tmp),
         str(world)],
        env=dict(env, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs, tmp: Path, world: int):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} exited " \
                                  f"{p.returncode}:\n{log}"
    return [torch.load(tmp / f"out{world}_{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------- test side

def _view(rng, b, s):
    noise = rng.uniform(-1, 1, (b, T, s, s, 3))
    off = rng.uniform(-0.8, 0.8, (b, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (b, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def _views(rng, b, s=S):
    batch = {k: rng.integers(0, 5, (b,)).astype(np.int32)
             for k in ("spa", "tem", "pb")}
    batch.update(rot1=rng.integers(0, 4, (b,)).astype(np.int32),
                 rot2=rng.integers(0, 4, (b,)).astype(np.int32),
                 view1=_view(rng, b, s), view2=_view(rng, b, s))
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_mesh22_step(state0, tx, batch):
    """JAX's train program on a (2, 2) mesh with ``shard_spatial=1`` and
    ``shard_opt_state=1`` from the host state ``state0``: ``(metrics,
    (params, batch_stats))``."""
    import jax
    import jax.numpy as jnp

    from cstp_tpu.config import Config as JaxConfig
    from cstp_tpu.parallel import mesh as jax_mesh
    from cstp_tpu.parallel import shard_batch, shard_state
    from cstp_tpu.train.pretrain import (
        create_pretrain_model,
        split_pretrain_step,
    )

    cfg = JaxConfig(model_name="r21d", model_depth=1, sample_duration=T,
                    sample_size=S, batch_size=B, compute_dtype="float32",
                    fused_conv=1, learning_rate=LR, mesh_shape=(2, 2),
                    shard_spatial=1, shard_opt_state=1).finalize()
    devices = jax.devices()[:4]
    made = jax_mesh.create_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mesh, "create_mesh",
                   lambda shape=(-1, 1), axes=("data", "model"),
                   devices=devices: made(shape, axes, devices))
        jmesh = jax_mesh.create_mesh((2, 2))
        state = shard_state(jmesh, state0, zero_opt=True)
        _, train = split_pretrain_step(create_pretrain_model(cfg), tx, cfg)
        views = shard_batch(jmesh, tuple(jnp.asarray(batch[k])
                                         for k in KEYS))
        state, m = train(state, views, jnp.float32(LR))
        after = jax.tree_util.tree_map(np.asarray, jax.device_get(
            (state.params, state.batch_stats)))
    return {k: float(v) for k, v in m.items()}, after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from cstp_tpu.config import Config as JaxConfig
    from cstp_tpu.train.pretrain import create_pretrain_state as jax_state
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.models.bridge import load_jax_variables
    from cstp_tpu_torch.train import pretrain as pt_mod
    from cstp_tpu_torch.train.finetune import create_finetune_state
    from cstp_tpu_torch.train.pretrain import create_pretrain_state

    tmp = tmp_path_factory.mktemp("model_axis")
    procs = []
    threads = torch.get_num_threads()
    try:
        rng = np.random.default_rng(0)
        batch, batch2 = _views(rng, B), _views(rng, B)
        batch56 = _views(rng, B, S_UNEVEN)
        ft_batch = dict(
            clips=rng.uniform(-1, 1, (B_FT, T, S, S, 3)).astype(np.float32),
            labels=rng.integers(0, N_CLASSES, (B_FT,)).astype(np.int64))
        halo = {}
        for name, h, k, _, _ in HALO_CASES:
            halo[name] = (
                torch.from_numpy(rng.standard_normal(
                    (2, 3, h, 12, 4)).astype(np.float32)),
                torch.from_numpy(rng.standard_normal(
                    (5, 4, 1, k, k)).astype(np.float32)))
        torch.set_num_threads(1)    # the ranks and JAX share the cores
        jcfg = JaxConfig(model_name="r21d", model_depth=1,
                         sample_duration=T, sample_size=S, batch_size=B,
                         compute_dtype="float32", fused_conv=1,
                         learning_rate=LR).finalize()
        _, jstate, jtx = jax_state(jcfg, jax.random.PRNGKey(0))
        jstate = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
        model, _, _ = create_pretrain_state(_config(), device="cpu")
        load_jax_variables(model, jstate.params, jstate.batch_stats)
        sd = _snapshot(model.state_dict())
        fmodel, _, _ = create_finetune_state(_ft_config(), N_CLASSES, seed=3,
                                             device="cpu")
        ft_sd = _snapshot(fmodel.state_dict())
        torch.save(dict(sd=sd, ft_sd=ft_sd, batch=_torch(batch),
                        batch2=_torch(batch2), batch56=_torch(batch56),
                        ft_batch=_torch(ft_batch), halo=halo),
                   tmp / "inputs.pt")
        procs = [_launch(tmp, 4), _launch(tmp, 2)]
        jax_run = _jax_mesh22_step(jstate, jtx, batch)
        with pytest.MonkeyPatch.context() as mp:
            # --sync_bn 0 on 2 data rows: one BN group per row, per view
            mp.setattr(pt_mod, "local_bn_groups", lambda config: 2)
            sync0 = _pretrain_run(dict(sync_bn=0), sd, _torch(batch))
        one = dict(
            sync0=sync0,
            pretrain=_pretrain_run({}, sd, _torch(batch)),
            uneven=_pretrain_run(dict(sample_size=S_UNEVEN), sd,
                                 _torch(batch56)),
            ft=_finetune_run({}, ft_sd, _torch(ft_batch)))
        ranks4 = _join(procs[0], tmp, 4)
        ranks2 = _join(procs[1], tmp, 2)
        tree, _ = ckpt_lib.restore_checkpoint(str(tmp / "ckpt_zero"))
        one["resumed"] = _pretrain_run({}, None, _torch(batch2), tree=tree)
        one["restored_bitwise"] = _same_tree(_restored_tree({}, tree), tree)
        one["ckpt"] = tree
    finally:
        torch.set_num_threads(threads)
        for p in (p for group in procs for p in group):
            if p.poll() is None:
                p.kill()
                p.wait()
    yield dict(sd=sd, ft_sd=ft_sd, jax=jax_run, jax_params0=jstate.params,
               one=one, ranks4=ranks4, ranks2=ranks2, halo=halo)
    shutil.rmtree(tmp, ignore_errors=True)


def _conv(x, w, s, p):
    return F.conv3d(x.permute(0, 4, 1, 2, 3), w, stride=(1, s, s),
                    padding=(0, p, p)).permute(0, 2, 3, 4, 1)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("case", [c[0] for c in HALO_CASES])
def test_halo_conv_is_the_whole_conv(runs, case):
    """A conv on two H shards with their halo rows exchanged is the conv of
    the whole input: each rank's output rows and input-row gradients to
    1e-6 relative, the summed weight gradient to 1e-3 (JAX's bounds)."""
    _, h, k, s, p = next(c for c in HALO_CASES if c[0] == case)
    x, w = (t.clone().requires_grad_(True) for t in runs["halo"][case])
    out = _conv(x, w, s, p)
    dx, dw = torch.autograd.grad(out.square().sum(), (x, w))
    got = [r["halo"][case] for r in runs["ranks2"]]
    if case.startswith("7rows"):
        assert [g["rows"] for g in got] == [(0, 4), (4, 7)]
    assert got[0]["out_rows"][0] == 0
    assert got[-1]["out_rows"][1] == out.shape[2]
    for g in got:
        (lo, hi), (o0, o1) = g["rows"], g["out_rows"]
        assert _rel(g["out"], out[:, :, o0:o1].detach()) <= 1e-6, case
        assert _rel(g["dx"], dx[:, :, lo:hi]) <= 1e-6, case
        assert _rel(g["dw"], dw) <= 1e-3, case


def _is_stat(name):
    return name.endswith(("mean", "var"))


def _assert_updates_close(got, want, sd0, tol, what):
    """Each parameter's update within ``tol`` of the wanted one in norm,
    plus 1e-4 of the whole wanted update's norm."""
    d_all = torch.cat([(want[k] - sd0[k]).flatten().double()
                       for k in sd0 if not _is_stat(k)])
    floor = 1e-4 * float(d_all.norm())
    assert floor > 0, what
    for k in sd0:
        if _is_stat(k):
            continue
        d_got = (got[k] - sd0[k]).double()
        d_want = (want[k] - sd0[k]).double()
        err = float((d_got - d_want).norm())
        assert err <= tol * float(d_want.norm()) + floor, (
            f"{what} {k}: |got - want| {err:.3e}, |want| "
            f"{float(d_want.norm()):.3e}")


def _assert_step_close(got, want, sd0, what):
    """Step-1 loss within 1e-5 relative, the update within 5e-2 leaf by
    leaf, BN running statistics within 1e-4."""
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=1e-5,
                               err_msg=what)
    assert got["sd"].keys() == want["sd"].keys()
    for k, v in want["sd"].items():
        if _is_stat(k):
            np.testing.assert_allclose(got["sd"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=f"{what} {k}")
    _assert_updates_close(got["sd"], want["sd"], sd0, 5e-2, what)


def _assert_ranks_agree(ranks, case):
    """Every rank holds bitwise the same whole state after ``case`` (the
    other ranks hand in hashes)."""
    for r in ranks[1:]:
        assert r[case]["sd"].keys() == ranks[0][case]["sd"].keys()
        for k, v in ranks[0][case]["sd"].items():
            assert r[case]["sd"][k] == _digest(v), (case, k)


def test_mesh22_matches_one_process(runs):
    """The (2, 2) step with --shard_spatial and --shard_opt_state (4 gloo
    ranks: H over 'model', tensor-parallel projector and predictor, ZeRO
    over 'data') against the port's one process on the global batch; every
    rank gathers the same whole state."""
    _assert_ranks_agree(runs["ranks4"], "mesh22")
    _assert_step_close(runs["ranks4"][0]["mesh22"], runs["one"]["pretrain"],
                       runs["sd"], "(2, 2)")


# JAX's own (2, 2) --shard_spatial program departs from its one-device
# program in the target tower from conv5.block1.conv1's BatchNorm on (its
# running mean by up to 8.2e-3 on values of 8.2e-3, measured with this
# file's inputs; the loss agrees to 2e-7): the BN running statistics there
# are held to the port's one-process step instead
# (``test_mesh22_matches_one_process``), which equals JAX's one-device step
# to 6e-8 on every BN leaf
JAX_MESH22_DEPARTS = ("['target_net']['conv5']", "['target_net']['project']")


def test_mesh22_sync_bn0_matches_one_process(runs):
    """(2, 2) --shard_spatial with --sync_bn 0: each data row's BN groups
    summed over its two H shards alone, the running statistics averaged
    over 'data' after the step, against one process with one BN group per
    data row and view."""
    _assert_ranks_agree(runs["ranks4"], "mesh22_sync0")
    _assert_step_close(runs["ranks4"][0]["mesh22_sync0"],
                       runs["one"]["sync0"], runs["sd"], "(2, 2) sync_bn 0")


def test_mesh22_matches_jax_mesh22(runs):
    """The port's (2, 2) step against JAX's train program on a (2, 2) mesh
    with the same flags: step-1 loss within 1e-5, the update within 5e-2
    leaf by leaf, BN running statistics within 1e-4 outside the target
    tower's conv5 stage and projector (``JAX_MESH22_DEPARTS``)."""
    import jax

    from cstp_tpu_torch.models.bridge import export_state_dict

    jm, (jparams, jstats) = runs["jax"]
    got = runs["ranks4"][0]["mesh22"]
    np.testing.assert_allclose(got["metrics"]["loss"], jm["loss"],
                               rtol=1e-5)
    tree = export_state_dict(got["sd"])

    def flat(t):
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(t)[0]}

    a, b, a0 = (flat(t) for t in (tree["params"], jparams,
                                   runs["jax_params0"]))
    assert a.keys() == b.keys() == a0.keys()
    _assert_updates_close(
        {k: torch.from_numpy(np.array(v)) for k, v in a.items()},
        {k: torch.from_numpy(np.array(v)) for k, v in b.items()},
        {k: torch.from_numpy(np.array(v)) for k, v in a0.items()}, 5e-2,
        "JAX (2, 2)")
    a, b = flat(tree["batch_stats"]), flat(jstats)
    assert a.keys() == b.keys()
    held = [k for k in b if not k.startswith(JAX_MESH22_DEPARTS)]
    assert len(b) - len(held) == 14, len(b) - len(held)
    for k in held:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_uneven_split_matches_one_process(runs):
    """At 56^2 on (1, 2) --shard_spatial conv4's 7 rows split 4 / 3 and
    conv5 runs on 2 + 2 rows of 4: the step holds the one-process step."""
    _assert_ranks_agree(runs["ranks2"], "uneven")
    _assert_step_close(runs["ranks2"][0]["uneven"], runs["one"]["uneven"],
                       runs["sd"], "56^2")


def test_zero1_is_bitwise(runs):
    """(2, 1) with --shard_opt_state against (2, 1) without: the same
    metrics, parameters and gathered momentum, bit for bit (compared on
    each rank), while each rank holds a slice of the state."""
    for r in runs["ranks2"]:
        z, n = r["zero"], r["no_zero"]
        assert z["metrics"] == n["metrics"]
        assert r["zero_bitwise"]
        assert z["held"] < 0.6 * n["held"], (z["held"], n["held"])


def test_tensor_parallel_mlps_match_one_process(runs):
    """(1, 2) without --shard_spatial: the 4096-wide projector and
    predictor split over 'model', within JAX's rtol 5e-4 / atol 1e-3 on
    the metrics and BN running statistics and 5e-4 on the update."""
    want = runs["one"]["pretrain"]
    _assert_ranks_agree(runs["ranks2"], "tp")
    got = runs["ranks2"][0]["tp"]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=5e-4,
                                   atol=1e-3, err_msg=k)
    for k, v in want["sd"].items():
        if _is_stat(k):
            np.testing.assert_allclose(got["sd"][k], v, rtol=5e-4,
                                       atol=1e-3, err_msg=k)
    _assert_updates_close(got["sd"], want["sd"], runs["sd"], 5e-4, "tp")


def test_finetune_and_eval_on_h_shards(runs):
    """A finetune step and the eval forward under (1, 2) --shard_spatial
    against one process: step within the sharded step's tolerances, the
    eval logits (replicated over 'model') within 1e-5."""
    want = runs["one"]["ft"]
    _assert_ranks_agree(runs["ranks2"], "ft")
    _assert_step_close(runs["ranks2"][0]["ft"], want, runs["ft_sd"],
                       "finetune")
    for r in runs["ranks2"]:
        torch.testing.assert_close(r["ft"]["logits"], want["logits"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("onto", ["mesh12_spatial", "world1"])
def test_zero_checkpoint_crosses_topologies(runs, onto):
    """A checkpoint written on (2, 1) with ZeRO holds whole tensors and
    restores bitwise onto (1, 2) --shard_spatial and onto one process; the
    next step from it agrees."""
    tree = runs["one"]["ckpt"]
    if onto == "world1":
        assert runs["one"]["restored_bitwise"]
        return
    for r in runs["ranks2"]:
        assert r["resumed"]["restored_bitwise"]
    _assert_ranks_agree(runs["ranks2"], "resumed")
    _assert_step_close(runs["ranks2"][0]["resumed"], runs["one"]["resumed"],
                       tree["model"], "resumed")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]))
