"""Data parallelism of the port (``cstp_tpu_torch/parallel``) on the CPU:
two gloo ranks, each a subprocess running this file as a script (the
worker below), against the JAX package's ``data=2`` train program and
against the port's own one-process step on the global batch.

Size: R(2+1)D depth 1 at 4 x 32^2, float32, fused (2+1)D sites on (their
plain version here), global per-view batch 4 (each rank 2). The JAX side
runs on a ``data=2`` mesh of the conftest's 8 CPU devices, from the same
bridged weights and views; it is held to ``test_torch_port_pretrain.py``'s
tolerances (metrics and BN running statistics rtol 1e-4, updates leaf by
leaf in norm within 5e-2 relative). Against the port's one-process step the
update is held to 1e-5 relative in norm: the same operations, the global
batch's reductions split between two ranks. Under ``--sync_bn 0`` the
one-process model is built with ``bn_groups=2`` directly, the groups that
are rank 0's and rank 1's rows.

The ranks start in the background before the JAX side compiles, and every
launch has its own timeout, so a hang fails the test instead of eating the
suite. The workers import no JAX.
"""

import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
B, T, S = 4, 4, 32          # global per-view batch, frames, size
B_ACCUM = 16                # the grad_accum=2 case's global batch
B_FT, N_CLASSES = 8, 5      # the finetune cases
H0, W0 = 48, 64             # the augment case's frames
LR = 3e-4
WORLD = 2
TIMEOUT_S = 120
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")


# ------------------------------------------------ shared by both sides

def _config(**over):
    from cstp_tpu_torch.config import Config

    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              fused_conv=1, learning_rate=LR)
    kw.update(over)
    return Config(**kw).finalize()


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _pretrain_state(over, sd=None, tree=None):
    """A pretrain state of ``_config(**over)`` from a state dict or a
    checkpoint tree (restored as the loops restore, then replicated)."""
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
        loops._restore_state(state, tree, torch.device("cpu"))
    mesh.replicate(model)
    return state, make_preaugmented_step(model, tx, cfg)


def _pretrain_run(over, sd, batch, start=None):
    """One preaugmented pretrain step on this rank's rows of ``batch``,
    from ``sd`` or from ``start`` (a ``(state, step)`` pair): ``{"metrics",
    "sd", "start"}``, ``start`` to take the next step from."""
    from cstp_tpu_torch.parallel import mesh

    state, step = start or _pretrain_state(over, sd)
    state, m = step(state, mesh.shard_batch(batch), LR)
    return dict(metrics={k: float(v) for k, v in m.items()},
                sd=_snapshot(state.model), start=(state, step))


def _finetune_run(over, sd, batch):
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train.finetune import (
        create_finetune_state,
        make_preaugmented_finetune_step,
    )

    cfg = _config(task="ft_all", n_finetune_classes=N_CLASSES,
                  batch_size=B_FT, **over)
    model, state, tx = create_finetune_state(cfg, N_CLASSES, device="cpu")
    model.load_state_dict(sd)
    mesh.replicate(model)
    step = make_preaugmented_finetune_step(model, tx, cfg)
    state, m = step(state, mesh.shard_batch(batch), LR)
    return dict(metrics={k: float(v) for k, v in m.items()},
                sd=_snapshot(model))


def _augment_run(frames):
    """Pretrain and finetune augment of this rank's rows, drawn from one
    seeded generator."""
    from cstp_tpu_torch.augment.pipeline import (
        finetune_train_augment_batch,
        pretrain_augment_batch,
    )
    from cstp_tpu_torch.parallel import mesh

    rows = mesh.shard_batch(frames)
    shard = (mesh.rank(), mesh.world_size())
    v1, v2, spa = pretrain_augment_batch(
        torch.Generator().manual_seed(7), rows["frames1"], rows["frames2"],
        rows["rot1"], rows["rot2"], sample_size=S, shard=shard)
    ft = finetune_train_augment_batch(torch.Generator().manual_seed(8),
                                      rows["frames1"], sample_size=S,
                                      shard=shard)
    return dict(v1=v1, v2=v2, spa=spa, ft=ft)


def _k2_stats_run(x1, x2, ws):
    """Per-view statistics of the spatial conv on this rank's rows of both
    views, made global by ``global_stats`` (the CUDA path's collective
    between K2 and K3), and by the plain version's ``cross_rank`` path."""
    from cstp_tpu_torch.ops import conv21d
    from cstp_tpu_torch.parallel import mesh

    x = torch.cat([mesh.shard_rows(x1), mesh.shard_rows(x2)])
    local = conv21d.reference_stats(x, ws, 2, torch.float32)
    return dict(kernel_path=conv21d.global_stats(*local),
                plain_path=conv21d.reference_stats(
                    x, ws, 2, torch.float32, cross_rank=mesh.is_distributed()))


def _preempt_run(root: Path, stop_at: int):
    """``run_pretrain`` on synthetic videos with --graceful_preempt 1; the
    last rank sends itself SIGTERM during step ``stop_at``."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train import loops

    made = loops.make_pretrain_step
    calls = []

    def make(model, tx, config):
        step = made(model, tx, config)

        def counted(*a):
            calls.append(1)
            if (mesh.rank() == mesh.world_size() - 1
                    and len(calls) == stop_at):
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*a)

        return counted

    loops.make_pretrain_step = make
    try:
        cfg = _config(task="loss_com", data_backend="synthetic",
                      synthetic_len=16, n_epochs=2, graceful_preempt=1,
                      n_workers=1, log_every=0, dataset="UCF101",
                      result_path=str(root), prefetch_depth=1)
        out = loops.run_pretrain(cfg, device="cpu")
    finally:
        loops.make_pretrain_step = made
    return dict(steps=len(calls), preempted=out["preempted"],
                epochs=len(out["history"]))


def _finetune_loop_run(root: Path):
    """``run_finetune`` for one epoch of 2 steps on synthetic videos, then
    its validation over every video: the history and the run directory's
    files."""
    from cstp_tpu_torch.train import loops

    cfg = _config(task="ft_all", data_backend="synthetic", synthetic_len=12,
                  n_classes=N_CLASSES, n_finetune_classes=N_CLASSES,
                  n_epochs=1, steps_per_epoch=2, n_workers=1, log_every=0,
                  dataset="UCF101", result_path=str(root), prefetch_depth=1)
    out = loops.run_finetune(cfg, device="cpu")
    return dict(history=out["history"], best=out["best"]["epoch"])


# ------------------------------------------------------------- worker

def _worker(store: str, tmp: str) -> None:
    """One rank: every case on this rank's rows; its results to
    ``out_<rank>.pt``."""
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train import loops

    torch.set_num_threads(1)
    mesh.maybe_initialize_distributed(init_method=f"file://{store}",
                                      device="cpu")
    tmp = Path(tmp)
    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    sd, ft_sd = inp["sd"], inp["ft_sd"]
    out = {}
    out["sync1_ntxent"] = _pretrain_run(dict(ntxent_weight=0.5), sd,
                                        inp["batch"])
    out["sync0"] = _pretrain_run(dict(sync_bn=0), sd, inp["batch"])
    out["accum"] = _pretrain_run(dict(grad_accum=2, batch_size=B_ACCUM),
                                 sd, inp["accum_batch"])
    for name, over in (("ft_sync1", {}), ("ft_sync0", dict(sync_bn=0))):
        out[name] = _finetune_run(over, ft_sd, inp["ft_batch"])
    out["augment"] = _augment_run(inp["frames"])
    out["k2_stats"] = _k2_stats_run(*inp["k2"])
    # checkpoints: a world-2 step, saved on rank 0, then the next step; and
    # the next step from a world-1 checkpoint, read on rank 0 and broadcast
    first = _pretrain_run({}, sd, inp["batch"])
    if mesh.is_main():
        ckpt_lib.save_checkpoint(str(tmp / "ckpt_w2"),
                                 ckpt_lib.state_tree(first["start"][0]))
    out["w2_next"] = _pretrain_run({}, None, inp["batch2"],
                                   start=first["start"])
    tree, _ = loops._restore_on_rank0(str(tmp / "ckpt_w1"))
    out["w1_ckpt_next"] = _pretrain_run({}, None, inp["batch2"],
                                        start=_pretrain_state({}, tree=tree))
    out["preempt"] = _preempt_run(tmp / "preempt", stop_at=2)
    out["ft_loop"] = _finetune_loop_run(tmp / "ft_loop")
    for v in out.values():
        v.pop("start", None)
    torch.save(out, tmp / f"out_{mesh.rank()}.pt")
    mesh.shutdown()


def _launch(tmp: Path):
    """Start the ranks; returns their processes."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CSTP_", "MASTER_"))}
    env["PYTHONPATH"] = str(ROOT)
    procs = []
    for r in range(WORLD):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp / "store"), str(tmp)],
            env=dict(env, RANK=str(r), WORLD_SIZE=str(WORLD),
                     LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _join(procs, tmp: Path):
    """Wait for the ranks (each within ``TIMEOUT_S``); their results."""
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
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp / f"out_{r}.pt", weights_only=False)
            for r in range(WORLD)]


# ---------------------------------------------------------- test side

def _view(rng, b):
    noise = rng.uniform(-1, 1, (b, T, S, S, 3))
    off = rng.uniform(-0.8, 0.8, (b, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (b, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def _views(rng, b):
    batch = {k: rng.integers(0, 5, (b,)).astype(np.int32)
             for k in ("spa", "tem", "pb")}
    batch.update(rot1=rng.integers(0, 4, (b,)).astype(np.int32),
                 rot2=rng.integers(0, 4, (b,)).astype(np.int32),
                 view1=_view(rng, b), view2=_view(rng, b))
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_config(**over):
    from cstp_tpu.config import Config as JaxConfig

    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              fused_conv=1, learning_rate=LR, mesh_shape=(WORLD, 1))
    kw.update(over)
    return JaxConfig(**kw).finalize()


def _jax_data2_step(over, state0, tx, batch):
    """JAX's train program of ``_jax_config(**over)`` on a data=2 mesh from
    the host state ``state0``: ``(metrics, (params, stats))``."""
    import jax
    import jax.numpy as jnp

    from cstp_tpu.parallel import create_mesh, shard_batch, shard_state
    from cstp_tpu.train.pretrain import (
        create_pretrain_model,
        split_pretrain_step,
    )

    cfg = _jax_config(**over)
    jmesh = create_mesh((WORLD, 1), ("data", "model"),
                        devices=jax.devices()[:WORLD])
    state = shard_state(jmesh, state0)
    _, train = split_pretrain_step(create_pretrain_model(cfg), tx, cfg)
    views = shard_batch(jmesh, tuple(jnp.asarray(batch[k]) for k in KEYS))
    state, m = train(state, views, jnp.float32(LR))
    after = jax.tree_util.tree_map(np.asarray, jax.device_get(
        (state.params, state.batch_stats)))
    return {k: float(v) for k, v in m.items()}, after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.models.bridge import load_jax_variables
    from cstp_tpu_torch.train import finetune as ft_mod
    from cstp_tpu_torch.train import pretrain as pt_mod
    from cstp_tpu_torch.train.finetune import create_finetune_state
    from cstp_tpu_torch.train.pretrain import create_pretrain_state

    import jax

    from cstp_tpu.train.pretrain import create_pretrain_state as jax_state

    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    batch, batch2 = _views(rng, B), _views(rng, B)
    accum_batch = _views(rng, B_ACCUM)
    clips = rng.uniform(-1, 1, (B_FT, T, S, S, 3)).astype(np.float32)
    ft_batch = dict(clips=clips, labels=rng.integers(
        0, N_CLASSES, (B_FT,)).astype(np.int64))
    frames = dict(
        frames1=rng.integers(0, 256, (B, T, H0, W0, 3)).astype(np.uint8),
        frames2=rng.integers(0, 256, (B, T, H0, W0, 3)).astype(np.uint8),
        rot1=rng.integers(0, 4, (B,)).astype(np.int64),
        rot2=rng.integers(0, 4, (B,)).astype(np.int64))

    # the JAX package's initial state (host arrays: the train program
    # donates its input), its weights bridged into the port
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # the ranks and JAX share the cores
    _, jstate, jtx = jax_state(_jax_config(), jax.random.PRNGKey(0))
    jstate = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate))
    model, state, _ = create_pretrain_state(_config(), device="cpu")
    load_jax_variables(model, jstate.params, jstate.batch_stats)
    sd = _snapshot(model)
    fmodel, _, _ = create_finetune_state(
        _config(task="ft_all", n_finetune_classes=N_CLASSES), N_CLASSES,
        seed=3, device="cpu")
    ft_sd = _snapshot(fmodel)

    # a world-1 checkpoint for the world-2 ranks to resume
    w1 = _pretrain_run({}, sd, _torch(batch))
    ckpt_lib.save_checkpoint(str(tmp / "ckpt_w1"),
                             ckpt_lib.state_tree(w1["start"][0]))
    k2 = [torch.from_numpy(a) for a in (
        rng.standard_normal((B, T, 8, 8, 16)).astype(np.float32) + 0.5,
        rng.standard_normal((B, T, 8, 8, 16)).astype(np.float32) - 0.5,
        rng.standard_normal((3, 3, 16, 8)).astype(np.float32) / 12)]
    torch.save(dict(sd=sd, ft_sd=ft_sd, k2=k2, batch=_torch(batch),
                    batch2=_torch(batch2), accum_batch=_torch(accum_batch),
                    ft_batch=_torch(ft_batch), frames=_torch(frames)),
               tmp / "inputs.pt")
    procs = _launch(tmp)
    try:
        jax_runs = {name: _jax_data2_step(over, jstate, jtx, batch)
                    for name, over in (
                        ("sync1_ntxent", dict(ntxent_weight=0.5)),
                        ("sync0", dict(sync_bn=0)))}

        # the port's one-process steps on the global batch, each with its
        # float32 spread
        per_rank = B // WORLD
        one = {"sync1_ntxent": _with_spread(
            lambda b: _pretrain_run(dict(ntxent_weight=0.5), sd, b),
            _torch(batch), per_rank)}
        # rank r's micro-batch k is global rows r * B/2 + k * B/4 ...: the
        # one-process split takes them contiguously in that order
        q = B_ACCUM // (2 * WORLD)
        order = [r * B_ACCUM // WORLD + k * q + i for k in range(2)
                 for r in range(WORLD) for i in range(q)]
        one["accum"] = _with_spread(
            lambda b: _pretrain_run(dict(grad_accum=2, batch_size=B_ACCUM),
                                    sd, b),
            {k: v[order] for k, v in _torch(accum_batch).items()}, q)
        one["ft_sync1"] = _with_spread(
            lambda b: _finetune_run({}, ft_sd, b), _torch(ft_batch),
            B_FT // WORLD)
        with pytest.MonkeyPatch.context() as mp:
            for mod in (pt_mod, ft_mod):
                mp.setattr(mod, "local_bn_groups", lambda config: WORLD)
            one["sync0"] = _with_spread(
                lambda b: _pretrain_run(dict(sync_bn=0), sd, b),
                _torch(batch), per_rank)
            one["ft_sync0"] = _with_spread(
                lambda b: _finetune_run(dict(sync_bn=0), ft_sd, b),
                _torch(ft_batch), B_FT // WORLD)
        one["augment"] = _augment_run(_torch(frames))

        def next_step(path):
            tree, _ = ckpt_lib.restore_checkpoint(str(path))
            return _with_spread(lambda b: _pretrain_run(
                {}, None, b, start=_pretrain_state({}, tree=tree)),
                _torch(batch2), per_rank)

        one["w1_ckpt_next"] = next_step(tmp / "ckpt_w1")
        ranks = _join(procs, tmp)
        one["w2_next"] = next_step(tmp / "ckpt_w2")
        preempt = dict(save=(tmp / "preempt" / "UCF101" / "loss_com"
                             / "save_1").is_dir(),
                       logs=sorted(p.name for p in (
                           tmp / "preempt" / "UCF101" / "loss_com").iterdir()))
        ft_files = sorted(p.name for p in (
            tmp / "ft_loop" / "UCF101" / "ft_all").iterdir())
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for v in one.values():
        v.pop("start", None)
    from cstp_tpu_torch.ops.conv21d import reference_stats

    one["k2_stats"] = reference_stats(torch.cat(k2[:2]), k2[2], 2,
                                      torch.float32)
    yield dict(sd=sd, ft_sd=ft_sd, ranks=ranks, one=one, jax=jax_runs,
               jax_params0=jstate.params, preempt=preempt, ft_files=ft_files)
    shutil.rmtree(tmp, ignore_errors=True)


def _flat_update(sd, sd0):
    return torch.cat([(sd[k] - sd0[k]).flatten().double() for k in sd0
                      if sd0[k].is_floating_point()
                      and not k.endswith(("mean", "var"))])


def _reversed_in_blocks(batch, block: int):
    n = len(next(iter(batch.values())))
    idx = [s + block - 1 - i for s in range(0, n, block)
           for i in range(block)]
    return {k: v[idx] for k, v in batch.items()}


def _with_spread(run, batch, block: int):
    """``run(batch)`` and the float32 spread of its parameters: their
    distance after the same step on ``batch`` with each ``block`` of rows
    reversed (each rank's rows, or micro-batch slice, stays one block: the
    same groups and micro-batches, summed in another order)."""
    a, b = run(batch), run(_reversed_in_blocks(batch, block))
    a["spread"] = float(torch.linalg.vector_norm(
        _flat_update(a["sd"], b["sd"])))
    return a


def _assert_update_close(got, want, sd0, what):
    """The update within 1e-5 relative in norm, or within ten times the
    one-process step's own float32 spread where that is larger."""
    g, w = _flat_update(got["sd"], sd0), _flat_update(want["sd"], sd0)
    err = float(torch.linalg.vector_norm(g - w))
    norm = float(torch.linalg.vector_norm(w))
    tol = max(1e-5 * norm, 10 * want["spread"])
    assert norm > 0, what
    assert err <= tol, (f"{what}: |got - want| {err:.3e}, |want| "
                        f"{norm:.3e}, float32 spread {want['spread']:.3e}")


def test_ranks_agree_bitwise(runs):
    """Every rank ends each case with the same parameters and BN running
    statistics, and the same metrics."""
    r0, r1 = runs["ranks"]
    for case in r0:
        if "sd" in r0[case]:
            for k in r0[case]["sd"]:
                assert torch.equal(r0[case]["sd"][k], r1[case]["sd"][k]), \
                    (case, k)
            assert r0[case]["metrics"] == r1[case]["metrics"], case


@pytest.mark.parametrize("case", ["sync1_ntxent", "sync0"])
def test_world2_matches_jax_data2(runs, case):
    """The 2-rank step against JAX's train program on a data=2 mesh:
    metrics, BN running statistics and the update."""
    from cstp_tpu_torch.models.bridge import export_state_dict

    import jax

    jm, (jparams, jstats) = runs["jax"][case]
    jparams0 = runs["jax_params0"]
    got = runs["ranks"][0][case]
    assert got["metrics"].keys() == jm.keys()
    for k, v in jm.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    tree = export_state_dict(got["sd"])
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree["batch_stats"])[0]}
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jstats)[0]}
    assert flat.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(flat[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    params = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(tree["params"])[0]}
    p1 = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
          jax.tree_util.tree_flatten_with_path(jparams)[0]}
    p0 = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
          jax.tree_util.tree_flatten_with_path(jparams0)[0]}
    floor = 1e-4 * np.sqrt(sum(np.sum((p1[k] - p0[k]).astype(np.float64)
                                      ** 2) for k in p0))
    for k in p0:
        d_got, d_want = params[k] - p0[k], p1[k] - p0[k]
        err = np.linalg.norm(d_got - d_want)
        assert err <= 5e-2 * np.linalg.norm(d_want) + floor, (
            f"{k}: |got - want| {err:.3e}, |want| "
            f"{np.linalg.norm(d_want):.3e}")


@pytest.mark.parametrize("case", ["sync1_ntxent", "sync0", "accum",
                                  "ft_sync1", "ft_sync0"])
def test_world2_matches_one_process_global_batch(runs, case):
    """The 2-rank step against the port's one process on the global batch
    (``bn_groups=2`` built directly for --sync_bn 0; the accumulation's
    micro-batches in the ranks' order): metrics, BN running statistics,
    and the update within 1e-5 relative in norm."""
    got, want = runs["ranks"][0][case], runs["one"][case]
    sd0 = runs["ft_sd"] if case.startswith("ft") else runs["sd"]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for k, v in want["sd"].items():
        if k.endswith(("mean", "var")):
            np.testing.assert_allclose(got["sd"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    _assert_update_close(got, want, sd0, case)


def test_concatenated_rank_augment_is_the_global_augment(runs):
    """The ranks' pretrain views and spa labels and their finetune clips,
    concatenated in rank order, are the one-process augment of the global
    batch from the same generator (plain path)."""
    want = runs["one"]["augment"]
    for k in ("v1", "v2", "spa", "ft"):
        got = torch.cat([r["augment"][k] for r in runs["ranks"]])
        torch.testing.assert_close(got, want[k], rtol=0, atol=1e-5,
                                   msg=k)


@pytest.mark.parametrize("path", ["kernel_path", "plain_path"])
def test_k2_statistics_become_the_global_batchs(runs, path):
    """The per-view (2, M) mean and variance each rank holds after the
    collective between K2 and K3 (``global_stats``), and after the plain
    version's ``cross_rank`` moments, are those of the global batch."""
    want = runs["one"]["k2_stats"]
    for r in runs["ranks"]:
        for got, w in zip(r["k2_stats"][path], want):
            torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["w2_next", "w1_ckpt_next"])
def test_checkpoints_cross_world_sizes(runs, case):
    """A world-2 checkpoint resumed at world 1, and a world-1 checkpoint
    resumed at world 2 (read on rank 0 and broadcast), give the same next
    step as the other world size."""
    got, want = runs["ranks"][0][case], runs["one"][case]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_update_close(got, want, runs["sd"], case)


def test_preemption_stops_every_rank_at_the_same_step(runs):
    """One rank's SIGTERM during step 2 stops both ranks after step 2;
    rank 0 alone writes the checkpoint (save_1) and the epoch log."""
    for r in runs["ranks"]:
        assert r["preempt"] == dict(steps=2, preempted=True, epochs=1)
    assert runs["preempt"]["save"]
    assert runs["preempt"]["logs"] == [
        "UCF101_train_clip4modelr21d1.log", "config.json", "save_1"]


def test_finetune_loop_at_world_size_2(runs):
    """``run_finetune`` at world size 2: the same history on both ranks (the
    validation sums are over both ranks' shards), and rank 0 alone writing
    the logs and the one best checkpoint."""
    r0, r1 = (r["ft_loop"] for r in runs["ranks"])
    assert r0 == r1
    (row,) = r0["history"]
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
    assert r0["best"] == 1
    assert runs["ft_files"] == [
        "config.json", "save_1_max", "train_UCF101_clip4modelr21d1.log",
        "val_UCF101_clip4modelr21d1.log"]


def test_loader_shards_are_disjoint_and_cover_the_epoch():
    """Each rank's loader takes its interleaved share of the epoch's
    permutation: the shares are disjoint, cover the epoch and give every
    rank the same number of batches."""
    from cstp_tpu_torch.data import loader as L
    from cstp_tpu_torch.data.synthetic import SyntheticVideoDataset

    n, bs = 12, 3
    ds = SyntheticVideoDataset(n_videos=n, n_classes=3, ingest_hw=(12, 16))
    shares = []
    for r in range(WORLD):
        kw = dict(seed=2, num_workers=1, process_index=r,
                  process_count=WORLD)
        loaders = (L.PretrainLoader(ds, bs, T, **kw),
                   L.FinetuneLoader(ds, bs, T, train=True, **kw))
        for loader in loaders:
            assert len(list(loader.epoch(1))) == len(loader) == 2
        shares.append(set(L._shard(L._epoch_permutation(n, 1, 2, True), r,
                                   WORLD).tolist()))
    assert not shares[0] & shares[1]
    assert shares[0] | shares[1] == set(range(n))


@pytest.mark.parametrize("env,exc", [
    (dict(RANK="0"), ValueError),
    (dict(RANK="2", WORLD_SIZE="2"), ValueError),
    (dict(CSTP_COORDINATOR="127.0.0.1:1"), ValueError),
    (dict(RANK="0", WORLD_SIZE="2", CSTP_PROCESS_ID="0"), ValueError),
    (dict(CSTP_AUTO_DISTRIBUTED="1"), NotImplementedError),
    (dict(RANK="0", WORLD_SIZE="2"), RuntimeError),
])
def test_bad_rendezvous_raises(tmp_path, monkeypatch, env, exc):
    """A partial, inconsistent or unreachable rendezvous raises; the
    process never carries on alone."""
    import torch.distributed as dist

    from cstp_tpu_torch.parallel import mesh

    for k in list(os.environ):
        if k.startswith(("CSTP_", "MASTER_")) or k in ("RANK", "WORLD_SIZE",
                                                        "LOCAL_RANK"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mesh, "TIMEOUT_S", 2)
    with pytest.raises(exc):
        mesh.maybe_initialize_distributed(
            init_method=f"file://{tmp_path / 'store'}", device="cpu")
    assert not dist.is_initialized()


def test_mesh_resolves_against_the_world_size():
    from cstp_tpu_torch.parallel import mesh

    assert mesh.create_mesh((-1, 1), world=4) == mesh.Mesh(4, 1)
    assert mesh.create_mesh((2, 1), world=2) == mesh.Mesh(2, 1)
    with pytest.raises(ValueError):
        mesh.create_mesh((2, 1), world=4)
    assert mesh.create_mesh((1, 2), world=2) == mesh.Mesh(1, 2)
    assert mesh.create_mesh((-1, 2), world=4) == mesh.Mesh(2, 2)
    with pytest.raises(ValueError):
        mesh.create_mesh((1, 2), world=4)
    assert mesh.shard_rows(torch.arange(8), 1, 4).tolist() == [2, 3]


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(*sys.argv[1:3])
