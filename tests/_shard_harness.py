"""What the ``--shard_spatial`` family tests share
(``test_torch_port_shard_families.py`` and
``test_torch_port_shard_inception.py``): their gloo ranks, each a
subprocess running the test file as a script; the whole-state digests;
the numpy-seeded views; ``test_torch_port_model_axis``'s tolerance rules;
and JAX's train programs from the port's weights.

Importing this module imports no JAX: the workers import it too.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")
TIMEOUT_S = 420         # each launch's limit, for a loaded host


# ------------------------------------------------------------ the states

def digest(tensors) -> str:
    """The bytes of ``tensors`` (a name -> tensor dict), hashed in name
    order."""
    h = hashlib.sha1()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def is_stat(name):
    return name.endswith(("mean", "var"))


def split_state(sd):
    """A whole state dict as the tests read it: the trained tensors
    (everything but the target tower's parameters and the BN running
    statistics), the statistics, and a hash of the target's parameters."""
    target = {k: v for k, v in sd.items()
              if k.startswith("target_net.") and not is_stat(k)}
    return dict(
        params={k: v.detach().clone() for k, v in sd.items()
                if k not in target and not is_stat(k)},
        stats={k: v.detach().clone() for k, v in sd.items() if is_stat(k)},
        target=digest(target))


# ------------------------------------------------------------ the ranks

def worker(store: str, tmp: str, job: str, jobs, run, inputs) -> None:
    """One process of ``job`` (of ``jobs``: job -> (world size, its
    cases)): one process without a group, or a rank of its (1, 2) or (2,
    2) mesh, running ``run(case)`` for each case after loading
    ``<tmp>/inputs.pt`` into ``inputs``; results to ``<job>_<rank>.pt``,
    rank 0 with the tensors, the other ranks their hashes only."""
    from cstp_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    inputs.update(torch.load(Path(tmp) / "inputs.pt", weights_only=False))
    world, cases = jobs[job]
    if world > 1:
        mesh.maybe_initialize_distributed(init_method=f"file://{store}",
                                          device="cpu")
        mesh.use_mesh((1, 2) if world == 2 else (2, 2))
    out = {name: run(name) for name in cases}
    rank = mesh.rank()
    if rank:
        for got in out.values():
            if isinstance(got, dict) and "params" in got:
                del got["params"], got["stats"]
    mesh.shutdown()
    torch.save(out, Path(tmp) / f"{job}_{rank}.pt")


def launch(script: str, tmp: Path, job: str, world: int):
    """The ``world`` processes of ``job``, each ``script`` run as the
    worker, with a store file of their own under ``tmp``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CSTP_", "MASTER_"))}
    env["PYTHONPATH"] = str(ROOT)
    return [subprocess.Popen(
        [sys.executable, script, str(tmp / f"store_{job}"), str(tmp), job],
        env=dict(env, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def join(procs, tmp: Path, job: str):
    """The results of ``job``'s processes, each waited for at most
    ``TIMEOUT_S`` and killed past it."""
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
        assert p.returncode == 0, f"{job} rank {r} exited " \
                                  f"{p.returncode}:\n{log}"
    return [torch.load(tmp / f"{job}_{r}.pt", weights_only=False, mmap=True)
            for r in range(len(procs))]


# ------------------------------------------------------------ the inputs

def view(rng, b, t, s):
    noise = rng.uniform(-1, 1, (b, t, s, s, 3))
    off = rng.uniform(-0.8, 0.8, (b, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (b, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


def views(rng, t, s, b):
    """A preaugmented pretrain batch of ``b`` clips a view; these
    families' pretext heads have 4 playback-rate and rotation classes."""
    batch = {k: rng.integers(0, 5, (b,)).astype(np.int32)
             for k in ("spa", "tem")}
    batch.update(pb=rng.integers(0, 4, (b,)).astype(np.int32),
                 rot1=rng.integers(0, 4, (b,)).astype(np.int32),
                 rot2=rng.integers(0, 4, (b,)).astype(np.int32),
                 view1=view(rng, b, t, s), view2=view(rng, b, t, s))
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# ------------------------------------------------------- the tolerances

def rel(a, b):
    return float((a - b).norm() / b.norm())


def cos(a, b):
    return float(a @ b / (a.norm() * b.norm()))


def assert_ranks_agree(ranks, case):
    """Every rank holds bitwise the same whole state after ``case``."""
    assert len({r[case]["whole"] for r in ranks}) == 1, case


def assert_updates_close(got, want, sd0, tol, what):
    """Each trained tensor's update within ``tol`` of the wanted one in
    norm, plus 1e-4 of the whole wanted update's norm."""
    assert got.keys() == want.keys() == sd0.keys(), what
    d_all = torch.cat([(want[k] - sd0[k]).flatten().double() for k in sd0])
    floor = 1e-4 * float(d_all.norm())
    assert floor > 0, what
    for k in sd0:
        d_got = (got[k] - sd0[k]).double()
        d_want = (want[k] - sd0[k]).double()
        err = float((d_got - d_want).norm())
        assert err <= tol * float(d_want.norm()) + floor, (
            f"{what} {k}: |got - want| {err:.3e}, |want| "
            f"{float(d_want.norm()):.3e}")


def assert_stats_close(got, want, what, skip=()):
    """BN running statistics within 1e-4 relative, outside the leaves
    that start with one of ``skip``; returns how many were skipped."""
    assert got.keys() == want.keys(), what
    held = [k for k in want if not k.startswith(skip)]
    for k in held:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} {k}")
    return len(want) - len(held)


def assert_step_close(got, want, sd0, what, target=True):
    """The first loss within 1e-5 relative, the update within 5e-2 leaf by
    leaf, BN running statistics within 1e-4, and (``target``) the target
    tower bitwise."""
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=1e-5,
                               err_msg=what)
    if target:
        assert got["target"] == want["target"], what
    assert_stats_close(got["stats"], want["stats"], what)
    assert_updates_close(got["params"], want["params"], sd0, 5e-2, what)


# ------------------------------------------------------------ JAX's side

def jax_steps(programs, nets, batch, models, lr):
    """JAX's train programs ``programs`` (key -> (model, mesh shape)):
    (1, 2) with ``shard_spatial=1`` on the first two of the conftest's CPU
    devices, (1, 1) on the first alone, each from the port's seed-0
    pretrain model ``nets[model]`` (JAX's ``init`` patched to return its
    weights) on ``batch[model]``, ``models[model]`` its (flags, frames,
    size, per-view batch); compiled and run in a thread each. Each
    program's metrics and the state after it, read back into the port's
    names through its model."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from cstp_tpu.config import Config as JaxConfig
    from cstp_tpu.parallel import mesh as jax_mesh
    from cstp_tpu.parallel import shard_batch, shard_state
    from cstp_tpu.ssl.byol import CSTPPretrain as JaxPretrain
    from cstp_tpu.train.pretrain import (
        create_pretrain_model,
        create_pretrain_state as jax_state,
        split_pretrain_step,
    )
    from cstp_tpu_torch.models.bridge import (
        export_jax_variables,
        load_jax_variables,
    )

    made = jax_mesh.create_mesh

    def create_mesh(shape=(-1, 1), axes=("data", "model"), devices=None):
        return made(shape, axes, jax.devices()[:int(np.prod(shape))])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mesh, "create_mesh", create_mesh)
        built = {}
        for key, (model, shape) in programs.items():
            flags, t, s, b = models[model]
            jmesh = jax_mesh.create_mesh(shape)
            params0, stats0 = jax.tree_util.tree_map(
                np.copy, export_jax_variables(nets[model]))
            jcfg = JaxConfig(sample_duration=t, sample_size=s, batch_size=b,
                             compute_dtype="float32", learning_rate=lr,
                             mesh_shape=shape,
                             shard_spatial=int(shape[1] > 1),
                             **flags).finalize()
            with pytest.MonkeyPatch.context() as init:
                init.setattr(JaxPretrain, "init", lambda self, *a, **k: {
                    "params": params0, "batch_stats": stats0})
                _, state, jtx = jax_state(jcfg, jax.random.PRNGKey(0))
            _, train = split_pretrain_step(create_pretrain_model(jcfg), jtx,
                                           jcfg)
            views_ = shard_batch(jmesh, tuple(jnp.asarray(batch[model][k])
                                              for k in KEYS))
            built[key] = (train, shard_state(jmesh, state), views_)

        def run(key):
            train, state, views_ = built[key]
            state, m = train(state, views_, jnp.float32(lr))
            return m, jax.tree_util.tree_map(np.asarray, jax.device_get(
                (state.params, state.batch_stats)))

        with ThreadPoolExecutor(len(built)) as pool:
            done = dict(zip(built, pool.map(run, built)))
    out = {}
    for key, (m, (params, stats)) in done.items():
        net = nets[programs[key][0]]
        load_jax_variables(net, params, stats)
        out[key] = split_state(net.state_dict())
        out[key]["metrics"] = {k: float(v) for k, v in m.items()}
    return out
