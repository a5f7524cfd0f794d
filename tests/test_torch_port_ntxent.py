"""The port's NT-Xent (``cstp_tpu_torch/ssl/ntxent.py``) against the JAX
package's, on the CPU in float32: the loss and its gradient; the loss
gathered over two gloo ranks (subprocesses running this file as a script)
against JAX's loss of the global batch; and one pretrain step with
``--ntxent_weight 0.5`` against JAX's train program, from the same bridged
weights and views, to ``test_torch_port_pretrain.py``'s tolerances
(metrics and BN running statistics rtol 1e-4, the update leaf by leaf in
norm within 5e-2 relative).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
B, D = 6, 16            # rows per view and projection width
TEMPERATURE = 0.5
WORLD = 2


def _projections(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


def _jax_loss_and_grads(zi, zj):
    import jax

    from cstp_tpu.ssl.ntxent import ntxent_loss as jax_ntxent

    loss, grads = jax.value_and_grad(
        lambda a, b: jax_ntxent(a, b, TEMPERATURE), argnums=(0, 1))(zi, zj)
    return float(loss), [np.asarray(g) for g in grads]


def test_ntxent_loss_and_gradient_match_jax():
    from cstp_tpu_torch.ssl.ntxent import ntxent_loss

    zi, zj = _projections()
    want, want_grads = _jax_loss_and_grads(zi, zj)
    ti = torch.from_numpy(zi).requires_grad_()
    tj = torch.from_numpy(zj).requires_grad_()
    loss = ntxent_loss(ti, tj, TEMPERATURE)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    for got, w in zip((ti.grad, tj.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-7)


def _worker(store: str, out: str) -> None:
    """One rank: NT-Xent of its rows of both views with the negatives
    gathered over the ranks; the loss and its rows' gradients to ``out``."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.ssl.ntxent import cross_replica_ntxent

    torch.set_num_threads(1)
    mesh.maybe_initialize_distributed(init_method=f"file://{store}",
                                      device="cpu")
    zi, zj = (torch.from_numpy(mesh.shard_rows(z)).requires_grad_()
              for z in _projections())
    loss = cross_replica_ntxent(zi, zj, TEMPERATURE)
    loss.backward()
    torch.save(dict(loss=float(loss), gi=zi.grad, gj=zj.grad),
               f"{out}_{mesh.rank()}.pt")
    mesh.shutdown()


def test_gathered_loss_over_two_ranks_is_the_global_loss(tmp_path):
    """Each rank's gathered loss is JAX's loss of the global batch, and its
    rows' gradient is the world size times the global loss's gradient of
    those rows (the gather's backward sums the ranks' gradients; the
    train step's average divides it back)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CSTP_", "MASTER_"))}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp_path / "store"),
         str(tmp_path / "out")],
        env=dict(env, RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    want, (wi, wj) = _jax_loss_and_grads(*_projections())
    n = B // WORLD
    for r in range(WORLD):
        got = torch.load(tmp_path / f"out_{r}.pt")
        np.testing.assert_allclose(got["loss"], want, rtol=1e-5)
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(got["gi"].numpy() / WORLD, wi[rows],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["gj"].numpy() / WORLD, wj[rows],
                                   rtol=1e-5, atol=1e-7)


# --------------------------------------------- the step with the term

S_B, S_T, S_S = 4, 4, 32
LR = 3e-4
KEYS = ("view1", "view2", "spa", "tem", "pb", "rot1", "rot2")


def _view(rng):
    noise = rng.uniform(-1, 1, (S_B, S_T, S_S, S_S, 3))
    off = rng.uniform(-0.8, 0.8, (S_B, 1, 1, 1, 3))
    contrast = rng.uniform(0.1, 1.0, (S_B, 1, 1, 1, 1))
    return np.clip(off + contrast * noise, -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def ntxent_step():
    import jax
    import jax.numpy as jnp

    from cstp_tpu.config import Config as JaxConfig
    from cstp_tpu.train.pretrain import (
        create_pretrain_state as jax_create_state,
        split_pretrain_step as jax_split_step,
    )
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.models.bridge import (
        export_jax_variables,
        load_jax_variables,
    )
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_preaugmented_step,
    )

    kw = dict(model_name="r21d", model_depth=1, sample_duration=S_T,
              sample_size=S_S, batch_size=S_B, compute_dtype="float32",
              fused_conv=1, learning_rate=LR, ntxent_weight=0.5,
              temperature=TEMPERATURE)
    jcfg = JaxConfig(**kw).finalize()
    jmodel, jstate, jtx = jax_create_state(jcfg, jax.random.PRNGKey(0))
    params0, stats0 = jax.tree_util.tree_map(np.asarray, jax.device_get(
        (jstate.params, jstate.batch_stats)))
    cfg = Config(**kw).finalize()
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    load_jax_variables(model, params0, stats0)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 5, (S_B,)).astype(np.int32)
             for k in ("spa", "tem", "pb")}
    batch.update(rot1=rng.integers(0, 4, (S_B,)).astype(np.int32),
                 rot2=rng.integers(0, 4, (S_B,)).astype(np.int32),
                 view1=_view(rng), view2=_view(rng))
    _, jtrain = jax_split_step(jmodel, jtx, jcfg)
    jstate, jm = jtrain(jstate, tuple(jnp.asarray(batch[k]) for k in KEYS),
                        jnp.float32(LR))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # JAX's threads hold the other cores
    try:
        state, pm = make_preaugmented_step(model, tx, cfg)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()}, LR)
    finally:
        torch.set_num_threads(threads)
    params, stats = export_jax_variables(model)
    return dict(jm={k: float(v) for k, v in jm.items()},
                pm={k: float(v) for k, v in pm.items()},
                params=params, stats=stats, params0=params0,
                jparams=jax.tree_util.tree_map(np.asarray, jstate.params),
                jstats=jax.tree_util.tree_map(np.asarray,
                                              jstate.batch_stats))


def _flat(tree):
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_ntxent_step_metrics_match_jax(ntxent_step):
    jm, pm = ntxent_step["jm"], ntxent_step["pm"]
    assert pm.keys() == jm.keys()
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    # the total holds 0.5 x NT-Xent beside the seven weighted terms; at
    # random weights the term is near log(2B - 1) = 1.95
    from cstp_tpu_torch.config import Config

    w = Config().loss_weight
    rest = (w[0] * pm["loss_byol"] + w[1] * pm["loss_pred_spa"]
            + w[2] * pm["loss_pred_tem"] + 2 * w[3] * pm["loss_pred_pb"]
            + 2 * w[4] * pm["loss_pred_rot"])
    assert 0.5 < (pm["loss"] - rest) / 0.5 < 4.0


def test_ntxent_step_batch_stats_match_jax(ntxent_step):
    got, want = _flat(ntxent_step["stats"]), _flat(ntxent_step["jstats"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_ntxent_step_updates_match_jax(ntxent_step):
    got, want = _flat(ntxent_step["params"]), _flat(ntxent_step["jparams"])
    p0 = _flat(ntxent_step["params0"])
    assert got.keys() == want.keys()
    floor = 1e-4 * np.sqrt(sum(np.sum((want[k] - p0[k]).astype(np.float64)
                                      ** 2) for k in p0))
    for k in p0:
        d_got, d_want = got[k] - p0[k], want[k] - p0[k]
        err = np.linalg.norm(d_got - d_want)
        assert err <= 5e-2 * np.linalg.norm(d_want) + floor, (
            f"{k}: |got - want| {err:.3e}, |want| "
            f"{np.linalg.norm(d_want):.3e}")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(*sys.argv[1:3])
