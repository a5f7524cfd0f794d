"""Entry points for a check of the port: the counterparts of the JAX
package's ``__graft_entry__.entry`` and ``dryrun_multichip``.

    fn, args = entry()          # on the card
    byol, logits = fn(*args)

``fn(model, x1, x2)`` is the flagship forward: R(2+1)D depth 1 pretraining
(``r21d_byol``, task ``loss_com``), 8 x 112^2 clips, bf16, in train mode,
so the BatchNorm running statistics are updated. It returns the BYOL loss
and the six pretext logits ``(spa, tem, pb1, pb2, rot1, rot2)``.

``dryrun_multichip(n)`` runs the mesh-parallel steps in ``n`` gloo
processes on the CPU at tiny shapes (``python -m
cstp_tpu_torch.graft_entry --dryrun N``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from cstp_tpu_torch import resolve_device
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.train.pretrain import create_pretrain_model

def entry(device=None):
    """``(fn, example_args)``: the forward and ``(model, x, x)``, with the
    model's weights drawn from seed 0 and ``x`` two zero clips in bf16, on
    CUDA unless ``device="cpu"`` is asked for."""
    dev = resolve_device(device)
    cfg = Config(model_name="r21d", model_depth=1, sample_duration=8,
                 sample_size=112, compute_dtype="bfloat16").finalize()
    model = create_pretrain_model(cfg, device=dev)
    x = torch.zeros((2, cfg.sample_duration, cfg.sample_size,
                     cfg.sample_size, 3), dtype=torch.bfloat16, device=dev)

    def fwd(model, x1, x2):
        return model(x1, x2, train=True)

    return fwd, (model, x, x)


def _dryrun_variants(n: int) -> None:
    """One rank's share of :func:`dryrun_multichip`: each variant's step on
    this rank's rows of a seeded global batch (2 clips per rank), on the
    JAX package's mesh: ``(n / 2, 2)`` where ``n`` is even and at least 4
    (tensor-parallel MLPs), else ``(n, 1)``; ``--shard_spatial`` takes
    ``(n / 2, 2)`` at every even ``n``. Rank 0 prints one line per
    variant."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train.finetune import (
        create_finetune_state,
        make_eval_step,
        make_features_step,
        make_finetune_step,
    )
    from cstp_tpu_torch.train.pretrain import (
        create_pretrain_state,
        make_pretrain_step,
    )

    def say(msg):
        if mesh.is_main():
            print(f"dryrun_multichip({n}) {msg}", flush=True)

    def gen():
        return torch.Generator().manual_seed(1)

    model_par = 2 if n % 2 == 0 and n >= 4 else 1
    small = dict(model_name="r21d", model_depth=1, sample_duration=4,
                 sample_size=32, batch_size=2 * n, compute_dtype="float32",
                 mesh_shape=(n // model_par, model_par))
    spatial = dict(shard_spatial=1,
                   mesh_shape=(n // 2, 2) if n % 2 == 0 else (n, 1))
    rng = np.random.default_rng(0)
    b, t = 2 * n, small["sample_duration"]

    def frames():
        return torch.from_numpy(
            rng.integers(0, 255, (b, t, 48, 64, 3)).astype(np.uint8))

    def labels(k):
        return torch.from_numpy(rng.integers(0, k, (b,)).astype(np.int64))

    batch = {"frames1": frames(), "frames2": frames(), "rot1": labels(4),
             "rot2": labels(4), "tem": labels(5), "pb": labels(4)}
    for name, over in (("default", {}), ("sync_bn=0", {"sync_bn": 0}),
                       ("shard_opt_state", {"shard_opt_state": 1}),
                       ("shard_spatial", spatial)):
        cfg = Config(**dict(small, **over)).finalize()
        model, state, tx = create_pretrain_state(cfg, device="cpu")
        mesh.replicate(model)
        step = make_pretrain_step(model, tx, cfg)
        state, metrics = step(state, gen(), mesh.shard_batch(batch), 0.01)
        loss = float(metrics["loss"])
        assert np.isfinite(loss), loss
        say(f"[{name}]: mesh {cfg.mesh_shape} loss={loss:.4f} ok")

    cfg = Config(**small, task="ft_all", n_finetune_classes=5).finalize()
    model, state, tx = create_finetune_state(cfg, 5, device="cpu")
    mesh.replicate(model)
    ft = mesh.shard_batch({"frames": frames(), "labels": labels(5)})
    state, metrics = make_finetune_step(model, tx, cfg)(state, gen(), ft,
                                                       0.01)
    ev = make_eval_step(model, cfg)(state, ft)
    ft_loss, ev_loss = float(metrics["loss"]), float(ev["loss_sum"]) / b
    assert np.isfinite(ft_loss) and np.isfinite(ev_loss), (ft_loss, ev_loss)
    assert float(ev["count"]) == b, float(ev["count"])
    say(f"[finetune+eval]: ft_loss={ft_loss:.4f} eval_loss={ev_loss:.4f} ok")

    feats = make_features_step(model, cfg)(state, mesh.shard_rows(frames()))
    norms = torch.linalg.vector_norm(feats, dim=-1)
    assert bool(torch.isfinite(feats).all()), feats
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-3), norms
    say(f"[retrieval]: feats={tuple(feats.shape)} per rank, unit-norm ok")


def dryrun_multichip(n: int, timeout: float = 300.0) -> str:
    """The JAX package's ``dryrun_multichip`` over ``n`` gloo processes on
    the CPU (one per rank, rendezvous through a ``file://`` store): the
    pretrain step with ``--sync_bn 1`` and ``0``, ``--shard_opt_state`` and
    ``--shard_spatial``, the finetune step with the eval step, and the
    retrieval features, on tiny shapes. Prints and returns rank 0's lines,
    one ``ok`` line per variant; raises if a rank fails."""
    with tempfile.TemporaryDirectory(prefix="cstp_dryrun_") as d:
        store = os.path.join(d, "store")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        base = {k: v for k, v in os.environ.items()
                if not k.startswith(("CSTP_", "MASTER_"))}
        base["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
        procs = []
        for r in range(n):
            env = dict(base, RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cstp_tpu_torch.graft_entry",
                 "--dryrun-rank", str(n), store],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        r, rc, out = bad[0]
        raise RuntimeError(f"dryrun_multichip({n}): rank {r} exited {rc}:\n"
                           f"{out}")
    print(outs[0], end="", flush=True)
    return outs[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="dryrun_multichip(N): N gloo processes on the CPU")
    ap.add_argument("--dryrun-rank", nargs=2, metavar=("N", "STORE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dryrun_rank:
        from cstp_tpu_torch.parallel import mesh

        torch.set_num_threads(1)
        n, store = int(args.dryrun_rank[0]), args.dryrun_rank[1]
        mesh.maybe_initialize_distributed(init_method=f"file://{store}",
                                          device="cpu")
        try:
            _dryrun_variants(n)
        finally:
            mesh.shutdown()
    elif args.dryrun:
        dryrun_multichip(args.dryrun)
    else:
        ap.print_help()


if __name__ == "__main__":
    main()
