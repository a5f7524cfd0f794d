"""``run_test`` and ``run_retrieval`` (``cstp_tpu_torch/train/loops.py``)
under a process group, on the CPU: two gloo ranks, each a subprocess
running this file as a script (the worker below), against the same loops
run in one process. The one-process runs are held to the JAX package's by
``tests/test_torch_port_loops.py``.

Size: R(2+1)D depth 1 at 4 x 32^2, float32, 5 synthetic videos (an uneven
split over two data rows: 3 and 2), 1-4 windows each, BN running variances
moved off 1 and a ``classInd.txt``, so the reports carry class names and
retrieval's per-class lines.

What is held, and how: over 'data' (``--mesh_shape -1 1``) each video runs
on one rank with the weights and the input it has in one process, so the
per-video logits, the report files (each line's running accuracy, the
accuracy, the recalls and the per-class lines, and the config record) and
the returned results are bitwise the one-process run's, float and
``--quant int8_static``; rank 1 opens no file for writing. Over 'model'
(``--mesh_shape 1 2 --shard_spatial 1``) each video's forward is split in
H between the two ranks, whose sums reach the pool in another order: the
logits are held within 1e-5 and the accuracy equal.

The ranks run in the background with a timeout, so a hang fails the test
instead of eating the suite. Nothing here imports JAX.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
T, S, N_CLASSES, N_VIDEOS = 4, 32, 5, 5
# pb_rate 25: window span 76, so the synthetic videos (40-300 frames) give
# 1-4 test windows each
PB = 25
WORLD = 2
TIMEOUT_S = 120
# name -> (runner, config flags over _config's)
RUNS = {
    "test": ("run_test", dict(task="test")),
    "retrieval": ("run_retrieval", dict(task="retrieval",
                                        retrieval_clips=2)),
    "test_int8": ("run_test", dict(task="test", quant="int8_static",
                                   test_md_path="int8")),
    "test_spatial": ("run_test", dict(task="test", mesh_shape=(1, 2),
                                      shard_spatial=1)),
}


def _config(root: Path, **over):
    from cstp_tpu_torch.config import Config

    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, compute_dtype="float32",
              data_backend="synthetic", synthetic_len=N_VIDEOS,
              n_classes=N_CLASSES, n_finetune_classes=N_CLASSES, pb_rate=PB,
              result_path=str(root / "results"), n_workers=1, log_every=0,
              t_ft_task="ft_all", annotation_path=str(root / "ann"))
    kw.update(over)
    if kw.get("test_md_path"):
        kw["test_md_path"] = str(root / kw["test_md_path"])
    return Config(**kw).finalize()


def _run(root: Path, name: str):
    """One of RUNS through ``train.loops``: its result, the logits of
    every window batch this process ran, in order, and the report's text
    (rank 0)."""
    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train import loops

    runner, over = RUNS[name]
    seen = []
    make = loops.make_logits_step

    def recording(model, config):
        step = make(model, config)

        def run(state, windows):
            out = step(state, windows)
            seen.append(out.detach().numpy().copy())
            return out

        return run

    loops.make_logits_step = recording
    try:
        out = getattr(loops, runner)(_config(root, **over), device="cpu")
    finally:
        loops.make_logits_step = make
    report = open(out["report"]).read() if mesh.is_main() else None
    return dict(out=out, logits=seen, report=report)


# ------------------------------------------------------------- worker

def _worker(store: str, root: str) -> None:
    """One rank: every RUNS entry; its results to ``out_<rank>.pt``. A
    rank other than 0 records every file the loops open for writing."""
    import builtins

    from cstp_tpu_torch.parallel import mesh
    from cstp_tpu_torch.train import loops

    torch.set_num_threads(1)
    mesh.maybe_initialize_distributed(init_method=f"file://{store}",
                                      device="cpu")
    root = Path(root)
    writes = []
    if not mesh.is_main():
        def guarded(file, mode="r", *a, **k):
            if any(c in mode for c in "wax+"):
                writes.append(str(file))
            return builtins.open(file, mode, *a, **k)

        loops.open = guarded
    out = {name: _run(root, name) for name in RUNS}
    out["writes"] = writes
    torch.save(out, root / f"out_{mesh.rank()}.pt")
    mesh.shutdown()


# ---------------------------------------------------------- test side

def _checkpoints(root: Path) -> None:
    """A finetune checkpoint ``save_1_max`` under the run's ``ft_all``
    (float, BN running variances moved off 1) and the same weights with
    every ``act_scale`` at 0.05 as ``int8`` (an ``int8_static`` model's)."""
    from cstp_tpu_torch.ckpt import checkpoint as ck
    from cstp_tpu_torch.train.finetune import create_finetune_state

    cfg = _config(root, task="test")
    _, state, _ = create_finetune_state(cfg, N_CLASSES, seed=9,
                                        device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for n, b in state.model.named_buffers():
            if n.endswith(".var"):
                b.mul_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, b.shape).astype(np.float32)))
    ck.save_checkpoint(
        str(root / "results" / "UCF101" / "ft_all" / "save_1_max"),
        ck.state_tree(state), meta={"arch": cfg.arch, "epoch": 2})
    qcfg = _config(root, task="test", quant="int8_static")
    _, qstate, _ = create_finetune_state(qcfg, N_CLASSES, seed=9,
                                         device="cpu")
    ck.load_model_by_name(qstate.model, ck.state_tree(state))
    with torch.no_grad():
        for n, b in qstate.model.named_buffers():
            if n.endswith("act_scale"):
                b.fill_(0.05)
    ck.save_checkpoint(str(root / "int8"), ck.state_tree(qstate),
                       meta={"arch": qcfg.arch, "epoch": 2})
    os.makedirs(root / "ann")
    with open(root / "ann" / "classInd.txt", "w") as f:
        for c in range(N_CLASSES):
            f.write(f"{c + 1} Class{c}\n")


def _launch(root: Path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CSTP_", "MASTER_"))}
    env["PYTHONPATH"] = str(ROOT)
    return [subprocess.Popen(
        [sys.executable, __file__, str(root / "store"), str(root)],
        env=dict(env, RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


def _join(procs, root: Path):
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
    return [torch.load(root / f"out_{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process runs first (the ranks then write the same report
    files), then the two ranks."""
    root = tmp_path_factory.mktemp("eval_ranks")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _checkpoints(root)
        one = {name: _run(root, name) for name in RUNS
               if name != "test_spatial"}
        ranks = _join(_launch(root), root)
    finally:
        torch.set_num_threads(threads)
    yield dict(one=one, ranks=ranks)
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("name", ["test", "retrieval", "test_int8"])
def test_world2_reports_are_the_one_process_reports(runs, name):
    one, ranks = runs["one"][name], runs["ranks"]
    assert ranks[0][name]["report"] == one["report"]
    if name != "retrieval":
        assert "Video accuracy = " in one["report"]
        assert one["report"].count("Video[") == N_VIDEOS
        assert "(Class" in one["report"]
    else:
        assert "R@1[" in one["report"]
    for r in ranks:
        assert r[name]["out"] == one["out"]


@pytest.mark.parametrize("name", ["test", "test_int8"])
def test_each_rank_runs_its_videos_with_the_one_process_logits(runs, name):
    """Video ``i`` on rank ``i % 2`` (3 and 2 videos), each with bitwise
    the one-process run's logits."""
    one, ranks = runs["one"][name]["logits"], runs["ranks"]
    assert len(one) == N_VIDEOS
    for r, rank in enumerate(ranks):
        got = rank[name]["logits"]
        assert len(got) == len(range(r, N_VIDEOS, WORLD))
        for k, logits in enumerate(got):
            np.testing.assert_array_equal(logits, one[r + WORLD * k])


def test_no_rank_but_0_writes_a_file(runs):
    assert runs["ranks"][1]["writes"] == []


def test_shard_spatial_test_on_h_shards(runs):
    """(1, 2) ``--shard_spatial``: both 'model' ranks run every video with
    its frames split in H; the logits within 1e-5 of one process's and the
    accuracy equal."""
    one = runs["one"]["test"]
    for rank in runs["ranks"]:
        got = rank["test_spatial"]
        assert len(got["logits"]) == N_VIDEOS
        for a, b in zip(got["logits"], one["logits"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert got["out"]["accuracy"] == one["out"]["accuracy"]
        assert got["out"]["n_videos"] == N_VIDEOS


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(*sys.argv[1:3])
