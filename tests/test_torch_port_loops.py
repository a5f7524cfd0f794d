"""The port's epoch loops and CLIs, on the CPU.

Against the JAX package (float32, the same synthetic data and weights):
``run_test`` gives the same per-video predictions, accuracy and report
lines (apart from paths and the config line), ``run_retrieval`` the same
R@k and per-video features within rtol 1e-4 (atol 1e-6). The weights are a
JAX finetune state saved as ``save_1_max``, bridged into a port checkpoint
(``models/bridge.py load_jax_variables`` + ``save_checkpoint``).

The loop adds nothing: one ``run_pretrain`` epoch of 2 steps gives bitwise
the row of ``make_pretrain_step`` applied by hand to
``PretrainLoader.epoch(1)`` with a generator seeded ``seed + 17``.

Port-only counterparts of the JAX loop tests: CSV header and rows,
``save_2``, ``--auto_resume``, data echo, the packed backend, best-only
``*_max`` retention, the finetune resume (epochs and plateau learning
rate continue), ``ft_fc`` freezing the backbone, and each CLI's line.
"""

import csv
import dataclasses
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from cstp_tpu.ckpt import checkpoint as jck
from cstp_tpu.config import Config as JConfig
from cstp_tpu.train import loops as jloops
from cstp_tpu.train.finetune import create_finetune_state as jft_state
from cstp_tpu_torch.ckpt import checkpoint as ck
from cstp_tpu_torch.cli import main_byol, main_ft, main_retrieval, main_test
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.data.loader import PretrainLoader
from cstp_tpu_torch.data.packed import PackedWriter
from cstp_tpu_torch.data.synthetic import SyntheticVideoDataset
from cstp_tpu_torch.models.bridge import load_jax_variables
from cstp_tpu_torch.train import loops, optim
from cstp_tpu_torch.train.finetune import create_finetune_state
from cstp_tpu_torch.train.pretrain import (
    create_pretrain_state,
    make_pretrain_step,
)

from _torch_threads import torch_threads  # noqa: F401

T, S, N_CLASSES = 4, 32, 5
# pb_rate 25: window span 76, so the synthetic videos (40-300 frames) give
# 1-4 test windows each, one window bucket, one JAX program per step
PB = 25


@pytest.fixture
def tmp_path(tmp_path):
    """The test's own directory, removed when the test ends, passed or
    failed: its checkpoints, .pth files and CLI outputs are read back
    inside the test, and left behind they would fill the disk over a
    whole run of the suite."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _kw(tmp_path, **over):
    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, compute_dtype="float32",
              data_backend="synthetic", synthetic_len=4, n_classes=N_CLASSES,
              n_finetune_classes=N_CLASSES, pb_rate=PB,
              result_path=str(tmp_path), n_workers=2, log_every=0)
    kw.update(over)
    return kw


def _perturbed(tree, rng):
    """BN running variances moved off their init of 1. The means stay 0:
    the random network's activations shrink layer by layer in eval mode,
    so a shifted mean would dominate the last layers and make every
    video's features the same (a retrieval tie, broken by index, and
    differently in each package)."""
    def move(path, v):
        v = np.asarray(v)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One set of finetune weights twice: a JAX checkpoint ``save_1_max``
    under ``jax/UCF101/ft_all`` and the same weights bridged into a port
    checkpoint under ``port/UCF101/ft_all``."""
    root = tmp_path_factory.mktemp("weights")
    jcfg = JConfig(**_kw(root, task="test")).finalize()
    _, jstate, _ = jft_state(jcfg, jax.random.PRNGKey(4), N_CLASSES)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.params))
    stats = _perturbed(jax.device_get(jstate.batch_stats),
                       np.random.default_rng(1))
    jpath = root / "jax" / "UCF101" / "ft_all" / "save_1_max"
    jck.save_checkpoint(str(jpath), {"params": params, "batch_stats": stats},
                        meta={"arch": jcfg.arch, "epoch": 2})
    cfg = Config(**_kw(root, task="test")).finalize()
    model, state, _ = create_finetune_state(cfg, N_CLASSES, seed=9,
                                            device="cpu")
    load_jax_variables(model, params, stats)
    ppath = root / "port" / "UCF101" / "ft_all" / "save_1_max"
    ck.save_checkpoint(str(ppath), ck.state_tree(state),
                       meta={"arch": cfg.arch, "epoch": 2})
    yield dict(root=root, params=params, stats=stats)
    shutil.rmtree(root, ignore_errors=True)


def _report_lines(path):
    """The report without its config record (a JSON dump that ends with a
    line "}"); paths do not appear in the rest."""
    return open(path).read().split("\n}\n", 1)[1].split("\n")


def test_the_pretrain_loop_adds_nothing_to_the_step(tmp_path):
    cfg = Config(**_kw(tmp_path, task="loss_com", batch_size=4,
                       synthetic_len=8, n_epochs=1, steps_per_epoch=2,
                       learning_rate=0.03, manual_seed=3)).finalize()
    out = loops.run_pretrain(cfg, device="cpu")
    assert len(out["history"]) == 1 and out["timing"][0]["steps"] == 2

    model, state, tx = create_pretrain_state(cfg, seed=3, device="cpu")
    step = make_pretrain_step(model, tx, cfg)
    loader = PretrainLoader(loops.build_dataset(cfg, "train"), 4, T, seed=3,
                            num_workers=2)
    gen = torch.Generator().manual_seed(3 + 17)
    lr = optim.cosine_warmup_restarts(0.03, 1, 0.5)(0)
    metrics = []
    for _, batch in zip(range(2), loader.epoch(1)):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        state, m = step(state, gen, batch, lr)
        metrics.append(m)
    mean = {k: float(np.mean(torch.stack([m[k] for m in metrics]).numpy()))
            for k in metrics[0]}
    row = {"epoch": 1, "loss": mean["loss"], "loss_byol": mean["loss_byol"],
           "loss_pred_spa": mean["loss_pred_spa"],
           "loss_pred_tem": mean["loss_pred_tem"],
           "loss_pred_pb": mean["loss_pred_pb"],
           "loss_pred_rot": mean["loss_pred_rot"],
           "acc": mean["acc_pretext"], "lr": float(f"{lr:.5f}")}
    assert out["history"][0] == row
    loop_params = dict(out["model"].named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(loop_params[n], p), n


def _pretrain_argv(tmp_path, *extra):
    return ["--model_name", "r21d_byol", "--model_depth", "1",
            "--data_backend", "synthetic", "--synthetic_len", "8",
            "--dataset", "UCF101", "--sample_duration", str(T),
            "--sample_size", str(S), "--compute_dtype", "float32",
            "--n_workers", "2", "--result_path", str(tmp_path),
            "--log_every", "0", "--batch_size", "4", "--n_classes",
            str(N_CLASSES), "--learning_rate", "0.03", *extra]


def _rows(log_dir, prefix=""):
    logs = [f for f in os.listdir(log_dir)
            if f.endswith(".log") and f.startswith(prefix)]
    assert len(logs) == 1, logs
    return list(csv.reader(open(os.path.join(log_dir, logs[0])),
                           delimiter="\t"))


def test_pretrain_csv_checkpoints_and_auto_resume(tmp_path, capsys):
    out = main_byol.main(_pretrain_argv(
        tmp_path, "--n_epochs", "2", "--ckpt_every_epochs", "2",
        "--steps_per_epoch", "1"), device="cpu")
    assert [h["epoch"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    log_dir = tmp_path / "UCF101" / "loss_com"
    assert (log_dir / "save_2").is_dir() and not (log_dir / "save_1").exists()
    assert (log_dir / "config.json").is_file()
    rows = _rows(log_dir)
    assert rows[0] == ["epoch", "loss", "loss_byol", "loss_pred_spa",
                       "loss_pred_tem", "loss_pred_pb", "loss_pred_rot",
                       "acc", "lr"]
    assert [r[0] for r in rows[1:]] == ["1", "2"]
    assert all(np.isfinite(float(c)) for r in rows[1:] for c in r)
    # the same command with --auto_resume picks up save_2 and redoes epoch
    # 2, appending to the same log
    out = main_byol.main(_pretrain_argv(
        tmp_path, "--n_epochs", "3", "--ckpt_every_epochs", "2",
        "--steps_per_epoch", "1", "--auto_resume"), device="cpu")
    assert [h["epoch"] for h in out["history"]] == [2, 3]
    assert [r[0] for r in _rows(log_dir)[1:]] == ["1", "2", "2", "3"]
    assert out["state"].step == 4          # 2 steps restored + 2 run
    # without it, a fresh run restarts at epoch 1
    out = main_byol.main(_pretrain_argv(
        tmp_path, "--n_epochs", "1", "--steps_per_epoch", "1"),
        device="cpu")
    assert [h["epoch"] for h in out["history"]] == [1]


def test_pretrain_task_resume_from_save_1(tmp_path):
    main_byol.main(_pretrain_argv(
        tmp_path, "--n_epochs", "1", "--ckpt_every_epochs", "1",
        "--steps_per_epoch", "1"), device="cpu")
    save_1 = tmp_path / "UCF101" / "loss_com" / "save_1"
    out = main_byol.main(_pretrain_argv(
        tmp_path, "--task", "resume", "--resume_md_path", str(save_1),
        "--n_epochs", "2", "--steps_per_epoch", "1"), device="cpu")
    assert [h["epoch"] for h in out["history"]] == [1, 2]


def test_pretrain_data_echo_multiplies_the_steps(tmp_path):
    out = main_byol.main(_pretrain_argv(
        tmp_path, "--n_epochs", "1", "--data_echo", "2", "--profile_dir",
        str(tmp_path / "trace"), "--profile_steps", "1"), device="cpu")
    # 8 videos / batch 4 = 2 host batches -> 4 steps
    assert out["timing"][0]["steps"] == 4 and out["state"].step == 4
    # --profile_dir traced step 3 (the first after two warm-up steps)
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")


def test_pretrain_packed_backend(tmp_path):
    ds = SyntheticVideoDataset(n_videos=8, n_classes=N_CLASSES, seed=2)
    w = PackedWriter(str(tmp_path / "train.cstp"))
    for i in range(8):
        nf, label = ds.video_meta(i)
        w.add_video_raw(f"v{i}", label, ds.read_frames(i, range(min(nf, 24))))
    w.close()
    argv = _pretrain_argv(tmp_path, "--n_epochs", "1")
    argv[argv.index("synthetic")] = "packed"
    out = main_byol.main(argv + ["--lmdb_path", str(tmp_path / "train.cstp")],
                         device="cpu")
    assert out["timing"][0]["steps"] == 2
    assert np.isfinite(out["history"][0]["loss"])


def _ft_cfg(tmp_path, task, **kw):
    return Config(**_kw(tmp_path, task=task, batch_size=4, synthetic_len=8,
                        learning_rate=0.02, lr_patience=0, pb_rate=2,
                        **kw)).finalize()


def test_finetune_keeps_one_best_and_resumes(tmp_path):
    full = loops.run_finetune(_ft_cfg(tmp_path / "full", "scratch",
                                      n_epochs=3, steps_per_epoch=1),
                              device="cpu")
    part = loops.run_finetune(_ft_cfg(tmp_path / "part", "scratch",
                                      n_epochs=2, steps_per_epoch=1),
                              device="cpu")
    log_dir = tmp_path / "part" / "UCF101" / "scratch"
    kept = [d for d in os.listdir(log_dir) if d.endswith("_max")]
    assert kept == [os.path.basename(part["best"]["path"])]
    assert re.fullmatch(r"save_\d_max", kept[0])
    assert part["history"] == full["history"][:2]
    resumed = loops.run_finetune(
        _ft_cfg(tmp_path / "part", "resume", n_epochs=3, steps_per_epoch=1,
                resume_md_path=part["best"]["path"]), device="cpu")
    start = part["best"]["epoch"] + 1
    assert [h["epoch"] for h in resumed["history"]] == list(range(start, 4))
    # the plateau's state came back with the checkpoint: the learning rate
    # goes on as in the uninterrupted run
    assert ([h["lr"] for h in resumed["history"]]
            == [h["lr"] for h in full["history"][start - 1:]])
    assert resumed["best"]["acc"] >= part["best"]["acc"]
    assert [r[0] for r in _rows(log_dir, "val_")[1:]] == (
        ["1", "2"] + [str(e) for e in range(start, 4)])
    assert len([d for d in os.listdir(log_dir) if d.endswith("_max")]) == 1


def test_finetune_resume_needs_its_path(tmp_path):
    with pytest.raises(ValueError, match="resume_md_path"):
        loops.run_finetune(_ft_cfg(tmp_path, "resume", n_epochs=1),
                           device="cpu")


def test_ft_fc_leaves_the_backbone_as_it_was(tmp_path):
    out = main_byol.main(_pretrain_argv(
        tmp_path, "--n_epochs", "1", "--ckpt_every_epochs", "1",
        "--steps_per_epoch", "1"), device="cpu")
    save_1 = tmp_path / "UCF101" / "loss_com" / "save_1"
    cfg = _ft_cfg(tmp_path, "ft_fc", n_epochs=1, steps_per_epoch=2,
                  pretrained_path=str(save_1), model_name="r21d_byol")
    ft = loops.run_finetune(cfg, device="cpu")
    pre = dict(out["model"].named_parameters())
    # cls_bn is not in the pretrain model: it keeps the finetune init
    init, _, _ = create_finetune_state(cfg, N_CLASSES, seed=cfg.manual_seed,
                                       device="cpu")
    pre.update((n, p) for n, p in init.named_parameters()
               if n.startswith("cls_bn."))
    moved = []
    for n, p in ft["model"].named_parameters():
        if n.startswith(("online_net.", "cls_bn.")):
            assert torch.equal(p, pre[n]), n
        elif not torch.equal(p, dict(init.named_parameters())[n]):
            moved.append(n)
    assert moved and all(n.startswith("classify.") for n in moved)


def test_a_reference_pth_file_is_refused(tmp_path):
    """A reference .pth whose arch tag names another model is refused (the
    JAX package's check); one of this model loads."""
    from cstp_tpu_torch.models import torch_import
    from cstp_tpu_torch.models.bridge import export_state_dict

    model, _, _ = create_pretrain_state(
        Config(**_kw(tmp_path, task="loss_com")).finalize(), device="cpu")
    f = str(tmp_path / "save_5.pth")
    torch_import.save_torch_checkpoint(
        f, export_state_dict(model.state_dict()), "r21d", epoch=5)
    ft = loops.run_finetune(_ft_cfg(tmp_path, "ft_all", n_epochs=0,
                                    pretrained_path=f), device="cpu")
    assert torch.equal(ft["model"].online_net.conv1.bn.var,
                       model.online_net.conv1.bn.var)
    blob = torch.load(f, weights_only=True)
    blob["arch"] = "c3d_byol"
    torch.save(blob, f)
    with pytest.raises(ValueError, match="arch"):
        loops.run_finetune(_ft_cfg(tmp_path, "ft_all", n_epochs=1,
                                   pretrained_path=f), device="cpu")


def test_each_cli_prints_its_line(tmp_path, capsys):
    main_byol.main(_pretrain_argv(
        tmp_path, "--n_epochs", "2", "--ckpt_every_epochs", "2",
        "--steps_per_epoch", "1"), device="cpu")
    save_2 = str(tmp_path / "UCF101" / "loss_com" / "save_2")
    common = _pretrain_argv(tmp_path, "--n_finetune_classes", str(N_CLASSES),
                            "--pb_rate", "2")
    main_ft.main(common + ["--task", "ft_all", "--pretrained_path", save_2,
                           "--n_epochs", "1"], device="cpu")
    assert re.search(r"^Best val acc: [\d.]+ at epoch 1$",
                     capsys.readouterr().out, re.M)
    main_test.main(common + ["--task", "test", "--t_ft_task", "ft_all"],
                   device="cpu")
    assert re.search(r"^Video accuracy =  [\d.]+$", capsys.readouterr().out,
                     re.M)
    main_retrieval.main(common + ["--task", "retrieval", "--pretrained_path",
                                  save_2, "--retrieval_clips", "2"],
                        device="cpu")
    printed = capsys.readouterr().out
    recalls = [float(re.search(rf"^R@{k} = ([\d.]+)$", printed, re.M)[1])
               for k in (1, 5, 10, 20, 50)]
    assert recalls == sorted(recalls)
    assert re.search(r"^report: .*retrieval_r21d_byol1_UCF101_1_4\.txt$",
                     printed, re.M)
    with pytest.raises(SystemExit, match="pretrain tasks"):
        main_byol.main(common + ["--task", "test"], device="cpu")


def test_config_dump_is_the_config(tmp_path):
    cfg = _ft_cfg(tmp_path, "scratch", n_epochs=1)
    d = loops._log_dir(cfg)
    import json

    dumped = json.load(open(os.path.join(d, "config.json")))
    assert dumped == json.loads(json.dumps(dataclasses.asdict(cfg),
                                           default=str))
    alias = loops.resolve_dataset_alias(dataclasses.replace(
        cfg, dataset="Kin400RepreLMDB"))
    assert (alias.data_backend, alias.dataset) == ("lmdb", "Kin400")


def test_run_test_is_the_jax_run_test(weights):
    root = weights["root"]
    jout = jloops.run_test(JConfig(**_kw(root / "jax", task="test",
                                         t_ft_task="ft_all")).finalize())
    pout = loops.run_test(Config(**_kw(root / "port", task="test",
                                       t_ft_task="ft_all")).finalize(),
                          device="cpu")
    assert pout["n_videos"] == jout["n_videos"] == 4
    assert pout["accuracy"] == jout["accuracy"]
    assert _report_lines(pout["report"]) == _report_lines(jout["report"])
    assert "Video accuracy = " in open(pout["report"]).read()
    assert os.path.basename(pout["report"]) == os.path.basename(
        jout["report"])


def test_run_retrieval_is_the_jax_run_retrieval(weights, monkeypatch):
    root = weights["root"]
    kw = dict(task="retrieval", t_ft_task="ft_all", retrieval_clips=2)
    seen = {}

    def capture(mod, name):
        recalls = mod.retrieval_recalls

        def wrapped(q, ql, g, gl, *a, **k):
            seen[name] = (q, ql, g, gl)
            return recalls(q, ql, g, gl, *a, **k)
        monkeypatch.setattr(mod, "retrieval_recalls", wrapped)

    capture(jloops, "jax")
    capture(loops, "port")
    jout = jloops.run_retrieval(JConfig(**_kw(root / "jax", **kw)).finalize())
    pout = loops.run_retrieval(Config(**_kw(root / "port", **kw)).finalize(),
                               device="cpu")
    for k in ("R@1", "R@5", "R@10", "R@20", "R@50"):
        assert pout[k] == jout[k], k
    assert (pout["n_gallery"], pout["n_queries"]) == (4, 4)
    assert _report_lines(pout["report"]) == _report_lines(jout["report"])
    # the per-video descriptors behind the recalls
    for got, want in zip(seen["port"], seen["jax"]):
        if want.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    # and they are not all one vector: the ranking is not a tie
    q = seen["port"][0]
    assert (q @ q.T)[~np.eye(len(q), dtype=bool)].max() < 0.999
