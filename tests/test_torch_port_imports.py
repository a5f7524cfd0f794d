"""The port stands alone: ``cstp_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``cstp_tpu``, nor TensorFlow or
protobuf (the card machine has neither: the kinetics-i3d checkpoint reader
is numpy alone), and no entry point (steps, loops, CLIs) moves to the CPU
unless asked.

The import check runs in a subprocess, because this test session has
imported JAX already (tests/conftest.py).
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
import cstp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cstp_tpu_torch.__path__,
                                               "cstp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "flax", "cstp_tpu", "tensorflow",
                      "google.protobuf")
             or m.startswith(("jax.", "jaxlib.", "flax.", "cstp_tpu.",
                              "tensorflow.", "google.protobuf.")))
print(len(names), bad)
"""


def _is_jax_or_package(name: str) -> bool:
    top = name.split(".")[0]
    return (top in ("jax", "jaxlib", "flax", "optax", "cstp_tpu",
                    "tensorflow")
            or name == "google.protobuf" or name.startswith("google.protobuf."))


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 48, out.stdout
    assert bad == "[]", bad


def _static_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", ["chip_smoke.py", "cstp_tpu_torch",
                                  "cstp_tpu_torch/perf"])
def test_static_imports_stay_out_of_jax(path):
    files = ([ROOT / path] if path.endswith(".py")
             else sorted((ROOT / path).rglob("*.py")))
    for f in files:
        bad = [m for m in _static_imports(f) if _is_jax_or_package(m)]
        assert not bad, (f, bad)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card the smoke run exits non-zero and prints no result;
    so does a copy of the script alone, outside the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_entry_points_refuse_missing_cuda():
    """CUDA is the default device; without it an entry point raises rather
    than running on the CPU. ``device="cpu"`` is honoured."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    import numpy as np

    from cstp_tpu_torch import resolve_device
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.perf import bench_conv21d, bench_step
    from cstp_tpu_torch.train import finetune
    from cstp_tpu_torch.train.pretrain import create_pretrain_state

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    cfg = Config(model_name="r21d", sample_duration=4, sample_size=32,
                 batch_size=2).finalize()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_pretrain_state(cfg)
    ft_cfg = Config(model_name="r21d", sample_duration=4, sample_size=32,
                    batch_size=2, task="ft_all").finalize()
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.create_finetune_state(ft_cfg, 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.create_classify_model(ft_cfg, 5)
    feats = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        finetune.retrieval_recalls(feats, np.arange(4), feats, np.arange(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_conv21d.main(["--b", "2", "--t", "2", "--hw", "4"])
    for mode in ("pretrain", "ft", "eval"):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_step.main(["--mode", mode, "--per-chip-bs", "2"])
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("entry", ["run_pretrain", "run_finetune",
                                   "run_test", "run_retrieval", "main_byol",
                                   "main_ft", "main_test", "main_retrieval"])
def test_loops_and_clis_refuse_missing_cuda(entry, tmp_path):
    """The loops and the CLIs run on CUDA unless ``device="cpu"`` is
    passed: without a card they raise before reading any data."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    import importlib

    from cstp_tpu_torch.config import parse_opts
    from cstp_tpu_torch.train import loops

    task = {"run_pretrain": "loss_com", "run_finetune": "ft_all",
            "run_test": "test", "run_retrieval": "retrieval",
            "main_byol": "loss_com", "main_ft": "ft_all",
            "main_test": "test", "main_retrieval": "retrieval"}[entry]
    argv = ["--model_name", "r21d_byol", "--sample_duration", "4",
            "--sample_size", "32", "--batch_size", "2", "--task", task,
            "--data_backend", "synthetic", "--result_path", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry.startswith("run_"):
            getattr(loops, entry)(parse_opts(argv))
        else:
            importlib.import_module(f"cstp_tpu_torch.cli.{entry}").main(argv)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("flag", [
    dict(model_name="s3d", s2d_stem=True), dict(s2d_stem=True),
    dict(t_fold=1), dict(quant="int8"), dict(mid_round=128),
    dict(ntxent_weight=0.5), dict(shard_opt_state=1),
])
def test_config_refuses_unported_flags(flag):
    from cstp_tpu_torch.config import Config

    with pytest.raises(NotImplementedError):
        Config(**flag).finalize()


@pytest.mark.parametrize("flag", [
    dict(legacy_pace=1), dict(model_name="slowfast"),
    dict(model_name="slowfast_fb"),
])
def test_config_takes_slowfast_and_legacy_pace(flag):
    """The SlowFast names and ``--legacy_pace`` (refused until they were
    ported) build a config and a finetune model: SlowFast's, or bare
    ``r21d``'s 'pace_project' head."""
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.train.finetune import create_classify_model

    kw = dict(model_name="r21d", sample_duration=4, sample_size=32)
    kw.update(flag)
    cfg = Config(**kw).finalize()
    model = create_classify_model(cfg, 5, device="cpu")
    assert model.head_style == ("pace_project" if cfg.legacy_pace
                                else "linear")
    assert type(model.online_net).__name__ == (
        "R2Plus1DNet" if cfg.legacy_pace else "SlowFastNet")


@pytest.mark.parametrize("name", ["slowfast_xl", "r22d_byol", "legacy"])
def test_config_refuses_an_unknown_model_name(name):
    """An unknown family raises ``ValueError``, as the JAX package's
    ``make_backbone`` does."""
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.models import backbone_spec, make_backbone

    for build in (lambda: Config(model_name=name).finalize(),
                  lambda: make_backbone(name), lambda: backbone_spec(name)):
        with pytest.raises(ValueError, match="unknown backbone"):
            build()


@pytest.mark.parametrize("flag", [
    dict(concat_views=0), dict(remat=True), dict(remat_policy="bnrelu"),
    dict(optimizer="adam"), dict(optimizer="adamw"), dict(dampening=0.1),
    dict(nesterov=True), dict(double_bias_lr=True),
])
def test_config_takes_the_ported_step_flags(flag):
    """Each ported step flag builds a config and reaches the pretrain model
    and its optimizer."""
    from cstp_tpu_torch.config import Config
    from cstp_tpu_torch.train.pretrain import create_pretrain_state

    cfg = Config(model_name="r21d", sample_duration=4, sample_size=32,
                 batch_size=2, **flag).finalize()
    for k, v in flag.items():
        assert getattr(cfg, k) == v
    model, state, tx = create_pretrain_state(cfg, device="cpu")
    assert model.concat_views == bool(cfg.concat_views)
    want = "full" if cfg.remat else cfg.remat_policy
    assert model.online_net.remat == model.target_net.remat == want
    assert set(state.opt_state) == (
        {"mu", "nu", "count"} if cfg.optimizer != "sgd"
        else {"trace", "count"} if cfg.dampening else {"trace"})


@pytest.mark.parametrize("flag", [
    dict(model_name="s3d"), dict(model_name="s3d_byol"),
    dict(model_name="s3d_classify"), dict(model_name="i3d_byol"),
    dict(model_name="i3d_classify"),
    dict(model_name="i3d_byol", i3d_conv_head=1),
    dict(model_name="i3d_byol", tf_i3d_ckpt="i3d.ckpt"),
])
def test_config_takes_the_inception_families(flag):
    """The S3D-G and I3D families, ``--i3d_conv_head`` and
    ``--tf_i3d_ckpt`` (refused until they were ported) build a config."""
    from cstp_tpu_torch.config import Config

    cfg = Config(**flag).finalize()
    for k, v in flag.items():
        assert getattr(cfg, k) == v


@pytest.mark.parametrize("flag, error", [
    (dict(optimizer="lamb"), AssertionError),
    (dict(remat_policy="dots"), ValueError),
])
def test_config_rejects_bad_optimizer_and_remat_policy(flag, error):
    from cstp_tpu_torch.config import Config

    with pytest.raises(error):
        Config(**flag).finalize()
