"""The port's serving layer (``cstp_tpu_torch/serve``): the exported eval
program (``torch.export``), its runtime and the int8 calibration, on the
CPU; the ports of ``tests/test_serve.py``'s checks, held against the live
logits path and against the JAX package's live eval logits and calibrated
scales for the same weights and inputs.

Tolerances:
- the artifact against the port's live ``make_logits_step``: rtol/atol
  2e-5 (the same ops traced; ``tests/test_serve.py``'s tolerance), int8
  included (the same quantize and int8 conv);
- the artifact against JAX's live ``make_logits_step`` (float32, bridged
  weights): rtol 1e-4, atol 1e-5, as the eval steps' parity tests
  (resampling and convolution sums in other orders);
- the calibrated scales against JAX's ``calibrate_checkpoint``: rtol 1e-5
  (maxima of float32 activations).
"""

import dataclasses
import json
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.config import Config as JaxConfig
from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models.bridge import export_jax_variables
from cstp_tpu_torch.ops.quant import iter_scales
from cstp_tpu_torch.perf import bench_step
from cstp_tpu_torch.serve import (
    ServingModel,
    export_serving_artifact,
    save_serving_artifact,
)
from cstp_tpu_torch.serve.export import main as export_main
from cstp_tpu_torch.serve.quantize import calibrate_checkpoint
from cstp_tpu_torch.serve.quantize import main as quantize_main
from cstp_tpu_torch.train.finetune import (
    create_finetune_state,
    make_logits_step,
    sliding_window_indices,
)
from cstp_tpu_torch.train.pretrain import TrainState

from _torch_threads import torch_threads  # noqa: F401

T, S, HW = 4, 32, (40, 52)
NUM_CLASSES = 7
_KW = dict(model_name="r21d", model_depth=1, sample_duration=T,
           sample_size=S, compute_dtype="float32", n_classes=NUM_CLASSES,
           n_finetune_classes=NUM_CLASSES, data_backend="synthetic",
           synthetic_len=8, task="test")


@pytest.fixture
def tmp_path(tmp_path):
    """The test's own directory, removed when the test ends."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tiny_cfg():
    return Config(**_KW).finalize()


@pytest.fixture(scope="module")
def tiny_state(tiny_cfg):
    return create_finetune_state(tiny_cfg, NUM_CLASSES, seed=3, device="cpu")


@pytest.fixture(scope="module")
def artifact(tiny_state):
    model, _, _ = tiny_state
    return export_serving_artifact(
        model, num_classes=NUM_CLASSES, sample_size=S, sample_duration=T,
        input_hw=HW)


@pytest.fixture(scope="module")
def served(artifact):
    return ServingModel.load(artifact, device="cpu")


def _windows(n, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(n, T, *HW, 3), dtype=np.uint8)


def _live(model, cfg, state, w):
    return make_logits_step(model, cfg)(state, torch.from_numpy(w)).numpy()


def test_artifact_matches_live_logits_path(tiny_cfg, tiny_state, served):
    """The exported program is the test path: the same logits as
    ``make_logits_step`` (the engine ``run_test`` uses)."""
    model, state, _ = tiny_state
    w = _windows(5)
    np.testing.assert_allclose(served.predict(w),
                               _live(model, tiny_cfg, state, w),
                               rtol=2e-5, atol=2e-5)


def test_artifact_is_batch_polymorphic(served):
    for n in (1, 3, 8):
        assert served.predict(_windows(n)).shape == (n, NUM_CLASSES)


def test_artifact_is_a_zip_with_its_meta(artifact, tmp_path):
    p = tmp_path / "m.cstps"
    save_serving_artifact(str(p), artifact)
    with zipfile.ZipFile(p) as z:
        meta = json.loads(z.read("meta.json"))
        assert sorted(z.namelist()) == ["forward.pt2", "meta.json"]
    assert meta["model_name"] == "r21d" and meta["model_depth"] == 1
    assert meta["num_classes"] == NUM_CLASSES
    assert meta["input_hw"] == list(HW)
    assert meta["device"] == "cpu" and meta["quant"] == ""
    assert meta["requires"] == ["torch"]
    served = ServingModel.load(str(p), device="cpu")
    assert served.meta["sample_duration"] == T


def test_predict_validates_geometry(served):
    with pytest.raises(ValueError, match="expected"):
        served.predict(np.zeros((2, T, 41, 52, 3), np.uint8))


def test_predict_video_mean_logit_topk(served):
    """predict_video == sliding windows -> mean logits -> argsort top-k
    (reference test.py:78-95)."""
    nframes = 3 * T + 1  # several windows and a tail window
    rng = np.random.RandomState(1)
    video = rng.randint(0, 256, size=(nframes, *HW, 3), dtype=np.uint8)
    out = served.predict_video(video, pb_rate=1, topk=3)
    idx = sliding_window_indices(nframes, T, 1)
    mean = served.predict(video[idx]).mean(axis=0)
    np.testing.assert_allclose(out["mean_logits"], mean, rtol=1e-6)
    assert out["top1"] == int(np.argmax(mean))
    assert out["n_windows"] == idx.shape[0]
    assert list(out["topk"]) == list(np.argsort(-mean)[:3])


def _jax_init_returns(cls, params, batch_stats):
    """``cls.init`` returns these variables, so JAX's state factories run on
    the port's weights (JAX's own init costs tens of seconds here)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(cls, "init", lambda self, *a, **k: {
        "params": params, "batch_stats": batch_stats})
    return mp


def test_artifact_matches_jax_live_eval_logits(tiny_state, served):
    """The port's artifact against the JAX package's live logits step for
    the same weights and windows."""
    from cstp_tpu.ssl.byol import CSTPClassify as JaxClassify
    from cstp_tpu.train.finetune import (
        create_finetune_state as jax_create_state,
        make_logits_step as jax_logits_step,
    )

    model, _, _ = tiny_state
    params, stats = jax.tree_util.tree_map(np.copy,
                                           export_jax_variables(model))
    jcfg = JaxConfig(**_KW).finalize()
    mp = _jax_init_returns(JaxClassify, params, stats)
    try:
        jmodel, jstate, _ = jax_create_state(jcfg, jax.random.PRNGKey(0),
                                             NUM_CLASSES)
    finally:
        mp.undo()
    w = _windows(4, seed=7)
    want = np.asarray(jax_logits_step(jmodel, jcfg)(jstate, jnp.asarray(w)))
    np.testing.assert_allclose(served.predict(w), want, rtol=1e-4,
                               atol=1e-5)


def _save_float(tmp_path, cfg, state, name="save_3"):
    return ckpt_lib.save_checkpoint(str(tmp_path / name),
                                    ckpt_lib.state_tree(state),
                                    meta={"arch": cfg.arch, "epoch": 3})


def _export_argv(ckpt, out, *extra):
    return ["--ckpt", ckpt, "--out", out, "--model_name", "r21d",
            "--model_depth", "1", "--num_classes", str(NUM_CLASSES),
            "--sample_size", str(S), "--sample_duration", str(T),
            "--input_hw", str(HW[0]), str(HW[1]), "--compute_dtype",
            "float32", *extra]


def test_export_cli_from_checkpoint(tiny_cfg, tiny_state, tmp_path, capsys):
    """CLI round trip: a finetune checkpoint, exported by ``main``, loaded,
    gives the checkpointed model's logits."""
    model, state, _ = tiny_state
    ckpt = _save_float(tmp_path, tiny_cfg, state)
    out = str(tmp_path / "m.cstps")
    export_main(_export_argv(ckpt, out), device="cpu")
    assert "wrote" in capsys.readouterr().out
    served = ServingModel.load(out, device="cpu")
    assert served.meta["ckpt_epoch"] == 3 and served.meta["arch"] == "r21d-1"
    w = _windows(4, seed=2)
    np.testing.assert_allclose(served.predict(w),
                               _live(model, tiny_cfg, state, w),
                               rtol=2e-5, atol=2e-5)


def test_int8_static_artifact_from_the_cli_matches_live_logits(
        tiny_cfg, tiny_state, tmp_path, capsys):
    """Calibrate (``serve.quantize`` CLI) -> export ``--quant int8_static``
    (``serve.export`` CLI) -> the artifact's logits equal the live int8
    path's; exporting the float checkpoint as int8_static is refused."""
    from cstp_tpu_torch.train.finetune import create_classify_model

    _, state, _ = tiny_state
    ckpt = _save_float(tmp_path, tiny_cfg, state)
    calib = str(tmp_path / "save_3_int8")
    argv = ["--out_path", calib, "--test_md_path", ckpt,
            "--calib_batches", "2", "--calib_batch_size", "4"]
    argv += [x for k, v in _KW.items() for x in (f"--{k}", str(v))]
    assert quantize_main(argv, device="cpu") == 0
    said = capsys.readouterr().out.splitlines()
    assert said[0].startswith("calibrated 24 conv sites over 8 clips")
    assert said[1] == f"serve/test with: --quant int8_static --test_md_path " \
                      f"{calib}"
    out = str(tmp_path / "q.cstps")
    export_main(_export_argv(calib, out, "--quant", "int8_static"),
                device="cpu")
    served = ServingModel.load(out, device="cpu")
    assert served.meta["quant"] == "int8_static"
    assert "cstp::int8_conv3d" in " ".join(served.meta["requires"])
    qcfg = dataclasses.replace(tiny_cfg, quant="int8_static").finalize()
    model_q = create_classify_model(qcfg, NUM_CLASSES, device="cpu")
    tree, meta = ckpt_lib.restore_checkpoint(calib)
    assert meta["int8_calibration"] == {"batches": 2, "batch_size": 4,
                                        "data_type": "train"}
    ckpt_lib.load_model_by_name(model_q, tree)
    w = _windows(4, seed=1)
    live = _live(model_q, qcfg, TrainState(0, model_q, {}), w)
    got = served.predict(w)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, live, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="uncalibrated"):
        export_main(_export_argv(ckpt, str(tmp_path / "f.cstps"), "--quant",
                                 "int8_static"), device="cpu")


def test_calibrate_checkpoint_matches_jax(tiny_cfg, tiny_state, tmp_path):
    """The same float weights calibrated by each package's
    ``calibrate_checkpoint`` on the same synthetic videos: the same sites,
    scales within rtol 1e-5, the same clip count."""
    from cstp_tpu.ckpt import checkpoint as jax_ckpt
    from cstp_tpu.serve.quantize import (
        calibrate_checkpoint as jax_calibrate,
    )
    from cstp_tpu.ssl.byol import CSTPClassify as JaxClassify

    model, state, _ = tiny_state
    params, stats = jax.tree_util.tree_map(np.copy,
                                           export_jax_variables(model))
    ckpt = _save_float(tmp_path, tiny_cfg, state)
    jckpt = jax_ckpt.save_checkpoint(
        str(tmp_path / "jax_float"),
        {"params": params, "batch_stats": stats}, meta={})
    got = calibrate_checkpoint(tiny_cfg, ckpt, str(tmp_path / "q"),
                               n_batches=2, batch_size=4, device="cpu")
    # JAX's int8_calib init declares act_scale leaves the float tree lacks
    calib_stats = jax.tree_util.tree_map(np.copy, export_jax_variables(
        _port_calib_model(tiny_cfg))[1])
    mp = _jax_init_returns(JaxClassify, params, calib_stats)
    try:
        want = jax_calibrate(JaxConfig(**_KW).finalize(), jckpt,
                             str(tmp_path / "jax_q"), n_batches=2,
                             batch_size=4)
    finally:
        mp.undo()
    assert got["n_sites"] == want["n_sites"] == 24
    assert got["clips_seen"] == want["clips_seen"] == 8
    _, pstats = export_jax_variables(_loaded(got["tree"]["model"], tiny_cfg))
    p = dict(iter_scales(pstats))
    j = dict(iter_scales(jax.tree_util.tree_map(
        np.asarray, want["tree"]["batch_stats"])))
    assert p.keys() == j.keys()
    for k, v in j.items():
        np.testing.assert_allclose(p[k], v, rtol=1e-5, err_msg=k)


def _port_calib_model(cfg):
    from cstp_tpu_torch.train.finetune import create_classify_model

    return create_classify_model(
        dataclasses.replace(cfg, quant="int8_calib").finalize(), NUM_CLASSES,
        device="cpu")


def _loaded(sd, cfg):
    m = _port_calib_model(cfg)
    m.load_state_dict(sd)
    return m


def test_bench_step_serves_a_written_artifact(capsys, monkeypatch, tmp_path,
                                              artifact):
    """``bench_step --mode serve --artifact PATH`` times an artifact that
    ``serve/export.py`` wrote, with its own class count (no model built,
    no export: ``export_s`` None), and refuses one of another model, depth,
    ``--quant`` or shape than the benchmark's flags."""
    for name, value in (("T", T), ("S", S), ("H0", HW[0]), ("W0", HW[1])):
        monkeypatch.setattr(bench_step, name, value)
    path = tmp_path / "tiny.cstps"
    path.write_bytes(artifact)
    argv = ["--device", "cpu", "--per-chip-bs", "2", "--steps", "1",
            "--warmup", "1", "--mode", "serve", "--artifact", str(path)]
    res = bench_step.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["export_s"] is None and res["load_s"] > 0
    assert res["artifact_mb"] == path.stat().st_size / 1e6
    assert res["clips_per_s"] > 0 and np.isfinite(res["loss"])
    for other in (["--quant", "int8_static"], ["--model", "c3d"],
                  ["--depth", "18"]):
        with pytest.raises(ValueError, match="the benchmark"):
            bench_step.main(argv + other)
    with pytest.raises(SystemExit):
        bench_step.main(["--device", "cpu", "--mode", "eval", "--artifact",
                         str(path)])


@pytest.mark.parametrize("mode", ["serve", "eval"])
def test_bench_step_int8_static_modes(capsys, monkeypatch, mode):
    """``bench_step --quant int8_static`` in eval and serve mode on the CPU:
    every act_scale filled, no kernel launched (CPU tensors take the plain
    versions), one JSON line."""
    monkeypatch.setattr(bench_step, "T", T)
    monkeypatch.setattr(bench_step, "S", S)
    res = bench_step.main(["--device", "cpu", "--per-chip-bs", "2",
                           "--steps", "1", "--warmup", "1", "--mode", mode,
                           "--quant", "int8_static"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["mode"] == mode and res["quant"] == "int8_static"
    assert res["act_scales"] == 24 and res["clips_per_s"] > 0
    assert res["launches_per_step"]["int8_conv"] == 0
    assert np.isfinite(res["loss"])
    if mode == "serve":
        assert res["artifact_mb"] > 0 and res["export_s"] > 0
    with pytest.raises(SystemExit):
        bench_step.main(["--device", "cpu", "--mode", "ft", "--quant",
                         "int8_static"])
