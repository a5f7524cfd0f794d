"""The port's step benchmark entry (``cstp_tpu_torch.perf.bench_step``) on
the CPU at a tiny size: each mode runs its steps and prints one JSON line
with the step time, the rate, the launches per step and the device; without
``--device`` it wants the card. Its times on the card come from
``chip_smoke.py``."""

import json

import pytest

from cstp_tpu_torch.perf import bench_step

_TINY = ["--device", "cpu", "--per-chip-bs", "4", "--steps", "1",
         "--warmup", "1"]


@pytest.mark.parametrize("mode, extra", [
    ("pretrain", []), ("pretrain", ["--grad-accum", "2", "--fused-conv", "1"]),
    ("pretrain", ["--remat", "--concat-views", "0"]),
    ("pretrain", ["--remat-policy", "bnrelu", "--fused-conv", "1"]),
    ("ft", ["--fused-conv", "1"]), ("eval", [])])
def test_entry_runs_each_mode(capsys, monkeypatch, mode, extra):
    monkeypatch.setattr(bench_step, "T", 4)     # clips of 4 x 32^2
    monkeypatch.setattr(bench_step, "S", 32)
    res = bench_step.main([*_TINY, "--mode", mode, *extra])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == res
    rate = "pairs_per_s" if mode == "pretrain" else "clips_per_s"
    assert res["mode"] == mode and res["device"] == "cpu"
    assert res["step_ms"] > 0 and res[rate] > 0
    assert res["peak_mem_gib"] is None
    assert res["clip"] == [4, 32, 32] and res["frames"] == [128, 171]
    # CPU tensors take the plain versions: no kernel is launched
    assert not any(res["launches_per_step"].values())
    assert res["loss"] == res["loss"]        # finite, not NaN
    assert res["remat"] == ("--remat" in extra)
    assert res["remat_policy"] == ("bnrelu" if "bnrelu" in extra else "")
    assert res["concat_views"] == (0 if "--concat-views" in extra else 1)


@pytest.mark.parametrize("mode", ["pretrain", "ft", "eval"])
@pytest.mark.parametrize("model, depth", [("c3d", "1"), ("r3d", "18"),
                                          ("s3d", "1"), ("i3d", "1"),
                                          ("slowfast", "18"),
                                          ("slowfast", "50")])
def test_entry_runs_each_family(capsys, monkeypatch, model, depth, mode):
    """``--model`` builds the family (8 frames: C3D pools time three
    times, and SlowFast's ``alpha`` 4 divides them) and is reported in the
    JSON line; no kernel but K5 is on these families' path, and the CPU
    launches none."""
    monkeypatch.setattr(bench_step, "T", 8)
    monkeypatch.setattr(bench_step, "S", 32)
    res = bench_step.main([*_TINY, "--mode", mode, "--model", model,
                           "--depth", depth, "--pallas-augment", "on"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert res["model"] == model and res["depth"] == int(depth)
    assert res["clip"] == [8, 32, 32] and res["loss"] == res["loss"]
    assert not any(res["launches_per_step"].values())


def test_entry_refuses_an_unknown_family():
    with pytest.raises(ValueError, match="unknown backbone 'slowfast_xl'"):
        bench_step.main([*_TINY, "--model", "slowfast_xl"])
