"""The port's conv-block benchmark entry (``cstp_tpu_torch.perf.
bench_conv21d``) on the CPU at a tiny size: it runs all four variants for
either tiling and returns their times; without ``--device`` it wants the
card and raises on a host without one. Its kernels and times on the card are
exercised by ``chip_smoke.py``."""

import pytest
import torch

from cstp_tpu_torch.perf import bench_conv21d as bench

from _torch_threads import torch_threads  # noqa: F401

_TINY = ["--b", "4", "--t", "4", "--hw", "8", "--cin", "32", "--mid", "16",
         "--cout", "16", "--iters", "1"]


@pytest.mark.parametrize("tiling", ["clip", "taps9"])
def test_entry_times_all_four_variants(tiling):
    res = bench.main(["--device", "cpu", *_TINY, "--tiling", tiling])
    assert res["tiling"] == tiling and res["device"] == "cpu"
    for name in bench.VARIANTS:
        assert isinstance(res[name], float) and res[name] > 0, name
        # CPU tensors take the plain version: no kernel is launched
        assert not any(res["launches"][name].values()), name


@pytest.mark.parametrize("mode, names", [("fwd", ("plain_fwd", "fused_fwd")),
                                         ("grad", ("plain_grad",
                                                   "fused_grad"))])
def test_entry_mode_picks_the_variants(mode, names):
    res = bench.main(["--device", "cpu", *_TINY, "--mode", mode])
    assert [v for v in bench.VARIANTS if v in res] == list(names)


def test_entry_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(_TINY)


def test_entry_inputs_are_seeded():
    a = bench.make_inputs(2, 2, 4, 32, 16, 16, torch.device("cpu"))
    b = bench.make_inputs(2, 2, 4, 32, 16, 16, torch.device("cpu"))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert a[0].shape == (2, 2, 4, 4, 32) and a[1].shape == (3, 3, 32, 16)
    assert a[2].shape == (3, 16, 16) and a[3].shape == a[4].shape == (16,)
