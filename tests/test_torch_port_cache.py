"""The machine scope of the port's built libraries
(``cstp_tpu_torch/utils/cache.py``, ``ops/build.py``), on the CPU: the
directory's name changes with each thing it hashes, and every library path
lies under it, so a ``build/`` folder from another machine or toolchain is
never loaded."""

import os
from pathlib import Path

import pytest
import torch

from cstp_tpu.utils import cache as jax_cache
from cstp_tpu_torch.ops import build
from cstp_tpu_torch.utils import cache

from _torch_threads import torch_threads  # noqa: F401


def test_cpu_fingerprint_is_the_jax_package_s():
    assert cache._cpu_fingerprint() == jax_cache._cpu_fingerprint()


@pytest.mark.parametrize("change", ["cpu", "torch", "cuda", "nvcc", "g++"])
def test_the_directory_follows_each_input(change, monkeypatch, tmp_path):
    """Each hashed input, changed alone, moves the directory; unchanged, it
    stays."""
    base = tmp_path / "build"
    before = cache.machine_scoped_cache_dir(base)
    assert cache.machine_scoped_cache_dir(base) == before
    assert os.path.dirname(before) == str(base)
    if change == "cpu":
        monkeypatch.setattr(cache, "_cpu_fingerprint",
                            lambda: "another host")
    elif change == "torch":
        monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    elif change == "cuda":
        monkeypatch.setattr(torch.version, "cuda", "99.9")
    elif change == "nvcc":      # another nvcc, or one where there was none
        real = cache.tool_version
        monkeypatch.setattr(cache, "find_nvcc", lambda: "other/bin/nvcc")
        monkeypatch.setattr(cache, "tool_version", lambda path: (
            "Cuda compilation tools, release 99.9" if path == "other/bin/nvcc"
            else real(path)))
    else:
        real = cache.tool_version
        gxx = build.gxx_path()
        monkeypatch.setattr(cache, "tool_version", lambda path: (
            real(path) + " (another build)" if path == gxx else real(path)))
    assert cache.machine_scoped_cache_dir(base) != before


def test_tool_version_of_a_missing_tool_is_empty(tmp_path):
    assert cache.tool_version(None) == ""
    assert cache.tool_version(str(tmp_path / "no-such-tool")) == ""
    gxx = build.gxx_path()
    assert cache.tool_version(gxx).splitlines()[0].startswith(
        ("g++", "c++", "gcc"))


def test_library_paths_lie_under_the_machine_scope(monkeypatch):
    """``build.py``'s kernel and host library paths are in
    ``build/cstp_tpu_torch/<fingerprint>/``; another fingerprint gives
    other paths for the same sources."""
    scope = build.build_dir()
    assert scope.parent == build.BUILD_ROOT
    assert build.BUILD_ROOT.parts[-2:] == ("build", "cstp_tpu_torch")
    assert Path(cache.machine_scoped_cache_dir(build.BUILD_ROOT)) == scope
    paths = [build._lib_path(n) for n in build.SOURCES]
    paths += [build._host_lib_path(n, jpeg) for n in build.HOST_SOURCES
              for jpeg in (True, False)]
    assert all(p.parent == scope for p in paths)
    monkeypatch.setattr(build, "BUILD_DIR", None)
    monkeypatch.setattr(cache, "_cpu_fingerprint", lambda: "another host")
    moved = build.build_dir()
    assert moved != scope and moved.parent == build.BUILD_ROOT
    assert build._lib_path("conv21d").name == paths[0].name
    assert build._lib_path("conv21d").parent == moved
