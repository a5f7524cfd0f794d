"""The port's kernel build (``cstp_tpu_torch/ops/build.py``) on the CPU: no
``nvcc`` is needed to name a library."""

import shutil

from cstp_tpu_torch.ops import build

from _torch_threads import torch_threads  # noqa: F401


def test_library_path_follows_shared_headers(tmp_path, monkeypatch):
    """Editing a shared header (``csrc/*.cuh``) renames every library, so the
    next use rebuilds; an unchanged tree keeps its name."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc has no shared header"
    before = {n: build._lib_path(n) for n in build.SOURCES}
    assert {n: build._lib_path(n) for n in build.SOURCES} == before
    headers[0].write_bytes(headers[0].read_bytes() + b"\n// edited\n")
    after = {n: build._lib_path(n) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)


def test_library_path_follows_its_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build._lib_path(n) for n in build.SOURCES}
    src = csrc / "conv21d.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    after = {n: build._lib_path(n) for n in build.SOURCES}
    assert after["conv21d"] != before["conv21d"]
    assert after["augment"] == before["augment"]
