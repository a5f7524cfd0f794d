"""Builds the port's CUDA kernels with ``nvcc`` at first use and loads them.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ``ctypes``. Libraries go to ``build/cstp_tpu_torch/`` beside the
package, named by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header rebuilds and an unchanged one
is reused. ``build_all`` starts one ``nvcc``
per source at once. A missing ``nvcc`` or a failed build raises: there is
no fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cstp_tpu_torch"
SOURCES = ("conv21d", "augment")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("cstp_tpu_torch: nvcc not found (PATH, $CUDA_HOME, "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of the source, of every shared
    header in ``csrc`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> subprocess.Popen:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out = tmp, out  # type: ignore[attr-defined]
    return proc


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library, all ``nvcc``
    processes at once. Returns ``{name: compiler output}`` for the sources
    built now (ptxas register/shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: _start(n) for n in names if not _lib_path(n).exists()}
    logs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{n}.cu:\n{log}")
        os.replace(p.tmp, p.out)
        logs[n] = log
    return logs


def load(name: str, signatures: Dict[str, Tuple[list, Any]]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    ``argtypes``/``restype`` set from ``signatures`` ({function: (argtypes,
    restype)}; pointers and the stream as ``c_void_p``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
