"""Builds the port's CUDA kernels with ``nvcc`` at first use and loads them;
likewise its host library, the CSTPack reader, with ``g++``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ``ctypes``. Libraries go to ``build/cstp_tpu_torch/<fingerprint>/``
beside the package (:func:`build_dir`; ``utils/cache.py
machine_scoped_cache_dir``: the host CPU, PyTorch and its CUDA, ``nvcc``
and ``g++``), so a ``build/`` folder from another machine or toolchain is
never loaded, and are named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one is reused. ``build_all`` starts one ``nvcc``
per source at once. A missing ``nvcc`` or a failed build raises: there is
no fallback for a CUDA tensor.

``csrc/<name>.cc`` (``HOST_SOURCES``) is host code: ``build_host`` compiles
it with ``g++`` (``HOST_FLAGS``, ``HOST_LIBS``), needs no ``nvcc``, and
raises with the compiler's output when the build fails. It links libjpeg
where ``g++`` finds ``jpeglib.h`` (``has_jpeglib``); elsewhere it compiles
the JPEG decode out (``-DCSTP_NO_JPEG``) and the library says so through
``cstp_has_jpeg()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

from cstp_tpu_torch.utils.cache import find_nvcc, machine_scoped_cache_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "cstp_tpu_torch"
# the machine-scoped directory under BUILD_ROOT, found at the first build
# or load (it asks nvcc and g++ for their versions)
BUILD_DIR: Optional[Path] = None
SOURCES = ("conv21d", "augment", "int8_conv", "int8_store")
HOST_SOURCES = ("cstpack_reader",)
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
HOST_LIBS = ("-lpthread",)
JPEG_LIBS = ("-ljpeg",)
NO_JPEG_FLAGS = ("-DCSTP_NO_JPEG",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/cstp_tpu_torch/<fingerprint>/``, where this machine's
    libraries go (``BUILD_DIR`` once found)."""
    global BUILD_DIR
    if BUILD_DIR is None:
        BUILD_DIR = Path(machine_scoped_cache_dir(BUILD_ROOT))
    return BUILD_DIR


def nvcc_path() -> str:
    found = find_nvcc()
    if found:
        return found
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
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("cstp_tpu_torch: g++ not found on PATH; the host "
                           "library (csrc/*.cc) cannot be built")
    return found


@functools.lru_cache(maxsize=None)
def has_jpeglib() -> bool:
    """Whether ``g++`` finds libjpeg's header, ``jpeglib.h``."""
    proc = subprocess.run([gxx_path(), "-fsyntax-only", "-x", "c++", "-"],
                          input="#include <cstdio>\n#include <jpeglib.h>\n",
                          capture_output=True, text=True)
    return proc.returncode == 0


def host_command(name: str, out: Path, jpeg: bool) -> list:
    """The ``g++`` command that builds ``csrc/<name>.cc`` into ``out``, with
    libjpeg or with the JPEG decode compiled out."""
    return [gxx_path(), *HOST_FLAGS, *(() if jpeg else NO_JPEG_FLAGS),
            "-o", str(out), str(CSRC / f"{name}.cc"),
            *(JPEG_LIBS if jpeg else ()), *HOST_LIBS]


def _host_lib_path(name: str, jpeg: bool) -> Path:
    """The host library's path, named by a hash of its source and of its
    command's flags."""
    h = hashlib.sha256((CSRC / f"{name}.cc").read_bytes())
    h.update(" ".join(host_command(name, Path(), jpeg)[1:]).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_host(name: str, jpeg: Optional[bool] = None) -> str:
    """Compile ``csrc/<name>.cc`` unless its current library exists; returns
    the library's path. ``jpeg`` defaults to ``has_jpeglib()``. Raises
    ``RuntimeError`` with the compiler's output when ``g++`` fails."""
    jpeg = has_jpeglib() if jpeg is None else jpeg
    out = _host_lib_path(name, jpeg)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = host_command(name, tmp, jpeg)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for csrc/{name}.cc:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return str(out)


def bind(lib: ctypes.CDLL, signatures: Dict[str, Tuple[list, Any]]
         ) -> ctypes.CDLL:
    """Set ``argtypes``/``restype`` of ``lib``'s functions from
    ``signatures``; returns ``lib``."""
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


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
    build_dir().mkdir(parents=True, exist_ok=True)
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
    """The loaded library for ``csrc/<name>.cu`` (or the host library
    ``csrc/<name>.cc`` of ``HOST_SOURCES``), built on first use, with
    ``argtypes``/``restype`` set from ``signatures`` ({function: (argtypes,
    restype)}; pointers and the stream as ``c_void_p``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name in HOST_SOURCES:
                path = build_host(name)
            else:
                if not _lib_path(name).exists():
                    build_all([name])
                path = str(_lib_path(name))
            lib = bind(ctypes.CDLL(path), signatures)
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
