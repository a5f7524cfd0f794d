"""The machine-scoped directory of the port's built libraries.

The port of ``cstp_tpu/utils/cache.py``. A library that ``nvcc`` or ``g++``
built on one machine bakes in that machine's toolchain and target: a
``build/`` folder copied from another host, another PyTorch or another CUDA
toolkit must not be loaded there. :func:`machine_scoped_cache_dir` names a
directory by a hash of all of these, so such a folder simply misses and the
libraries are built again; it is never loaded.

The JAX package's ``enable_persistent_cache`` (XLA's compile cache) has no
counterpart: the port compiles no XLA programs and keeps no such cache.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional


def _cpu_fingerprint() -> str:
    """Best-effort host-CPU identity string: the machine and system, and
    the first of each of ``/proc/cpuinfo``'s model name, flags, features,
    family, model, stepping and microcode lines (CPU generations whose flag
    strings are the same differ in the others)."""
    bits = [platform.machine(), platform.system()]
    keys = ("model name", "flags", "Features", "cpu family", "model",
            "stepping", "microcode")
    seen = set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k = line.split(":")[0].strip()
                if k in keys and k not in seen:
                    seen.add(k)
                    bits.append(line.strip())
                    if len(seen) == len(keys):
                        break
    except OSError:
        bits.append(platform.processor() or "unknown-cpu")
    return "|".join(bits)


def find_nvcc() -> Optional[str]:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME`` (``/usr/local/cuda``
    by default); None where there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(cand) if cand.exists() else None


def tool_version(path: Optional[str]) -> str:
    """What ``path --version`` prints (all of it: ``nvcc``'s first line
    names the tool, its release is on a later one); empty where the tool is
    missing or fails."""
    if path is None:
        return ""
    try:
        proc = subprocess.run([path, "--version"], capture_output=True,
                              text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return proc.stdout.strip() if proc.returncode == 0 else ""


def machine_scoped_cache_dir(base) -> str:
    """``base/<fingerprint>``: the fingerprint hashes the host CPU
    (:func:`_cpu_fingerprint`), ``torch.__version__`` and
    ``torch.version.cuda``, and the ``--version`` output of ``nvcc`` and of
    ``g++`` where each is found."""
    import torch

    raw = "\n".join([_cpu_fingerprint(), torch.__version__,
                     str(torch.version.cuda), tool_version(find_nvcc()),
                     tool_version(shutil.which("g++"))])
    fp = hashlib.sha1(raw.encode()).hexdigest()[:12]
    return os.path.join(str(base), fp)
