"""Profiler capture for the loops' ``--profile_dir`` / ``--profile_steps``:
the port of the JAX package's ``utils/profiling.py trace`` on
``torch.profiler``. The trace (host ops and, on CUDA, device kernels) is
written as a Chrome/TensorBoard trace file under ``log_dir``.

The JAX package's TPU compiler tuning (``apply_tpu_tuning``) and its
roofline helpers have no counterpart here.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.profiler import (
    ProfilerActivity,
    profile,
    tensorboard_trace_handler,
)


@contextlib.contextmanager
def trace(log_dir: Optional[str], cuda: Optional[bool] = None):
    """``with trace('/tmp/trace'):`` captures a trace of the block into
    ``log_dir``, the card's kernels too where CUDA is available (or where
    ``cuda`` says so), and waits for the card before it stops; a no-op if
    ``log_dir`` is falsy, so call sites can pass the flag straight
    through."""
    if not log_dir:
        yield None
        return
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
