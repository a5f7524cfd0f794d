"""Graceful preemption: SIGTERM -> finish the current step, checkpoint,
stop. The port of the JAX package's ``utils/preemption.py``.

Two regimes:

* one process: a signal handler sets a flag that the train loop checks
  after every step;
* a process group: every rank must stop at the same step, or the others
  wait forever in the next collective. Each check all-reduces the MAX of
  the ranks' local flags over a gloo group on the CPU, so every rank sees
  a stop at the same ``step_id`` (the counterpart of JAX's
  ``reached_preemption_sync_point``) without waiting for the card. Rank 0
  then writes the checkpoint.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable

import torch
import torch.distributed as dist

from cstp_tpu_torch.parallel.mesh import is_distributed


class PreemptionGuard:
    """Install a SIGTERM flag; under a process group, agree on it.

    Usage::

        guard = PreemptionGuard(enabled=True)
        for step: ...
            if guard.requested(global_step):
                save_checkpoint(...); break
        guard.close()

    Every rank constructs its guard at the same point of the run (the gloo
    group is created collectively) and calls ``requested`` once per step.
    """

    def __init__(self, enabled: bool = True,
                 signals: Iterable[int] = (signal.SIGTERM,)):
        self.enabled = bool(enabled)
        self._event = threading.Event()
        self._old = {}
        self._group = None
        self._multi = self.enabled and is_distributed() \
            and dist.get_world_size() > 1
        if self._multi and dist.get_backend() != "gloo":
            self._group = dist.new_group(backend="gloo")
        if not self.enabled:
            return
        for sig in signals:
            try:
                self._old[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                # not the main thread: no handler, the flag stays unset
                pass

    def _on_signal(self, signum, frame):  # pragma: no cover - trivial
        self._event.set()

    def requested(self, step_id: int) -> bool:
        """True once a graceful stop should happen: this process's flag, or
        under a process group any rank's (the same answer on every rank at
        this ``step_id``, the global step counter)."""
        if not self.enabled:
            return False
        if not self._multi:
            return self._event.is_set()
        flag = torch.tensor([int(self._event.is_set())], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
        return bool(flag.item())

    def close(self) -> None:
        """Restore any signal handlers this guard replaced."""
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except ValueError:  # pragma: no cover
                pass
        self._old.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
