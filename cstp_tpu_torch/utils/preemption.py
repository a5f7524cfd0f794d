"""Graceful preemption for one process: SIGTERM -> finish the current step,
checkpoint, stop. The port of the JAX package's ``utils/preemption.py``
single-process regime (a signal handler sets a flag that the train loop
checks after every step); the multi-process agreement on a stop step
belongs with distributed training, which the port does not have yet.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


class PreemptionGuard:
    """Install a SIGTERM flag.

    Usage::

        guard = PreemptionGuard(enabled=True)
        for step: ...
            if guard.requested(global_step):
                save_checkpoint(...); break
        guard.close()
    """

    def __init__(self, enabled: bool = True,
                 signals: Iterable[int] = (signal.SIGTERM,)):
        self.enabled = bool(enabled)
        self._event = threading.Event()
        self._old = {}
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
        """True once a graceful stop should happen. ``step_id`` is the
        global step counter (the agreement point of the multi-process
        regime; unused by one process)."""
        return self.enabled and self._event.is_set()

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
