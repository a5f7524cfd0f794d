"""Scalar meters and the tab-separated epoch-log writer: the port's own
copy of ``cstp_tpu/train/meters.py``.

The on-disk format is the reference's csv.writer epoch log: tab delimiter,
CRLF line endings, a header row only on fresh runs.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

_EOL = "\r\n"   # csv.writer's default line terminator


@dataclass
class AverageMeter:
    """Streaming mean over weighted scalar updates."""

    val: float = 0.0
    sum: float = 0.0
    count: int = 0

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def reset(self) -> None:
        self.val, self.sum, self.count = 0.0, 0.0, 0

    def update(self, value: float, n: int = 1) -> None:
        self.val = value
        self.sum += value * n
        self.count += n


def _render_row(cells: Sequence) -> str:
    # csv.writer renders None as the empty string
    return "\t".join("" if c is None else str(c) for c in cells) + _EOL


class Logger:
    """Tab-separated epoch log. ``overlay=True`` truncates and writes the
    header (fresh run); ``overlay=False`` appends without one (resume)."""

    def __init__(self, path: str, header: Sequence[str], overlay: bool = True):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.header = tuple(header)
        # newline='' so _EOL passes through untranslated on every platform
        self._fh = open(path, "w" if overlay else "a", newline="")
        if overlay:
            self._fh.write(_render_row(self.header))

    def log(self, values: Mapping) -> None:
        missing = [c for c in self.header if c not in values]
        if missing:
            raise KeyError(f"log row missing columns {missing}")
        self._fh.write(_render_row([values[c] for c in self.header]))
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "Logger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclass
class StepTimer:
    """Per-step wall time split into data-wait and whole-step parts."""

    batch_time: AverageMeter = field(default_factory=AverageMeter)
    data_time: AverageMeter = field(default_factory=AverageMeter)
    _mark: float = field(default_factory=time.time)

    def data_tick(self) -> None:
        self.data_time.update(time.time() - self._mark)

    def batch_tick(self) -> None:
        now = time.time()
        self.batch_time.update(now - self._mark)
        self._mark = now


def calculate_accuracy(logits, targets) -> float:
    """Batch top-1 accuracy from logits and integer targets (arrays or CPU
    tensors)."""
    pred = np.asarray(logits).argmax(axis=-1)
    return float((pred == np.asarray(targets)).mean())
