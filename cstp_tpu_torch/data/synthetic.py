"""Synthetic video dataset — deterministic, dependency-free: the port's own
copy of the JAX package's ``data/synthetic.py`` (the same frames bitwise).

Used by tests, the chip smoke run and synthetic CLI runs. Implements the
same reader protocol as the real datasets:

  num_videos() -> int
  video_meta(i) -> (nframes, label)
  read_frames(i, indices) -> uint8 (len(indices), H0, W0, 3)

Frames are cheap procedural patterns that vary smoothly with (video, frame)
so temporal/pretext structure is non-degenerate.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class SyntheticVideoDataset:
    """``learnable=False`` (default): labels are random — fine for smoke
    tests and throughput runs. ``learnable=True``: the spatial frequency and
    phase velocity are functions of the label, so a classifier genuinely CAN
    decode the class from content (used by the long-horizon learning-evidence
    runs). The oriented sinusoidal structure also
    makes every CSTP pretext label learnable: rotation from orientation
    statistics, playback rate from apparent phase velocity, spatial/temporal
    overlap from content correspondence between the two views."""

    def __init__(self, n_videos: int = 256, n_classes: int = 101,
                 ingest_hw: Tuple[int, int] = (128, 171),
                 min_frames: int = 40, max_frames: int = 300, seed: int = 0,
                 learnable: bool = False):
        self.n_videos = n_videos
        self.n_classes = n_classes
        self.h0, self.w0 = ingest_hw
        self.learnable = learnable
        rng = np.random.default_rng(seed)
        self._nframes = rng.integers(min_frames, max_frames + 1, n_videos)
        self._labels = rng.integers(0, n_classes, n_videos)
        self._phase = rng.uniform(0, 2 * np.pi, (n_videos, 3))
        yy, xx = np.mgrid[0 : self.h0, 0 : self.w0].astype(np.float32)
        self._yy = yy / self.h0
        self._xx = xx / self.w0

    def num_videos(self) -> int:
        return self.n_videos

    def video_meta(self, i: int) -> Tuple[int, int]:
        return int(self._nframes[i]), int(self._labels[i])

    def read_frames(self, i: int, indices: Sequence[int]) -> np.ndarray:
        ph = self._phase[i]
        if self.learnable:
            # class-conditional content: x-frequency, phase velocity, AND
            # y-frequency are label functions — 5*4*6 = 120 distinct
            # combinations, so every label < 120 (covers UCF-101's 101)
            # maps to statistically distinct video content
            lab = int(self._labels[i])
            fx = 4.0 + 1.5 * (lab % 5)
            vel = 0.10 + 0.05 * ((lab // 5) % 4)
            fy = 3.0 + 1.0 * ((lab // 20) % 6)
        else:
            fx, vel, fy = 6.0, 0.15, 5.0
        t = np.asarray(indices, np.float32)[:, None, None] * vel
        base = np.sin(fx * self._xx[None] + t + ph[0]) * np.cos(
            fy * self._yy[None] - 0.5 * t + ph[1]
        )
        frames = np.stack(
            [
                127 + 100 * base,
                127 + 100 * np.roll(base, 7, axis=2),
                127 + 100 * np.sin(4.0 * self._yy[None] + t + ph[2]),
            ],
            axis=-1,
        )
        return np.clip(frames, 0, 255).astype(np.uint8)
