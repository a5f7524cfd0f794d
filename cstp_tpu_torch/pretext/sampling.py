"""CSTP sampling helpers: the port's own copies of the JAX package's
``pretext/sampling.py`` constant that the box sampler uses and of the frame
index helpers of the video-level test windows."""

from __future__ import annotations

from typing import Tuple

import numpy as np

OVERLAP_SPA_RATE: Tuple[float, ...] = (1.0, 0.8, 0.6, 0.4, 0.2)


def wraparound_frame_indices(total_frames: int, sample_duration: int,
                             stride: int) -> np.ndarray:
    """Short-video padding: walk by ``stride``, wrap to 0 past the end.
    Returns ``(L,)`` 0-based frame offsets."""
    idx = []
    f = 0
    while len(idx) < sample_duration:
        idx.append(f)
        f += stride
        if f >= total_frames:
            f = 0
    return np.asarray(idx, dtype=np.int32)


def strided_frame_indices(start: int, sample_duration: int,
                          stride: int) -> np.ndarray:
    """0-based offsets ``start, start + stride, ...`` (L frames)."""
    return (start + np.arange(sample_duration, dtype=np.int32) * stride
            ).astype(np.int32)
