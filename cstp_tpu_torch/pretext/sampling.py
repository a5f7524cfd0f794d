"""CSTP pretext samplers on the host (numpy): the port's own copy of the
JAX package's ``pretext/sampling.py``.

* playback-rate label ``pb in [0, min(3, floor(log2(T / (L - 1))))]``
  selecting a frame stride from ``PACE``;
* temporal-overlap label ``tem in [0, 4]`` shifting the second clip's start
  by ``±(1 - rate) * clip_range``, drawn uniformly over the valid
  ``(tem, side)`` pairs (the stationary law of the reference's retry loop);
* two independent rotation labels;
* short-video wrap-around padding.

The draws are the JAX package's, in its order, so one
``np.random.Generator`` gives the same frame indices and labels in both.
Frame indices are 0-based offsets; readers add the +1 of the reference's
1-based JPEG names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

PACE: Tuple[int, ...] = (1, 2, 4, 8)
OVERLAP_TEM_RATE: Tuple[float, ...] = (1.0, 0.8, 0.6, 0.4, 0.2)
OVERLAP_SPA_RATE: Tuple[float, ...] = (1.0, 0.8, 0.6, 0.4, 0.2)
ROTATE_DEG: Tuple[int, ...] = (0, 90, 180, 270)


def max_playback_label(total_frames: int, sample_duration: int) -> int:
    """Largest valid pb label: ``floor(log2(T / (L - 1)))`` capped at 3."""
    if total_frames <= 0:
        return 0
    ratio = total_frames / (sample_duration - 1)
    if ratio < 1.0:
        return 0
    return min(3, int(np.log2(ratio)))


def sample_playback_label(rng: np.random.Generator, total_frames: int,
                          sample_duration: int) -> int:
    """``pb ~ U{0 .. max_playback_label}``."""
    hi = max_playback_label(total_frames, sample_duration)
    return int(rng.integers(0, hi + 1))


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


def valid_temporal_offsets(start: int, total_frames: int, clip_range: int
                           ) -> List[Tuple[int, int, int]]:
    """The valid ``(tem_label, side, start_2)`` for a first-clip start:
    side 0 starts the second clip earlier, side 1 later; valid iff
    ``0 <= start_2 <= total_frames - clip_range - 1``. ``tem`` 0 (offset 0)
    is always valid, so the list is never empty."""
    out = []
    hi = total_frames - clip_range - 1
    for tem in range(5):
        offset = int((1.0 - OVERLAP_TEM_RATE[tem]) * clip_range)
        for side in (0, 1):
            s2 = start - offset if side == 0 else start + offset
            if 0 <= s2 <= hi:
                out.append((tem, side, s2))
    return out


def sample_temporal_overlap(rng: np.random.Generator, start: int,
                            total_frames: int, clip_range: int
                            ) -> Tuple[int, int]:
    """``(tem_label, start_2)`` uniform over the valid ``(tem, side)``
    pairs."""
    combos = valid_temporal_offsets(start, total_frames, clip_range)
    tem, _side, s2 = combos[int(rng.integers(0, len(combos)))]
    return tem, s2


@dataclass
class ClipPairSample:
    """The host-side pretext decisions for one training sample."""

    indices_1: np.ndarray  # (L,) 0-based frame offsets of clip 1
    indices_2: np.ndarray  # (L,) 0-based frame offsets of clip 2
    pb_label: int
    tem_label: int
    rot_label_1: int
    rot_label_2: int


def sample_clip_pair_host(rng: np.random.Generator, total_frames: int,
                          sample_duration: int) -> ClipPairSample:
    """The temporal pretext sampling for one video: which frames the two
    clips read, and the pb, tem and rotation labels. Boxes and photometric
    augmentation are drawn on the device."""
    pb = sample_playback_label(rng, total_frames, sample_duration)
    stride = PACE[pb]
    clip_range = (sample_duration - 1) * stride
    rot1 = int(rng.integers(0, 4))
    rot2 = int(rng.integers(0, 4))

    if total_frames - clip_range <= 0:
        idx = wraparound_frame_indices(total_frames, sample_duration, stride)
        return ClipPairSample(idx, idx.copy(), pb, 0, rot1, rot2)

    start = int(rng.integers(0, total_frames - clip_range))
    tem, start2 = sample_temporal_overlap(rng, start, total_frames,
                                          clip_range)
    return ClipPairSample(
        strided_frame_indices(start, sample_duration, stride),
        strided_frame_indices(start2, sample_duration, stride),
        pb, tem, rot1, rot2)
