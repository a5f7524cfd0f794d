"""Frame-directory JPEG reader: the port's own copy of the JAX package's
``data/framedir.py`` (the same PIL decode and BILINEAR resize).

The reference's primary UCF-101 storage: one directory per video containing
1-based ``%05d.jpg`` frames (datasets.py:895,930 and the ffmpeg extractor
``utils_dir/extract_frames_kin.py``). This reader decodes on the host and
resizes to a fixed ingest resolution so the device augmentation pipeline
sees static shapes; all cropping/augmentation happens on-device afterwards.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from cstp_tpu_torch.data.labels import (
    VideoRecord,
    parse_ucf_list,
    ucf_list_path,
)

try:  # PIL is the host decode dependency (same as the reference)
    from PIL import Image

    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False


class FrameDirDataset:
    """UCF/HMDB-style frame-dir dataset with the standard reader protocol."""

    def __init__(
        self,
        frame_dir: str,
        annotation_path: str,
        split: str = "1",
        data_type: str = "train",
        ingest_hw: Tuple[int, int] = (128, 171),
        check_exists: bool = True,
    ):
        if not _HAVE_PIL:
            raise RuntimeError("PIL required for frame-dir ingest")
        self.frame_dir = frame_dir
        self.h0, self.w0 = ingest_hw
        list_path = ucf_list_path(annotation_path, data_type, split)
        self.records: List[VideoRecord] = parse_ucf_list(
            list_path, frame_dir, check_exists
        )
        if not self.records:
            raise FileNotFoundError(f"no videos found via {list_path}")

    def num_videos(self) -> int:
        return len(self.records)

    def video_meta(self, i: int) -> Tuple[int, int]:
        r = self.records[i]
        if r.nframes <= 0:
            # plain (no-_nframe) split list: probe the frame count from the
            # extracted %05d.jpg files on first use and cache it
            vdir = os.path.join(self.frame_dir, r.path)
            r.nframes = sum(1 for f in os.listdir(vdir) if f.endswith(".jpg"))
        return r.nframes, r.label

    def read_frames(self, i: int, indices: Sequence[int]) -> np.ndarray:
        """Decode frames (0-based offsets; files are 1-based) and resize to
        the ingest resolution. Returns uint8 (L, H0, W0, 3)."""
        r = self.records[i]
        vdir = os.path.join(self.frame_dir, r.path)
        out = np.empty((len(indices), self.h0, self.w0, 3), np.uint8)
        cache = {}
        for j, idx in enumerate(indices):
            idx = int(idx)
            if idx in cache:
                out[j] = cache[idx]
                continue
            fp = os.path.join(vdir, "%05d.jpg" % (idx + 1))
            with Image.open(fp) as img:
                img = img.convert("RGB").resize(
                    (self.w0, self.h0), Image.BILINEAR
                )
                arr = np.asarray(img, np.uint8)
            cache[idx] = arr
            out[j] = arr
        return out
