"""CSTPack — packed video shard store: the port's own copy of the JAX
package's writer and pure-Python reader (``data/packed.py``), byte for byte
the same file format:

  header:   magic 'CSTP' | version u32 | n_videos u64 | index_offset u64
  body:     per-video: concatenated frame blobs (JPEG bytes or raw uint8)
  index:    per-video: label i32, nframes i32, codec u8 (0=jpeg, 1=raw u8),
            raw h/w u16 (codec 1), path_len u16 + utf-8 path,
            frame_offsets u64[nframes + 1]  (absolute file offsets)

Readers mmap the file and fetch exactly the frames a clip needs. The raw
codec is a memcpy per frame; JPEG frames decode with PIL. This module is
the pure-Python reader and the writer; the C++ reader of the same format
is ``data/native_reader.py``, and ``pack_frame_dir`` is the offline tool
that packs a frame directory (``python -m cstp_tpu_torch.data.pack
frames``).
"""

from __future__ import annotations

import io
import mmap
import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"CSTP"
VERSION = 1
CODEC_JPEG = 0
CODEC_RAW = 1


@dataclass
class _VideoIndex:
    path: str
    label: int
    nframes: int
    codec: int
    raw_h: int
    raw_w: int
    offsets: np.ndarray  # (nframes + 1,) u64


class PackedWriter:
    def __init__(self, out_path: str):
        self.f = open(out_path, "wb")
        self.f.write(MAGIC)
        self.f.write(struct.pack("<IQQ", VERSION, 0, 0))  # placeholders
        self.index: List[_VideoIndex] = []

    def add_video(self, path: str, label: int, frames: Sequence[bytes],
                  codec: int = CODEC_JPEG, raw_hw: Tuple[int, int] = (0, 0)):
        offsets = [self.f.tell()]
        for blob in frames:
            self.f.write(blob)
            offsets.append(self.f.tell())
        self.index.append(
            _VideoIndex(path, label, len(frames), codec, raw_hw[0], raw_hw[1],
                        np.asarray(offsets, np.uint64))
        )

    def add_video_raw(self, path: str, label: int, frames: np.ndarray):
        """frames: (N, H, W, 3) uint8 stored uncompressed (decode-free reads)."""
        if frames.dtype != np.uint8 or frames.ndim != 4:
            raise ValueError(f"raw frames must be (N, H, W, 3) uint8, got "
                             f"{frames.dtype} {frames.shape}")
        n, h, w, _ = frames.shape
        self.add_video(path, label, [frames[i].tobytes() for i in range(n)],
                       codec=CODEC_RAW, raw_hw=(h, w))

    def close(self):
        index_offset = self.f.tell()
        for v in self.index:
            enc = v.path.encode("utf-8")
            self.f.write(struct.pack("<iiBHHH", v.label, v.nframes, v.codec,
                                     v.raw_h, v.raw_w, len(enc)))
            self.f.write(enc)
            self.f.write(v.offsets.tobytes())
        self.f.seek(len(MAGIC))
        self.f.write(struct.pack("<IQQ", VERSION, len(self.index), index_offset))
        self.f.close()


class PackedDataset:
    """mmap reader with the standard dataset protocol (num_videos /
    video_meta / read_frames). JPEG decode via PIL; raw codec is memcpy."""

    def __init__(self, path: str, ingest_hw: Optional[Tuple[int, int]] = (128, 171)):
        self.path = path
        self.h0, self.w0 = ingest_hw if ingest_hw else (0, 0)
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:4] != MAGIC:
            raise ValueError(f"{path} is not a CSTPack file")
        version, n_videos, index_offset = struct.unpack_from("<IQQ", self._mm, 4)
        if version != VERSION:
            raise ValueError(f"{path}: CSTPack version {version}, expected "
                             f"{VERSION}")
        self.index: List[_VideoIndex] = []
        pos = index_offset
        for _ in range(n_videos):
            label, nframes, codec, rh, rw, plen = struct.unpack_from(
                "<iiBHHH", self._mm, pos
            )
            pos += struct.calcsize("<iiBHHH")
            vpath = self._mm[pos : pos + plen].decode("utf-8")
            pos += plen
            offsets = np.frombuffer(self._mm, np.uint64, nframes + 1, pos).copy()
            pos += (nframes + 1) * 8
            self.index.append(_VideoIndex(vpath, label, nframes, codec, rh, rw,
                                          offsets))

    def num_videos(self) -> int:
        return len(self.index)

    def video_meta(self, i: int) -> Tuple[int, int]:
        v = self.index[i]
        return v.nframes, v.label

    def frame_blob(self, i: int, frame: int) -> bytes:
        v = self.index[i]
        lo, hi = int(v.offsets[frame]), int(v.offsets[frame + 1])
        return self._mm[lo:hi]

    def read_frames(self, i: int, indices: Sequence[int]) -> np.ndarray:
        v = self.index[i]
        if v.codec == CODEC_RAW:
            out = np.empty((len(indices), v.raw_h, v.raw_w, 3), np.uint8)
            for j, idx in enumerate(indices):
                out[j] = np.frombuffer(
                    self.frame_blob(i, int(idx)), np.uint8
                ).reshape(v.raw_h, v.raw_w, 3)
            if self.h0 and (v.raw_h, v.raw_w) != (self.h0, self.w0):
                out = _resize_batch(out, self.h0, self.w0)
            return out
        from PIL import Image

        out = np.empty((len(indices), self.h0, self.w0, 3), np.uint8)
        cache = {}
        for j, idx in enumerate(indices):
            idx = int(idx)
            if idx not in cache:
                with Image.open(io.BytesIO(self.frame_blob(i, idx))) as img:
                    cache[idx] = np.asarray(
                        img.convert("RGB").resize((self.w0, self.h0),
                                                  Image.BILINEAR),
                        np.uint8,
                    )
            out[j] = cache[idx]
        return out

    def close(self):
        self._mm.close()
        self._file.close()


def _resize_batch(frames: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image

    out = np.empty((frames.shape[0], h, w, 3), np.uint8)
    for i in range(frames.shape[0]):
        out[i] = np.asarray(
            Image.fromarray(frames[i]).resize((w, h), Image.BILINEAR), np.uint8
        )
    return out


def pack_frame_dir(frame_dir: str, annotation_file: str, out_path: str,
                   raw_hw: Optional[Tuple[int, int]] = None,
                   limit: int = 0) -> int:
    """Offline tool: the JPEG frames of a frame directory -> one CSTPack
    shard, the videos of ``annotation_file`` in its order. With ``raw_hw``
    frames are decoded and stored raw at that size (reads without decode).
    Returns the number of videos packed."""
    from PIL import Image

    from cstp_tpu_torch.data.labels import parse_ucf_list

    records = parse_ucf_list(annotation_file, frame_dir, check_exists=True)
    if limit:
        records = records[:limit]
    w = PackedWriter(out_path)
    for r in records:
        vdir = os.path.join(frame_dir, r.path)
        files = sorted(f for f in os.listdir(vdir) if f.endswith(".jpg"))
        if raw_hw is None:
            blobs = []
            for f in files:
                with open(os.path.join(vdir, f), "rb") as fh:
                    blobs.append(fh.read())
            w.add_video(r.path, r.label, blobs, codec=CODEC_JPEG)
        else:
            frames = []
            for f in files:
                with Image.open(os.path.join(vdir, f)) as img:
                    frames.append(np.asarray(img.convert("RGB").resize(
                        (raw_hw[1], raw_hw[0]), Image.BILINEAR), np.uint8))
            w.add_video_raw(r.path, r.label, np.stack(frames))
    w.close()
    return len(records)
