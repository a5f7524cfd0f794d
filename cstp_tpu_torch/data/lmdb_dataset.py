"""Reference-layout LMDB video dataset and the LMDB <-> CSTPack converters:
the port's own copy of the JAX package's ``data/lmdb_dataset.py``.

Reproduces the access pattern of ``UCF101RepreLMDB`` / ``Kin400RepreLMDB``:
the env's ``__order__`` meta key maps video relpaths to ``b'%09d'`` record
keys, each record is a msgpack list of raw per-frame JPEG bytes, and the
train/val lists come from the annotation directory (UCF single-space /
Kinetics double-space formats). Frames decode on the host through the
native libjpeg pool (``data/native_reader.py decode_jpeg_blobs``), or with
PIL under ``CSTP_FORCE_PIL_DECODE=1``.
"""

from __future__ import annotations

import io
import os
from typing import List, Sequence, Tuple

import numpy as np

from cstp_tpu_torch.data.labels import (
    VideoRecord,
    parse_kinetics_list,
    parse_ucf_list,
    ucf_list_path,
)
from cstp_tpu_torch.data.lmdb_store import LMDBReader


def _unpack(raw: bytes):
    import msgpack

    return msgpack.loads(raw)


def _list_file(annotation_path: str, dataset: str, data_type: str,
               split: str) -> Tuple[str, bool]:
    """(list path, is_kinetics_format) — reference list-name conventions
    (datasets.py:521-526 UCF, 1276-1280 Kinetics)."""
    if dataset.lower().startswith("kin"):
        name = ("train_list_label_nframe.txt" if data_type == "train"
                else "val_list_label_nframe.txt")
        return os.path.join(annotation_path, name), True
    return ucf_list_path(annotation_path, data_type, split), False


class LMDBVideoDataset:
    """Standard reader protocol (num_videos / video_meta / read_frames) over
    a reference-layout LMDB shard."""

    def __init__(self, lmdb_path: str, annotation_path: str,
                 dataset: str = "UCF101", data_type: str = "train",
                 split: str = "1", ingest_hw: Tuple[int, int] = (128, 171)):
        self.h0, self.w0 = ingest_hw
        self.db = LMDBReader(lmdb_path)
        order = _unpack(self.db[b"__order__"])
        key_of = {
            (n.decode() if isinstance(n, bytes) else n): b"%09d" % i
            for i, n in enumerate(order)
        }
        list_path, kin = _list_file(annotation_path, dataset, data_type, split)
        records = (parse_kinetics_list(list_path) if kin
                   else parse_ucf_list(list_path))
        self.records: List[VideoRecord] = []
        self.keys: List[bytes] = []
        for r in records:
            k = key_of.get(r.path)
            if k is None:  # video missing from the shard — skip like a
                continue   # failed-exists check in the frame-dir path
            self.records.append(r)
            self.keys.append(k)
        if not self.records:
            raise FileNotFoundError(
                f"no videos from {list_path} found in LMDB {lmdb_path}")

    def num_videos(self) -> int:
        return len(self.records)

    def video_meta(self, i: int) -> Tuple[int, int]:
        r = self.records[i]
        if r.nframes <= 0:
            # plain (no-_nframe) split list: probe from the shard's __vlen__
            # meta key when present, else count the record's blobs
            if not hasattr(self, "_vlen"):
                try:
                    self._vlen = _unpack(self.db[b"__vlen__"])
                except KeyError:
                    self._vlen = None
            if self._vlen is not None:
                r.nframes = int(self._vlen[int(self.keys[i])])
            else:
                r.nframes = len(self.frame_blobs(i))
        return r.nframes, r.label

    def frame_blobs(self, i: int) -> List[bytes]:
        return _unpack(self.db[self.keys[i]])

    def read_frames(self, i: int, indices: Sequence[int]) -> np.ndarray:
        blobs = self.frame_blobs(i)
        idxs = [min(int(x), len(blobs) - 1) for x in indices]
        uniq = sorted(set(idxs))

        # the native libjpeg pool; None where PIL is to decode
        from cstp_tpu_torch.data.native_reader import decode_jpeg_blobs

        decoded = decode_jpeg_blobs([blobs[u] for u in uniq],
                                    (self.h0, self.w0))
        if decoded is not None:
            cache = {u: decoded[k] for k, u in enumerate(uniq)}
        else:
            from PIL import Image

            cache = {}
            for u in uniq:
                with Image.open(io.BytesIO(blobs[u])) as img:
                    cache[u] = np.asarray(
                        img.convert("RGB").resize((self.w0, self.h0),
                                                  Image.BILINEAR), np.uint8)
        out = np.empty((len(idxs), self.h0, self.w0, 3), np.uint8)
        for j, idx in enumerate(idxs):
            out[j] = cache[idx]
        return out

    def close(self):
        self.db.close()


def lmdb_to_cstpack(lmdb_path: str, annotation_path: str, out_path: str,
                    dataset: str = "UCF101", data_type: str = "train",
                    split: str = "1", limit: int = 0) -> int:
    """Convert a reference LMDB shard to a CSTPack shard (JPEG blobs copied
    verbatim — no re-encode). Returns the number of videos written."""
    from cstp_tpu_torch.data.packed import PackedWriter

    ds = LMDBVideoDataset(lmdb_path, annotation_path, dataset=dataset,
                          data_type=data_type, split=split)
    n = ds.num_videos() if not limit else min(limit, ds.num_videos())
    w = PackedWriter(out_path)
    for i in range(n):
        r = ds.records[i]
        w.add_video(r.path, r.label, ds.frame_blobs(i))
    w.close()
    ds.close()
    return n


def frame_dir_to_lmdb(frame_dir: str, out_path: str,
                      subdir: bool = True, seed: int = 0,
                      limit: int = 0) -> int:
    """Build a reference-layout LMDB from a frame directory tree: shuffled
    video ids (``random.Random(seed)``), msgpack'd lists of the raw JPEG
    bytes, and the meta keys. Returns the number of videos written."""
    import random

    import msgpack

    from cstp_tpu_torch.data.lmdb_store import write_lmdb

    video_list = sorted(
        os.path.join(c, v)
        for c in os.listdir(frame_dir)
        if os.path.isdir(os.path.join(frame_dir, c))
        for v in os.listdir(os.path.join(frame_dir, c))
    )
    if limit:
        video_list = video_list[:limit]
    rnd = random.Random(0)
    rnd.seed(seed)
    rnd.shuffle(video_list)
    items = {}
    keys, vlens = [], []
    for i, rel in enumerate(video_list):
        vdir = os.path.join(frame_dir, rel)
        files = sorted(f for f in os.listdir(vdir) if f.endswith(".jpg"))
        raws = []
        for f in files:
            with open(os.path.join(vdir, f), "rb") as fh:
                raws.append(fh.read())
        key = b"%09d" % i
        items[key] = msgpack.dumps(raws)
        keys.append(key)
        vlens.append(len(raws))
    items[b"__keys__"] = msgpack.dumps(keys)
    items[b"__len__"] = msgpack.dumps(len(keys))
    items[b"__order__"] = msgpack.dumps(video_list)
    items[b"__vlen__"] = msgpack.dumps(vlens)
    write_lmdb(out_path, items, subdir=subdir)
    return len(video_list)
