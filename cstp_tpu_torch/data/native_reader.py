"""ctypes binding of the port's C++ CSTPack reader
(``cstp_tpu_torch/csrc/cstpack_reader.cc``): the counterpart of the JAX
package's ``data/native_reader.py``.

The library mmaps a shard, decodes JPEG frames with libjpeg, resizes them
with a fixed-point bilinear filter and fills a whole batch from a pthread
pool, without the interpreter lock. It is built with ``g++`` from the
repository's source at first use (``ops/build.py build_host``, into
``build/cstp_tpu_torch/<fingerprint>/``); a failed build raises with the
compiler's output, and nothing falls back to the Python reader without saying so.

Where ``g++`` finds no ``jpeglib.h``, the library is built with its JPEG
decode compiled out: it serves raw-codec shards, ``NativePackedDataset``
refuses a shard that holds JPEG videos with :class:`NoJpegDecoder`, and
``decode_jpeg_blobs`` leaves JPEG blobs to PIL; each says why in the log.
"""

from __future__ import annotations

import ctypes
import logging
import os
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

from cstp_tpu_torch.ops import build

_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_c = ctypes
SIGNATURES = {
    "cstpack_open": ([_c.c_char_p], _c.c_void_p),
    "cstpack_num_videos": ([_c.c_void_p], _c.c_int),
    "cstpack_meta": ([_c.c_void_p, _c.c_int, _c.POINTER(_c.c_int),
                      _c.POINTER(_c.c_int)], None),
    "cstpack_read_batch": ([_c.c_void_p, _i32, _i32, _c.c_int, _c.c_int,
                            _c.c_int, _c.c_int, _u8, _c.c_int], _c.c_int),
    "cstpack_close": ([_c.c_void_p], None),
    "cstpack_jpeg_videos": ([_c.c_void_p], _c.c_int),
    "cstp_has_jpeg": ([], _c.c_int),
    "cstp_decode_blobs": ([_c.POINTER(_c.c_void_p), _c.POINTER(_c.c_size_t),
                           _c.c_int, _c.c_int, _c.c_int, _u8, _c.c_int],
                          _c.c_int),
}


def load_native_lib() -> ctypes.CDLL:
    """The reader's library, built from ``csrc/cstpack_reader.cc`` on first
    use; raises ``RuntimeError`` with the compiler's output if it does not
    build."""
    return build.load("cstpack_reader", SIGNATURES)


class NoJpegDecoder(RuntimeError):
    """The reader was built without libjpeg and the shard holds JPEG
    videos."""


_decode_path_announced = False
_reader_announced = False


def _announce_reader(n_threads: int) -> None:
    """Log once that CSTPack shards are read by the C++ reader."""
    global _reader_announced
    if _reader_announced:
        return
    _reader_announced = True
    logging.getLogger("cstp_tpu_torch.data").info(
        "CSTPack reader: native cstpack_read_batch pool, %d threads "
        "(csrc/cstpack_reader.cc)", n_threads)


def _announce_decode_path(native: bool, why: str = "") -> None:
    """Log once which JPEG decode path is live. The native pool and PIL both
    wrap libjpeg, but their resize filters differ slightly, so the frames
    are not bitwise the same on the two paths; ``CSTP_FORCE_PIL_DECODE=1``
    pins PIL."""
    global _decode_path_announced
    if _decode_path_announced:
        return
    _decode_path_announced = True
    logging.getLogger("cstp_tpu_torch.data").info(
        "JPEG decode path: %s%s (CSTP_FORCE_PIL_DECODE=1 forces PIL)",
        "native cstp_decode_blobs pool" if native else "PIL",
        f", {why}" if why else "")


def decode_jpeg_blobs(blobs: Sequence[bytes], out_hw: Tuple[int, int],
                      n_threads: int = 4) -> Optional[np.ndarray]:
    """Decode and resize independent JPEG blobs into ``(n, H, W, 3)`` uint8
    with the native libjpeg pool. Returns None when
    ``CSTP_FORCE_PIL_DECODE=1`` or when the library was built without
    libjpeg (the caller decodes with PIL). Blobs that fail to decode are
    zero-filled with a warning."""
    if os.environ.get("CSTP_FORCE_PIL_DECODE", "") == "1":
        _announce_decode_path(native=False)
        return None
    lib = load_native_lib()
    if not lib.cstp_has_jpeg():
        _announce_decode_path(native=False, why="the native reader was "
                              "built without libjpeg (no jpeglib.h)")
        return None
    _announce_decode_path(native=True)
    n = len(blobs)
    h, w = out_hw
    out = np.empty((n, h, w, 3), np.uint8)
    if n == 0:
        return out
    ptrs = (ctypes.c_void_p * n)(
        *[ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p) for b in blobs])
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    errs = lib.cstp_decode_blobs(ptrs, lens, n, h, w, out.reshape(-1),
                                 n_threads)
    if errs:
        warnings.warn(f"{errs} JPEG blob decode errors (zero-filled)")
    return out


class NativePackedDataset:
    """A CSTPack shard read by the C++ reader: the reader protocol
    (``num_videos``, ``video_meta``, ``read_frames``) and ``read_clips``, the
    loaders' batched path (one native call a batch). A frame that fails to
    decode, or an index out of range, comes back zero-filled with a
    warning. A library built without libjpeg refuses a shard that holds
    JPEG videos (:class:`NoJpegDecoder`)."""

    def __init__(self, path: str, ingest_hw: Tuple[int, int] = (128, 171),
                 n_threads: int = 8):
        lib = load_native_lib()
        self._lib = lib
        self._h = lib.cstpack_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open CSTPack shard {path!r}")
        n_jpeg = lib.cstpack_jpeg_videos(self._h)
        if n_jpeg and not lib.cstp_has_jpeg():
            self.close()
            raise NoJpegDecoder(
                f"the native CSTPack reader was built without libjpeg (g++ "
                f"found no jpeglib.h) and {path!r} holds {n_jpeg} JPEG "
                f"videos")
        self.h0, self.w0 = ingest_hw
        self.n_threads = n_threads
        self._n = lib.cstpack_num_videos(self._h)
        _announce_reader(n_threads)

    def num_videos(self) -> int:
        return self._n

    def video_meta(self, i: int) -> Tuple[int, int]:
        if not 0 <= i < self._n:
            raise IndexError(f"video {i} of {self._n}")
        nf = ctypes.c_int()
        lb = ctypes.c_int()
        self._lib.cstpack_meta(self._h, i, ctypes.byref(nf), ctypes.byref(lb))
        return nf.value, lb.value

    def read_frames(self, i: int, indices: Sequence[int]) -> np.ndarray:
        return self.read_clips(np.asarray([i], np.int32),
                               np.asarray(indices, np.int32)[None, :])[0]

    def read_clips(self, vids: np.ndarray, indices: np.ndarray) -> np.ndarray:
        """``(B,)`` video ids and ``(B, L)`` frame indices -> ``(B, L, H0,
        W0, 3)`` uint8, decoded and resized by the native pool in one
        call."""
        if not self._h:
            raise ValueError("read from a closed NativePackedDataset")
        vids = np.ascontiguousarray(vids, np.int32)
        indices = np.ascontiguousarray(indices, np.int32)
        b, l = indices.shape
        if vids.shape != (b,):
            raise ValueError(f"vids {vids.shape} for indices {indices.shape}")
        out = np.empty((b, l, self.h0, self.w0, 3), np.uint8)
        errs = self._lib.cstpack_read_batch(
            self._h, vids, indices.reshape(-1), b, l, self.h0, self.w0,
            out.reshape(-1), self.n_threads)
        if errs:
            warnings.warn(f"{errs} frame decode errors (zero-filled)")
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.cstpack_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
