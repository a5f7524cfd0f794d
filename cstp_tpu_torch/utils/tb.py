"""Dependency-free TensorBoard scalar writer (``--tb_dir``): the port's own
copy of the JAX package's ``utils/tb.py`` (the same records).

The CSV epoch logs stay the parity format (train/meters.py); this adds live
TensorBoard curves without importing tensorboard: an events file is just
TFRecord-framed ``Event`` protobufs, and the three messages involved
(Event, Summary, Summary.Value with ``simple_value``) are hand-encoded:

* TFRecord frame: u64-LE length, masked-crc32c(length), payload,
  masked-crc32c(payload); mask(c) = ((c>>15 | c<<17) + 0xa282ead8) mod 2^32.
* Event: field 1 ``wall_time`` (double), 2 ``step`` (int64),
  3 ``file_version`` (string, first record only), 5 ``summary`` (message).
* Summary: repeated field 1 ``value``; Value: field 1 ``tag`` (string),
  field 2 ``simple_value`` (float).
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

from cstp_tpu_torch.parallel.mesh import is_main

# -- crc32c (Castagnoli, reflected poly 0x82F63B78), table-driven ------------

_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ _TABLE[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding ------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3) + _varint(val)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    msg = _field_double(1, wall_time)
    if step:
        msg += _field_varint(2, step)
    if file_version:
        msg += _field_bytes(3, file_version.encode())
    if summary:
        msg += _field_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, val)


class TBWriter:
    """Append-only scalar event writer; one events file per instance."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}{filename_suffix}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._write(_event(time.time(), step=int(step),
                           summary=_scalar_summary(tag, value)))

    def add_scalars(self, scalars: dict, step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            if v is None:
                continue
            self.add_scalar(prefix + k, v, step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def maybe_tb_writer(tb_dir: str, sub: str = "") -> Optional[TBWriter]:
    """Writer factory; '' disables (the default). Under a process group
    only rank 0 writes (the JAX package's process 0)."""
    if not tb_dir or not is_main():
        return None
    return TBWriter(os.path.join(tb_dir, sub) if sub else tb_dir)
