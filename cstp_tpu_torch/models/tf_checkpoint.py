"""A reader of TensorFlow V2 checkpoints (a tensor bundle) with numpy and the
standard library alone: what ``tf.train.load_checkpoint`` reads for the
kinetics-i3d importer (``models/i3d_tf_import.py``), without TensorFlow or
protobuf.

A V2 checkpoint ``<prefix>`` is two kinds of file:

* ``<prefix>.index``: an SSTable (LevelDB's table format). Its 48-byte
  footer holds the meta-index and index block handles (varints) and ends in
  the magic ``0xdb4775248b80fb57``; the index block maps separator keys to
  data block handles; each block holds prefix-compressed entries, a restart
  array and its count, then a 5-byte trailer (compression type, masked
  crc32c). The key ``""`` holds a ``BundleHeaderProto`` (shard count, byte
  order); every other key is a tensor name whose value is a
  ``BundleEntryProto`` (dtype = 1, shape = 2, shard_id = 3, offset = 4,
  size = 5, crc32c = 6, slices = 7).
* ``<prefix>.data-NNNNN-of-MMMMM``: the tensors' raw bytes, one shard per
  file, at the entry's offset.

The protobuf fields are decoded by hand. Refused with ``ValueError``, naming
what was found: a V1 checkpoint (no ``.index``), a bad footer, a compressed
block, a block or tensor whose crc32c does not match, a sliced entry, a
tensor whose bytes run past its shard, a big-endian bundle, and a dtype
other than float16/32/64 and int32/64 (strings, bfloat16, quantized
types).

    reader = load_checkpoint("rgb_imagenet/model.ckpt")
    w = reader.get_tensor("RGB/inception_i3d/Conv3d_1a_7x7/conv_3d/w")
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
HEADER_KEY = b""

# tensorflow DataType -> little-endian numpy type: the float variables of
# a model and an integer step counter
DTYPES = {1: "<f4", 2: "<f8", 3: "<i4", 9: "<i8", 19: "<f2"}


# ------------------------------------------------------------------ crc32c

def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table[i] = c
    return table


_CRC_TABLE = _crc_table()
_CRC_LIST = [int(v) for v in _CRC_TABLE]


def _crc_bytes(reg: int, data) -> int:
    for b in data:
        reg = _CRC_LIST[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _shift_tables(n: int) -> List[List[int]]:
    """Four byte tables of the linear map "run ``n`` zero bytes through the
    crc register": ``shift(r) = T0[r & 255] ^ T1[r >> 8 & 255] ^ ...``."""
    regs = np.concatenate([np.arange(256, dtype=np.uint32) << (8 * k)
                           for k in range(4)])
    for _ in range(n):
        regs = _CRC_TABLE[regs & 0xFF] ^ (regs >> 8)
    return [[int(v) for v in regs[256 * k:256 * (k + 1)]] for k in range(4)]


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data`` (bytes or a uint8 array). Long
    inputs run as many equal chunks in parallel (numpy), joined with the
    zero-byte shift map, since the crc register is linear over GF(2)."""
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data.reshape(-1).view(np.uint8)
    lanes = min(1 << 16, len(a) // 256)
    reg = 0xFFFFFFFF
    if lanes < 16:
        return _crc_bytes(reg, a.tolist()) ^ 0xFFFFFFFF
    n = len(a) // lanes
    columns = np.ascontiguousarray(a[:lanes * n].reshape(lanes, n).T)
    part = np.zeros(lanes, np.uint32)
    for col in columns:
        part = _CRC_TABLE[(part ^ col) & 0xFF] ^ (part >> 8)
    t0, t1, t2, t3 = _shift_tables(n)
    for p in part.tolist():
        reg = (t0[reg & 0xFF] ^ t1[(reg >> 8) & 0xFF]
               ^ t2[(reg >> 16) & 0xFF] ^ t3[reg >> 24]) ^ p
    return _crc_bytes(reg, a[lanes * n:].tolist()) ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    """The masked form LevelDB and TensorFlow store."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) \
        & 0xFFFFFFFF


# ------------------------------------------------------------------ decoding

def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """``(value, next position)`` of the base-128 varint at ``pos``."""
    out = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def proto_fields(buf: bytes) -> List[Tuple[int, int, object]]:
    """``(field number, wire type, value)`` of each field of a protobuf
    message: an int for varint and fixed-width fields, bytes for
    length-delimited ones."""
    out, pos = [], 0
    while pos < len(buf):
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = read_varint(buf, pos)
        elif wire == 1:
            val, = struct.unpack_from("<Q", buf, pos)
            pos += 8
        elif wire == 2:
            n, pos = read_varint(buf, pos)
            val = bytes(buf[pos:pos + n])
            pos += n
        elif wire == 5:
            val, = struct.unpack_from("<I", buf, pos)
            pos += 4
        else:
            raise ValueError(f"protobuf wire type {wire} (field {field})")
        out.append((field, wire, val))
    return out


def block_entries(block: bytes) -> List[Tuple[bytes, bytes]]:
    """``(key, value)`` of every entry of one SSTable block (prefix
    compression undone)."""
    if len(block) < 4:
        raise ValueError("SSTable block shorter than its restart count")
    n_restarts, = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise ValueError(f"SSTable block of {len(block)} bytes cannot hold "
                         f"{n_restarts} restarts")
    out, pos, key = [], 0, b""
    while pos < end:
        shared, pos = read_varint(block, pos)
        unshared, pos = read_varint(block, pos)
        vlen, pos = read_varint(block, pos)
        key = key[:shared] + bytes(block[pos:pos + unshared])
        pos += unshared
        out.append((key, bytes(block[pos:pos + vlen])))
        pos += vlen
    return out


def read_block(buf: bytes, handle: Tuple[int, int]) -> bytes:
    """The contents of the block at ``handle`` = (offset, size), its
    trailer checked: no compression, a matching crc32c."""
    off, size = handle
    if off + size + BLOCK_TRAILER_BYTES > len(buf):
        raise ValueError(f"SSTable block at {off} (+{size}) runs past the "
                         f"{len(buf)}-byte index file")
    kind = buf[off + size]
    if kind != 0:
        raise ValueError(f"SSTable block at {off} is compressed (type "
                         f"{kind}); only uncompressed blocks are read")
    want, = struct.unpack_from("<I", buf, off + size + 1)
    if mask_crc(crc32c(buf[off:off + size + 1])) != want:
        raise ValueError(f"SSTable block at {off}: crc32c mismatch")
    return buf[off:off + size]


def _handle(value: bytes, pos: int = 0) -> Tuple[Tuple[int, int], int]:
    off, pos = read_varint(value, pos)
    size, pos = read_varint(value, pos)
    return (off, size), pos


def read_table(path: str) -> Dict[bytes, bytes]:
    """Every ``key -> value`` of an uncompressed SSTable file."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < FOOTER_BYTES:
        raise ValueError(f"{path}: {len(buf)} bytes, shorter than an "
                         "SSTable footer")
    footer = buf[-FOOTER_BYTES:]
    lo, hi = struct.unpack_from("<II", footer, FOOTER_BYTES - 8)
    if (hi << 32 | lo) != TABLE_MAGIC:
        raise ValueError(f"{path}: not an SSTable (magic "
                         f"{hi << 32 | lo:#018x})")
    _, pos = _handle(footer)               # the meta-index: not needed
    index, _ = _handle(footer, pos)
    out = {}
    for _, value in block_entries(read_block(buf, index)):
        out.update(block_entries(read_block(buf, _handle(value)[0])))
    return out


# ------------------------------------------------------------------ bundle

def _entry(name: str, value: bytes) -> Dict:
    """A decoded ``BundleEntryProto``."""
    e = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0,
         "crc32c": None}
    for field, _, val in proto_fields(value):
        if field == 1:
            e["dtype"] = val
        elif field == 2:
            for f2, _, dim in proto_fields(val):
                if f2 == 2:
                    size = next((v for f3, _, v in proto_fields(dim)
                                 if f3 == 1), 0)
                    e["shape"].append(size - (1 << 64) if size >> 63
                                      else size)
                elif f2 == 3 and dim:
                    raise ValueError(f"{name}: shape of unknown rank")
        elif field == 3:
            e["shard_id"] = val
        elif field == 4:
            e["offset"] = val
        elif field == 5:
            e["size"] = val
        elif field == 6:
            e["crc32c"] = val
        elif field == 7:
            raise ValueError(f"{name}: a sliced (partitioned) entry; only "
                             "whole tensors are read")
    return e


class CheckpointReader:
    """The tensors of the V2 checkpoint ``prefix`` (the path without
    ``.index``), read on demand: ``get_tensor(name)`` (``KeyError`` for a
    name it lacks) and ``get_variable_to_shape_map``."""

    def __init__(self, prefix: str):
        index = prefix + ".index"
        if not os.path.isfile(index):
            what = ("a V1 checkpoint (one file, no .index)"
                    if os.path.isfile(prefix) else "no checkpoint")
            raise ValueError(f"{prefix}: {what}; only V2 checkpoints "
                             f"(<prefix>.index + <prefix>.data-*) are read")
        self.prefix = prefix
        table = read_table(index)
        header = table.pop(HEADER_KEY, b"")
        fields = {f: v for f, _, v in proto_fields(header)}
        self.num_shards = fields.get(1, 1)
        if fields.get(2, 0) != 0:
            raise ValueError(f"{prefix}: a big-endian bundle; only "
                             "little-endian ones are read")
        self.entries = {k.decode(): _entry(k.decode(), v)
                        for k, v in table.items()}

    def shard_path(self, shard_id: int) -> str:
        return f"{self.prefix}.data-{shard_id:05d}-of-{self.num_shards:05d}"

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {k: list(e["shape"]) for k, e in self.entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        if name not in self.entries:
            raise KeyError(f"{name} not in checkpoint {self.prefix}")
        e = self.entries[name]
        if e["dtype"] not in DTYPES:
            raise ValueError(f"{name}: tensorflow dtype {e['dtype']} is not "
                             f"read (only {sorted(DTYPES)})")
        dt = np.dtype(DTYPES[e["dtype"]])
        count = int(np.prod(e["shape"], dtype=np.int64))
        if count * dt.itemsize != e["size"]:
            raise ValueError(f"{name}: {e['size']} bytes for shape "
                             f"{e['shape']} of {dt}")
        path = self.shard_path(e["shard_id"])
        have = os.path.getsize(path)
        if e["offset"] + e["size"] > have:
            raise ValueError(f"{name}: bytes {e['offset']}..{e['offset'] + e['size']}"
                             f" run past its {have}-byte shard {path}")
        with open(path, "rb") as f:
            f.seek(e["offset"])
            raw = f.read(e["size"])
        if e["crc32c"] is not None and mask_crc(crc32c(raw)) != e["crc32c"]:
            raise ValueError(f"{name}: crc32c mismatch in {path}")
        return np.frombuffer(raw, dt).reshape(e["shape"]).copy()


def load_checkpoint(prefix: str) -> CheckpointReader:
    """``tf.train.load_checkpoint`` for a V2 checkpoint prefix."""
    return CheckpointReader(prefix)
