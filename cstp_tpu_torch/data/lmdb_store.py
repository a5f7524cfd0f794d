"""Dependency-free, read-only LMDB access for the reference's video shards:
the port's own copy of the reader half of the JAX package's
``data/lmdb_store.py``.

The reference stores Kinetics-400/UCF-101 as LMDB environments whose values
are msgpack'd lists of raw JPEG bytes, keyed ``b'%09d'`` by shuffled video id
with meta keys ``__keys__`` / ``__len__`` / ``__order__`` / ``__vlen__``.
:class:`LMDBReader` parses the on-disk B+tree directly (mmap): the dual meta
pages, branch pages down to leaves, overflow pages for big values (64-bit,
little-endian, default page layout). The writer stays in the JAX package.

Format reference: LMDB (OpenLDAP) mdb.c on-disk structs — MDB_page /
MDB_node / MDB_meta / MDB_db. All offsets below are the 64-bit layout.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02

F_BIGDATA = 0x01

PAGEHDRSZ = 16
_INVALID_PG = 0xFFFFFFFFFFFFFFFF

# MDB_db: md_pad u32, md_flags u16, md_depth u16, md_branch_pages u64,
# md_leaf_pages u64, md_overflow_pages u64, md_entries u64, md_root u64
_DB_FMT = "<IHHQQQQQ"
_DB_SIZE = struct.calcsize(_DB_FMT)  # 48
# MDB_meta: mm_magic u32, mm_version u32, mm_address u64, mm_mapsize u64,
# mm_dbs[2], mm_last_pg u64, mm_txnid u64
_META_HEAD = "<IIQQ"


class _Db:
    __slots__ = ("pad", "flags", "depth", "branch_pages", "leaf_pages",
                 "overflow_pages", "entries", "root")

    def __init__(self, raw: bytes):
        (self.pad, self.flags, self.depth, self.branch_pages, self.leaf_pages,
         self.overflow_pages, self.entries, self.root) = struct.unpack(
            _DB_FMT, raw)


class LMDBReader:
    """Read-only LMDB main-database accessor over an mmap.

    ``path`` may be the environment directory (containing ``data.mdb``, the
    ``subdir=True`` layout the reference uses) or the data file itself.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta0 = self._parse_meta(0)
        self.psize = meta0[0].pad  # mm_psize aliases mm_dbs[0].md_pad
        meta1 = self._parse_meta(self.psize)
        # live meta = larger txnid (mdb_env_pick_meta)
        self.main = meta1[1] if meta1[2] >= meta0[2] else meta0[1]

    def _parse_meta(self, off: int) -> Tuple[_Db, _Db, int]:
        # skip the 16-byte page header
        base = off + PAGEHDRSZ
        magic, version, _addr, _mapsize = struct.unpack_from(_META_HEAD,
                                                             self._mm, base)
        if magic != MDB_MAGIC:
            raise ValueError(f"not an LMDB file (magic {magic:#x})")
        if version != MDB_DATA_VERSION:
            raise ValueError(f"unsupported LMDB data version {version}")
        base += struct.calcsize(_META_HEAD)
        free_db = _Db(self._mm[base : base + _DB_SIZE])
        main_db = _Db(self._mm[base + _DB_SIZE : base + 2 * _DB_SIZE])
        _last_pg, txnid = struct.unpack_from("<QQ", self._mm,
                                             base + 2 * _DB_SIZE)
        return free_db, main_db, txnid

    # -- page parsing -------------------------------------------------------

    def _page(self, pgno: int) -> Tuple[int, int, int, int]:
        """Return (base_offset, flags, lower, upper) of page ``pgno``."""
        base = pgno * self.psize
        flags, lower, upper = struct.unpack_from("<HHH", self._mm, base + 10)
        return base, flags, lower, upper

    def _node(self, base: int, ptr: int) -> Tuple[int, int, int, int]:
        """Node at page ``base`` + ``ptr``: (lo, hi, flags, ksize)."""
        return struct.unpack_from("<HHHH", self._mm, base + ptr)

    def _numkeys(self, lower: int) -> int:
        return (lower - PAGEHDRSZ) >> 1

    def _ptrs(self, base: int, n: int) -> Tuple[int, ...]:
        return struct.unpack_from(f"<{n}H", self._mm, base + PAGEHDRSZ)

    def _key_at(self, base: int, ptr: int) -> bytes:
        _lo, _hi, _fl, ksize = self._node(base, ptr)
        return bytes(self._mm[base + ptr + 8 : base + ptr + 8 + ksize])

    def _leaf_value(self, base: int, ptr: int) -> bytes:
        lo, hi, fl, ksize = self._node(base, ptr)
        dsize = lo | (hi << 16)
        dstart = base + ptr + 8 + ksize
        if fl & F_BIGDATA:
            (ov_pgno,) = struct.unpack_from("<Q", self._mm, dstart)
            ov_base = ov_pgno * self.psize
            # overflow data runs contiguously from the first page's body
            return bytes(self._mm[ov_base + PAGEHDRSZ
                                  : ov_base + PAGEHDRSZ + dsize])
        return bytes(self._mm[dstart : dstart + dsize])

    # -- lookup -------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        if self.main.root == _INVALID_PG:
            return None
        pgno = self.main.root
        for _ in range(self.main.depth):
            base, flags, lower, _upper = self._page(pgno)
            n = self._numkeys(lower)
            ptrs = self._ptrs(base, n)
            if flags & P_BRANCH:
                # descend into the rightmost child whose key <= target;
                # node[0]'s key is ignored (acts as -inf)
                lo_i, hi_i = 1, n - 1
                child = 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    if self._key_at(base, ptrs[mid]) <= key:
                        child = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                nlo, nhi, nfl, _ks = self._node(base, ptrs[child])
                pgno = nlo | (nhi << 16) | (nfl << 32)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k = self._key_at(base, ptrs[mid])
                    if k == key:
                        return self._leaf_value(base, ptrs[mid])
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:  # pragma: no cover
                raise ValueError(f"unexpected page flags {flags:#x}")
        return None

    def __getitem__(self, key: bytes) -> bytes:
        v = self.get(key)
        if v is None:
            raise KeyError(key)
        return v

    def __len__(self) -> int:
        return self.main.entries

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order scan of the main DB (DFS; LMDB pages carry no sibling
        links, so iteration walks the tree)."""
        if self.main.root == _INVALID_PG:
            return
        yield from self._walk(self.main.root)

    def _walk(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        base, flags, lower, _upper = self._page(pgno)
        n = self._numkeys(lower)
        ptrs = self._ptrs(base, n)
        if flags & P_BRANCH:
            for ptr in ptrs:
                nlo, nhi, nfl, _ks = self._node(base, ptr)
                yield from self._walk(nlo | (nhi << 16) | (nfl << 32))
        elif flags & P_LEAF:
            for ptr in ptrs:
                yield self._key_at(base, ptr), self._leaf_value(base, ptr)

    def close(self):
        self._mm.close()
        self._f.close()
