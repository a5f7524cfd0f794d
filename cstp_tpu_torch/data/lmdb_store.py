"""Dependency-free LMDB access for the reference's video shards: the port's
own copy of the JAX package's ``data/lmdb_store.py``, writing the same bytes.

The reference stores Kinetics-400/UCF-101 as LMDB environments whose values
are msgpack'd lists of raw JPEG bytes, keyed ``b'%09d'`` by shuffled video id
with meta keys ``__keys__`` / ``__len__`` / ``__order__`` / ``__vlen__``.
The ``lmdb`` C binding is not a dependency, so this module implements the
LMDB on-disk B+tree format directly:

* :class:`LMDBReader` — read-only, mmap-based. Parses the dual meta pages,
  walks branch pages to leaves, follows overflow pages for big values
  (64-bit, little-endian, default page layout).
* :func:`write_lmdb` — a single-transaction writer producing a valid LMDB
  file (sorted bulk load, bottom-up B+tree). Used by the pack CLI.
* :class:`LMDBEnv` — an incremental copy-on-write writer with
  multi-transaction commits, page splits, a freelist and page reuse, for
  the reference tooling's write pattern (one commit per action class).

Format reference: LMDB (OpenLDAP) mdb.c on-disk structs — MDB_page /
MDB_node / MDB_meta / MDB_db. All offsets below are the 64-bit layout.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

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


def _even(n: int) -> int:
    return (n + 1) & ~1


def _max_inline_size(psize: int) -> int:
    """Inline-node cutoff: liblmdb's is roughly psize/2 minus overhead —
    anything bigger goes to overflow pages. Single-sourced so the bulk
    writer, the transactional writer, and the freelist chunker agree."""
    return (psize - PAGEHDRSZ) // 2 - 16


def _assemble_page(psize: int, pgno: int, flags: int,
                   node_bytes: List[bytes]) -> bytearray:
    """Assemble a branch/leaf page: ptr array at the front (key order),
    node bodies packed downward from the page end. The one place the
    on-disk page layout is encoded for BOTH writers."""
    buf = bytearray(psize)
    upper = psize
    ptrs = []
    for nb in node_bytes:
        upper -= _even(len(nb))
        buf[upper : upper + len(nb)] = nb
        ptrs.append(upper)
    lower = PAGEHDRSZ + 2 * len(node_bytes)
    assert lower <= upper, "page overflow"
    struct.pack_into("<QHHHH", buf, 0, pgno, 0, flags, lower, upper)
    struct.pack_into(f"<{len(ptrs)}H", buf, PAGEHDRSZ, *ptrs)
    return buf


def _overflow_blob(psize: int, ov_pgno: int, val: bytes) -> bytearray:
    """Encode a value as an F_BIGDATA overflow-page run starting at
    ``ov_pgno`` (header carries the page count)."""
    npages = (len(val) + PAGEHDRSZ + psize - 1) // psize
    blob = bytearray(npages * psize)
    struct.pack_into("<QHHI", blob, 0, ov_pgno, 0, P_OVERFLOW, npages)
    blob[PAGEHDRSZ : PAGEHDRSZ + len(val)] = val
    return blob


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


def write_lmdb(path: str, items: Dict[bytes, bytes],
               psize: int = 4096, subdir: bool = False) -> str:
    """Write ``items`` as a fresh single-txn LMDB environment.

    Sorted bulk load, bottom-up: values too large to inline go to overflow
    pages (F_BIGDATA), leaves pack sorted nodes, branch levels are built on
    top until a single root remains. Produces the same structures liblmdb
    itself would for a one-transaction load. Returns the data-file path.
    """
    if subdir:
        os.makedirs(path, exist_ok=True)
        data_path = os.path.join(path, "data.mdb")
    else:
        data_path = path
    entries = sorted(items.items())
    pages: Dict[int, bytes] = {}
    next_pg = 2
    stats = {"branch": 0, "leaf": 0, "overflow": 0}

    def alloc(n: int = 1) -> int:
        nonlocal next_pg
        p = next_pg
        next_pg += n
        return p

    def page_bytes(pgno: int, flags: int, nodes: List[bytes]) -> bytes:
        return bytes(_assemble_page(psize, pgno, flags, nodes))

    max_inline = _max_inline_size(psize)

    def leaf_node(key: bytes, val: bytes) -> bytes:
        if 8 + len(key) + len(val) > max_inline:
            npages = (len(val) + PAGEHDRSZ + psize - 1) // psize
            ov = alloc(npages)
            stats["overflow"] += npages
            pages[ov] = bytes(_overflow_blob(psize, ov, val))
            body = struct.pack("<HHHH", len(val) & 0xFFFF, len(val) >> 16,
                               F_BIGDATA, len(key)) + key + struct.pack("<Q", ov)
        else:
            body = struct.pack("<HHHH", len(val) & 0xFFFF, len(val) >> 16,
                               0, len(key)) + key + val
        return body

    def branch_node(key: bytes, child_pg: int) -> bytes:
        return struct.pack("<HHHH", child_pg & 0xFFFF,
                           (child_pg >> 16) & 0xFFFF,
                           (child_pg >> 32) & 0xFFFF, len(key)) + key

    # --- leaves ---
    level: List[Tuple[bytes, int]] = []  # (first_key, pgno)
    cap = psize - PAGEHDRSZ
    cur: List[bytes] = []
    cur_keys: List[bytes] = []
    cur_size = 0

    def flush_leaf():
        nonlocal cur, cur_keys, cur_size
        if not cur:
            return
        pg = alloc()
        stats["leaf"] += 1
        pages[pg] = page_bytes(pg, P_LEAF, cur)
        level.append((cur_keys[0], pg))
        cur, cur_keys, cur_size = [], [], 0

    for key, val in entries:
        node = leaf_node(key, val)
        cost = 2 + _even(len(node))
        if cur and cur_size + cost > cap:
            flush_leaf()
        cur.append(node)
        cur_keys.append(key)
        cur_size += cost
    flush_leaf()

    # --- branches, bottom-up ---
    depth = 1
    while len(level) > 1:
        depth += 1
        nxt: List[Tuple[bytes, int]] = []
        cur, cur_keys, cur_size = [], [], 0

        def flush_branch():
            nonlocal cur, cur_keys, cur_size
            if not cur:
                return
            pg = alloc()
            stats["branch"] += 1
            pages[pg] = page_bytes(pg, P_BRANCH, cur)
            nxt.append((cur_keys[0], pg))
            cur, cur_keys, cur_size = [], [], 0

        for key, child in level:
            node = branch_node(key, child)
            cost = 2 + _even(len(node))
            if cur and cur_size + cost > cap:
                flush_branch()
            cur.append(node)
            cur_keys.append(key)
            cur_size += cost
        flush_branch()
        level = nxt

    root = level[0][1] if level else _INVALID_PG
    if not entries:
        depth = 0

    last_pg = next_pg - 1
    file_size = (last_pg + 1) * psize

    def meta_page(pgno: int, txnid: int) -> bytes:
        buf = bytearray(psize)
        struct.pack_into("<QHHHH", buf, 0, pgno, 0, P_META, 0, 0)
        off = PAGEHDRSZ
        struct.pack_into(_META_HEAD, buf, off, MDB_MAGIC, MDB_DATA_VERSION,
                         0, max(file_size, 1 << 20))
        off += struct.calcsize(_META_HEAD)
        # free DB: empty (md_pad carries the env page size)
        struct.pack_into(_DB_FMT, buf, off, psize, 0x08, 0, 0, 0, 0, 0,
                         _INVALID_PG)
        off += _DB_SIZE
        # main DB
        struct.pack_into(_DB_FMT, buf, off, 0, 0, depth, stats["branch"],
                         stats["leaf"], stats["overflow"], len(entries), root)
        off += _DB_SIZE
        struct.pack_into("<QQ", buf, off, last_pg, txnid)
        return bytes(buf)

    with open(data_path, "wb") as f:
        f.write(meta_page(0, 0))
        f.write(meta_page(1, 1))
        # pages are allocated sequentially; a multi-page overflow blob is
        # stored once under its first pgno, so sorted order == file order
        for pg in sorted(pages):
            assert f.tell() == pg * psize, (f.tell(), pg)
            f.write(pages[pg])
    return data_path


# ---------------------------------------------------------------------------
# Incremental transactional writer (liblmdb's COW write algorithm)
# ---------------------------------------------------------------------------
#
# The reference builds its shards with a WRITE TRANSACTION PER ACTION CLASS
# over SHUFFLED keys — hundreds of incremental commits producing page
# splits, copy-on-write page turnover, freelist records, reused pages, and
# alternately-overwritten meta pages. `write_lmdb` above (sorted bulk load)
# produces none of those structures. liblmdb is not a dependency, so
# LMDBEnv implements the write algorithm per the on-disk spec:
#
# * copy-on-write: every page on the root->leaf path of a mutation is copied
#   to a freshly allocated page; the stale page is recorded as freed.
# * page allocation: reuse pages from committed freelist entries first
#   (oldest transaction first, like mdb_page_alloc with no active readers),
#   else extend the file.
# * freelist: FREE_DBI B+tree keyed by native u64 txnid, values in liblmdb's
#   IDL layout (leading u64 count, then page numbers, descending).
# * commit: dirty pages written in place, then the meta page at slot
#   (txnid % 2) is overwritten — exactly liblmdb's toggle; a crashed commit
#   leaves the previous meta live.
#
# The resulting files contain every structure class the bulk writer cannot
# emit.


def _parse_nodes(buf, flags):
    """Decode a branch/leaf page body -> list of dicts (insertion-ordered by
    key position)."""
    lower, upper = struct.unpack_from("<HH", buf, 12)
    n = (lower - PAGEHDRSZ) >> 1
    ptrs = struct.unpack_from(f"<{n}H", buf, PAGEHDRSZ)
    out = []
    for ptr in ptrs:
        lo, hi, fl, ksize = struct.unpack_from("<HHHH", buf, ptr)
        key = bytes(buf[ptr + 8 : ptr + 8 + ksize])
        if flags & P_BRANCH:
            out.append({"key": key, "child": lo | (hi << 16) | (fl << 32)})
        else:
            dsize = lo | (hi << 16)
            if fl & F_BIGDATA:
                (ov,) = struct.unpack_from("<Q", buf, ptr + 8 + ksize)
                out.append({"key": key, "ov": ov, "dsize": dsize})
            else:
                data = bytes(buf[ptr + 8 + ksize : ptr + 8 + ksize + dsize])
                out.append({"key": key, "data": data})
    return out


def _node_bytes(node, is_branch: bool) -> bytes:
    key = node["key"]
    if is_branch:
        c = node["child"]
        return struct.pack("<HHHH", c & 0xFFFF, (c >> 16) & 0xFFFF,
                           (c >> 32) & 0xFFFF, len(key)) + key
    if "ov" in node:
        d = node["dsize"]
        return (struct.pack("<HHHH", d & 0xFFFF, d >> 16, F_BIGDATA,
                            len(key)) + key + struct.pack("<Q", node["ov"]))
    d = len(node["data"])
    return (struct.pack("<HHHH", d & 0xFFFF, d >> 16, 0, len(key))
            + key + node["data"])


def _nodes_size(nodes, is_branch: bool) -> int:
    return sum(2 + _even(len(_node_bytes(n, is_branch))) for n in nodes)


class LMDBEnv:
    """Writable LMDB environment: incremental transactional puts with
    liblmdb COW/freelist/meta-toggle semantics (see module comment above).
    Single-writer, no concurrent readers (matching the offline shard-build
    use case, make_lmdb_kin.py)."""

    def __init__(self, path: str, psize: int = 4096, subdir: bool = False):
        if subdir:
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "data.mdb")
        elif os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "w+b" if fresh else "r+b")
        if fresh:
            self.psize = psize
            self.txnid = 1          # last committed
            self.last_pg = 1
            self.main = {"root": _INVALID_PG, "depth": 0, "entries": 0,
                         "branch": 0, "leaf": 0, "overflow": 0}
            self.free_entries = {}  # txnid -> [pgnos]
            self._f.write(self._meta_bytes(0, 0))
            self._f.write(self._meta_bytes(1, 1))
            self._f.flush()
        else:
            rd = LMDBReader(path)
            self.psize = rd.psize
            m0 = rd._parse_meta(0)
            m1 = rd._parse_meta(rd.psize)
            free_db, main_db, self.txnid = m1 if m1[2] >= m0[2] else m0
            base = (0 if (m0[2] >= m1[2]) else rd.psize) + PAGEHDRSZ + \
                struct.calcsize(_META_HEAD) + 2 * _DB_SIZE
            (self.last_pg, _) = struct.unpack_from("<QQ", rd._mm, base)
            self.main = {"root": main_db.root, "depth": main_db.depth,
                         "entries": main_db.entries,
                         "branch": main_db.branch_pages,
                         "leaf": main_db.leaf_pages,
                         "overflow": main_db.overflow_pages}
            self.free_entries = {}
            if free_db.root != _INVALID_PG:
                for k, v in rd._walk(free_db.root):
                    txn = struct.unpack("<Q", k)[0]
                    cnt = struct.unpack_from("<Q", v, 0)[0]
                    pgs = list(struct.unpack_from(f"<{cnt}Q", v, 8))
                    self.free_entries[txn] = pgs
            rd.close()

    # -- low-level page IO --------------------------------------------------

    def _read_page(self, pgno: int) -> bytes:
        self._f.seek(pgno * self.psize)
        return self._f.read(self.psize)

    def _meta_bytes(self, pgno: int, txnid: int,
                    free_db: Optional[dict] = None) -> bytes:
        buf = bytearray(self.psize)
        struct.pack_into("<QHHHH", buf, 0, pgno, 0, P_META, 0, 0)
        off = PAGEHDRSZ
        file_size = (self.last_pg + 1) * self.psize
        struct.pack_into(_META_HEAD, buf, off, MDB_MAGIC, MDB_DATA_VERSION,
                         0, max(file_size, 1 << 20))
        off += struct.calcsize(_META_HEAD)
        fd = free_db or {"root": _INVALID_PG, "depth": 0, "entries": 0,
                         "branch": 0, "leaf": 0, "overflow": 0}
        struct.pack_into(_DB_FMT, buf, off, self.psize, 0x08, fd["depth"],
                         fd["branch"], fd["leaf"], fd["overflow"],
                         fd["entries"], fd["root"])
        off += _DB_SIZE
        m = self.main
        struct.pack_into(_DB_FMT, buf, off, 0, 0, m["depth"], m["branch"],
                         m["leaf"], m["overflow"], m["entries"], m["root"])
        off += _DB_SIZE
        struct.pack_into("<QQ", buf, off, self.last_pg, txnid)
        return bytes(buf)

    def begin(self) -> "_WriteTxn":
        return _WriteTxn(self)

    def close(self):
        self._f.close()


class _WriteTxn:
    """One write transaction. ``put``/``delete`` then ``commit`` (or
    ``abort`` to drop everything — stale dirty pages beyond old last_pg are
    simply never referenced, like liblmdb)."""

    def __init__(self, env: LMDBEnv):
        self.env = env
        self.txnid = env.txnid + 1
        self.dirty = {}            # pgno -> bytearray (full page images)
        self.freed = []            # pgnos freed by this txn (stale copies)
        self.consumed = []         # freelist txn keys fully consumed
        self.reuse_pool = []       # flattened reusable pgnos
        for t in sorted(env.free_entries):
            self.reuse_pool.extend(env.free_entries[t])
            self.consumed.append(t)
        self.last_pg = env.last_pg
        self.main = dict(env.main)
        self.done = False

    # -- allocation ---------------------------------------------------------

    def _alloc(self, n: int = 1, from_reuse: bool = True) -> int:
        if from_reuse and n == 1 and self.reuse_pool:
            return self.reuse_pool.pop(0)
        # multi-page (overflow) runs and free-DB pages extend the file
        pg = self.last_pg + 1
        self.last_pg += n
        return pg

    def _page(self, pgno: int) -> bytes:
        d = self.dirty.get(pgno)
        return bytes(d) if d is not None else self.env._read_page(pgno)

    def _write_nodes(self, pgno: int, flags: int, nodes) -> None:
        is_branch = bool(flags & P_BRANCH)
        self.dirty[pgno] = _assemble_page(
            self.env.psize, pgno, flags,
            [_node_bytes(n, is_branch) for n in nodes])

    def _touch(self, pgno: int) -> int:
        """COW: pages created before this txn are copied to a new pgno and
        the old page is freed; this-txn pages mutate in place."""
        if pgno in self.dirty:
            return pgno
        new = self._alloc()
        self.dirty[new] = bytearray(self.env._read_page(pgno))
        struct.pack_into("<Q", self.dirty[new], 0, new)
        self.freed.append(pgno)
        return new

    # -- B+tree mutation ----------------------------------------------------

    def _max_inline(self) -> int:
        return _max_inline_size(self.env.psize)

    def _make_leaf_node(self, key: bytes, val: bytes) -> dict:
        psize = self.env.psize
        if 8 + len(key) + len(val) > self._max_inline():
            npg = (len(val) + PAGEHDRSZ + psize - 1) // psize
            ov = self._alloc(npg, from_reuse=False)
            blob = _overflow_blob(psize, ov, val)
            for i in range(npg):
                self.dirty[ov + i] = blob[i * psize : (i + 1) * psize]
            self.main["overflow"] += npg
            return {"key": key, "ov": ov, "dsize": len(val)}
        return {"key": key, "data": val}

    def _free_node_storage(self, node) -> None:
        if "ov" in node:
            npg = (node["dsize"] + PAGEHDRSZ + self.env.psize - 1) \
                // self.env.psize
            for i in range(npg):
                self.freed.append(node["ov"] + i)
            self.main["overflow"] -= npg

    def put(self, key: bytes, val: bytes) -> bool:
        assert not self.done
        if self.main["root"] == _INVALID_PG:
            root = self._alloc()
            self._write_nodes(root, P_LEAF,
                              [self._make_leaf_node(key, val)])
            self.main.update(root=root, depth=1, entries=1, leaf=1)
            return True
        # descend, recording the path for COW + split propagation
        path = []  # (pgno, index_into_nodes, nodes, flags)
        pgno = self.main["root"]
        for _ in range(self.main["depth"]):
            raw = self._page(pgno)
            flags = struct.unpack_from("<H", raw, 10)[0]
            nodes = _parse_nodes(raw, flags)
            if flags & P_BRANCH:
                i = 0
                for j in range(1, len(nodes)):
                    if nodes[j]["key"] <= key:
                        i = j
                    else:
                        break
                path.append((pgno, i, nodes, flags))
                pgno = nodes[i]["child"]
            else:
                path.append((pgno, None, nodes, flags))
                break
        # leaf insert/replace
        leaf_pg, _, nodes, _fl = path[-1]
        keys = [n["key"] for n in nodes]
        new_node = self._make_leaf_node(key, val)
        import bisect

        i = bisect.bisect_left(keys, key)
        if i < len(keys) and keys[i] == key:
            self._free_node_storage(nodes[i])
            nodes[i] = new_node
            added = 0
        else:
            nodes.insert(i, new_node)
            added = 1
        self.main["entries"] += added
        self._replace_up(path, nodes, P_LEAF)
        return True

    def delete(self, key: bytes) -> bool:
        assert not self.done
        if self.main["root"] == _INVALID_PG:
            return False
        path = []
        pgno = self.main["root"]
        for _ in range(self.main["depth"]):
            raw = self._page(pgno)
            flags = struct.unpack_from("<H", raw, 10)[0]
            nodes = _parse_nodes(raw, flags)
            if flags & P_BRANCH:
                i = 0
                for j in range(1, len(nodes)):
                    if nodes[j]["key"] <= key:
                        i = j
                    else:
                        break
                path.append((pgno, i, nodes, flags))
                pgno = nodes[i]["child"]
            else:
                path.append((pgno, None, nodes, flags))
                break
        leaf_pg, _, nodes, _fl = path[-1]
        idx = next((j for j, n in enumerate(nodes) if n["key"] == key), None)
        if idx is None:
            return False
        self._free_node_storage(nodes[idx])
        del nodes[idx]
        self.main["entries"] -= 1
        if not nodes and len(path) == 1:
            # last entry of a single-leaf tree: back to the empty DB
            self.freed.append(path[0][0])
            self.main.update(root=_INVALID_PG, depth=0, leaf=0)
            return True
        # liblmdb rebalances under-filled pages; leaving them valid-but-thin
        # is within format (and a structure the reader must tolerate) —
        # including a fully empty leaf under a branch
        self._replace_up(path, nodes, P_LEAF)
        return True

    def _replace_up(self, path, nodes, leaf_flags) -> None:
        """Write the mutated node list back along the recorded path, COWing
        every ancestor and splitting pages that overflow (split separators
        propagate upward; a root split adds a level — mdb_page_split)."""
        level_nodes = nodes
        level_flags = leaf_flags
        child_updates = None  # list of (first_key, pgno) replacing one slot
        for pgno, idx, pnodes, pflags in reversed(path):
            if child_updates is not None:
                # splice child split results into this branch page
                lead_key = pnodes[idx]["key"]
                repl = [{"key": (lead_key if j == 0 else k), "child": c}
                        for j, (k, c) in enumerate(child_updates)]
                pnodes[idx : idx + 1] = repl
                level_nodes, level_flags = pnodes, pflags
            pieces = self._split_if_needed(level_nodes, level_flags)
            new_pg = self._touch(pgno)
            if len(pieces) == 1:
                self._write_nodes(new_pg, level_flags, pieces[0])
                first = pieces[0][0]["key"] if pieces[0] else b""
                child_updates = [(first, new_pg)]
            else:
                is_leaf = bool(level_flags & P_LEAF)
                self.main["leaf" if is_leaf else "branch"] += len(pieces) - 1
                pgs = [new_pg] + [self._alloc()
                                  for _ in range(len(pieces) - 1)]
                for pg, piece in zip(pgs, pieces):
                    self._write_nodes(pg, level_flags, piece)
                child_updates = [(p[0]["key"], pg)
                                 for pg, p in zip(pgs, pieces)]
        # root handling
        if len(child_updates) == 1:
            self.main["root"] = child_updates[0][1]
        else:
            root = self._alloc()
            self._write_nodes(
                root, P_BRANCH,
                [{"key": k, "child": c} for k, c in child_updates])
            self.main["root"] = root
            self.main["depth"] += 1
            self.main["branch"] += 1

    def _split_if_needed(self, nodes, flags):
        cap = self.env.psize - PAGEHDRSZ
        is_branch = bool(flags & P_BRANCH)
        if _nodes_size(nodes, is_branch) <= cap:
            return [nodes]
        # greedy half-fill split (liblmdb splits at the size midpoint); may
        # cascade into >2 pieces for pathological node sizes
        pieces, cur, size = [], [], 0
        target = _nodes_size(nodes, is_branch) // 2 + 1
        for n in nodes:
            c = 2 + _even(len(_node_bytes(n, is_branch)))
            if cur and (size + c > cap or (len(pieces) == 0
                                           and size >= target)):
                pieces.append(cur)
                cur, size = [], 0
            cur.append(n)
            size += c
        pieces.append(cur)
        return pieces

    # -- commit -------------------------------------------------------------

    def commit(self) -> None:
        assert not self.done
        self.done = True
        env = self.env
        # freelist bookkeeping: consumed entries vanish; unused reusable
        # pages return under their ORIGINAL txns? liblmdb re-records leftover
        # pages under me_pghead; simplest valid equivalent: leftovers + this
        # txn's freed pages are recorded under this txnid.
        for t in self.consumed:
            env.free_entries.pop(t, None)
        freed_now = sorted(set(self.freed) | set(self.reuse_pool),
                           reverse=True)
        # old free-DB pages are rewritten every commit; since we rebuild the
        # free DB from scratch below, its previous pages are freed too — but
        # we cannot know them without tracking: track via env._free_db_pages
        freed_now = sorted(set(freed_now)
                           | set(getattr(env, "_free_db_pages", [])),
                           reverse=True)
        if freed_now:
            env.free_entries[self.txnid] = freed_now
        # rebuild FREE_DBI as a fresh bulk tree (extend-only allocation to
        # break the alloc/free circularity; liblmdb iterates instead)
        free_db = {"root": _INVALID_PG, "depth": 0, "entries": 0,
                   "branch": 0, "leaf": 0, "overflow": 0}
        fpages = []
        if env.free_entries:
            # liblmdb caps each freelist node at the inline-node limit and
            # saves long IDLs as multiple chunks under adjacent txnid keys
            # (mdb_freelist_save); mirror that so one txn freeing hundreds+
            # of pages (bulk deletes, large-value overwrites) never
            # overflows a leaf node in _write_nodes. Chunk keys only need
            # to be unique within this rebuild — the whole free DB is
            # consumed and rewritten by the next commit.
            max_pgs = max((self._max_inline() - 24) // 8, 1)
            used = set()

            def chunk_keys(t):
                k = t
                while k >= 1:
                    if k not in used:
                        yield k
                    k -= 1
                k = t + 1
                while True:
                    if k not in used:
                        yield k
                    k += 1

            keyed = []
            for t in sorted(env.free_entries):
                pgs = env.free_entries[t]
                chunks = [pgs[i : i + max_pgs]
                          for i in range(0, len(pgs), max_pgs)] or [pgs]
                for ch, key in zip(chunks, chunk_keys(t)):
                    used.add(key)
                    keyed.append((key, ch))
            # FREE_DBI is MDB_INTEGERKEY: native-integer key order
            items = [(struct.pack("<Q", k),
                      struct.pack(f"<{len(ch) + 1}Q", len(ch), *ch))
                     for k, ch in sorted(keyed)]
            # single leaf is nearly always enough (few hundred txns); build
            # multi-leaf + one branch level if not
            cap = env.psize - PAGEHDRSZ
            leaves, cur, size = [], [], 0
            for k, v in items:
                node = {"key": k, "data": v}
                c = 2 + _even(len(_node_bytes(node, False)))
                if cur and size + c > cap:
                    leaves.append(cur)
                    cur, size = [], 0
                cur.append(node)
                size += c
            leaves.append(cur)
            pgs = []
            for piece in leaves:
                pg = self._alloc(from_reuse=False)
                fpages.append(pg)
                self._write_nodes(pg, P_LEAF, piece)
                pgs.append((piece[0]["key"], pg))
            if len(pgs) == 1:
                free_db.update(root=pgs[0][1], depth=1, leaf=1,
                               entries=len(items))
            else:
                root = self._alloc(from_reuse=False)
                fpages.append(root)
                self._write_nodes(root, P_BRANCH,
                                  [{"key": k, "child": p} for k, p in pgs])
                free_db.update(root=root, depth=2, leaf=len(pgs), branch=1,
                               entries=len(items))
        env._free_db_pages = fpages
        # write dirty pages, then toggle the meta slot (txnid % 2)
        env.last_pg = self.last_pg
        env.main = self.main
        f = env._f
        for pg in sorted(self.dirty):
            f.seek(pg * env.psize)
            f.write(bytes(self.dirty[pg]))
        f.flush()
        os.fsync(f.fileno())
        slot = self.txnid % 2
        f.seek(slot * env.psize)
        f.write(env._meta_bytes(slot, self.txnid, free_db))
        f.flush()
        os.fsync(f.fileno())
        env.txnid = self.txnid

    def abort(self) -> None:
        self.done = True
