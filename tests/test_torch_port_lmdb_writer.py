"""The port's LMDB writers (``data/lmdb_store.py``: ``write_lmdb`` and the
copy-on-write ``LMDBEnv``) against the JAX package's, on the CPU.

Held byte for byte: the files ``write_lmdb`` writes (small values,
overflow values, a multi-level tree, a subdir environment), and the file
after every commit of the ``LMDBEnv`` sequences of ``tests/test_lmdb.py``
(copy on write, splits with freelist reuse, overflow update and delete,
reopen and append, the reference tooling's write pattern, freelist chunks
larger than a node), with an abort among them. Each package's reader reads
the other's files.
"""

import os
import shutil

import msgpack
import numpy as np
import pytest

from cstp_tpu.data import lmdb_store as jstore
from cstp_tpu_torch.data import lmdb_store as pstore

from _torch_threads import torch_threads  # noqa: F401


@pytest.fixture
def tmp_path(tmp_path):
    """The test's own directory, removed when the test ends, passed or
    failed: its checkpoints, .pth files and CLI outputs are read back
    inside the test, and left behind they would fill the disk over a
    whole run of the suite."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _bytes(rng, n):
    return bytes(rng.integers(0, 256, n, dtype=np.uint8))


def _items(case):
    rng = np.random.default_rng(11)
    if case == "small":
        items = {b"key%03d" % i: _bytes(rng, 40) for i in range(20)}
        items[b"__meta__"] = b"hello"
        return items
    if case == "overflow":
        return {b"%09d" % i: _bytes(rng, n) for i, n in
                enumerate([10, 3000, 5000, 100_000, 4080, 4081])}
    if case in ("multilevel", "subdir"):
        return {b"%09d" % i: b"v" * int(rng.integers(1, 200))
                for i in range(2000 if case == "multilevel" else 50)}
    raise AssertionError(case)


def _data_file(path):
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


@pytest.mark.parametrize("case", ["small", "overflow", "multilevel",
                                  "subdir"])
def test_write_lmdb_writes_the_jax_bytes(case, tmp_path):
    items = _items(case)
    subdir = case == "subdir"
    name = "env" if subdir else "db.mdb"
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jpath = jstore.write_lmdb(str(tmp_path / "j" / name), items,
                              subdir=subdir)
    ppath = pstore.write_lmdb(str(tmp_path / "p" / name), items,
                              subdir=subdir)
    assert os.path.basename(ppath) == os.path.basename(jpath)
    with open(jpath, "rb") as f:
        want = f.read()
    with open(ppath, "rb") as f:
        assert f.read() == want
    # each package reads the other's file, by directory for the subdir env
    for reader, path in ((pstore.LMDBReader, jpath),
                         (jstore.LMDBReader, ppath)):
        db = reader(os.path.dirname(path) if subdir else path)
        assert dict(db.items()) == items and len(db) == len(items)
        if case == "multilevel":
            assert db.main.depth >= 2
        db.close()


# -------------------------------------------------- LMDBEnv sequences
# Each sequence drives one package's LMDBEnv with data from its own seeded
# generator and calls snap() after every commit or abort.

def _seq_basic_cow(store, path, snap):
    env = store.LMDBEnv(path)
    txn = env.begin()
    for i in (3, 1, 2):
        txn.put(b"%09d" % i, b"val%d" % i)
    txn.commit()
    snap()
    txn = env.begin()
    txn.put(b"%09d" % 0, b"front")
    txn.put(b"%09d" % 2, b"replaced")
    txn.commit()
    snap()
    txn = env.begin()
    txn.put(b"%09d" % 9, b"never")
    txn.abort()
    snap()
    env.close()


def _seq_splits_freelist_reuse(store, path, snap):
    rng = np.random.default_rng(3)
    keys = list(range(600))
    rng.shuffle(keys)
    env = store.LMDBEnv(path)
    for start in range(0, len(keys), 40):
        txn = env.begin()
        for i in keys[start:start + 40]:
            txn.put(b"%09d" % i, _bytes(rng, int(rng.integers(20, 120))))
        txn.commit()
        snap()
    assert env.free_entries
    env.close()


def _seq_overflow_update_delete(store, path, snap):
    rng = np.random.default_rng(5)
    env = store.LMDBEnv(path)
    txn = env.begin()
    txn.put(b"big", _bytes(rng, 30_000))
    txn.put(b"small", b"s")
    txn.commit()
    snap()
    txn = env.begin()
    txn.put(b"big", _bytes(rng, 50_000))
    txn.delete(b"small")
    txn.commit()
    snap()
    env.close()


def _seq_reopen_and_append(store, path, snap):
    env = store.LMDBEnv(path)
    txn = env.begin()
    for i in range(50):
        txn.put(b"%09d" % i, b"a" * 50)
    txn.commit()
    snap()
    env.close()
    env = store.LMDBEnv(path)
    txn = env.begin()
    for i in range(50, 100):
        txn.put(b"%09d" % i, b"b" * 50)
    txn.put(b"%09d" % 3, b"updated")
    txn.commit()
    snap()
    env.close()


def _seq_reference_write_pattern(store, path, snap):
    """Shuffled '%09d' video ids, msgpack'd lists of JPEG-sized blobs, one
    commit per action class, the meta keys in a last transaction, in a
    subdir environment."""
    rng = np.random.default_rng(0)
    names = [f"class{c}/video_{c}_{v}" for c in range(4) for v in range(3)]
    order = [names[int(i)] for i in rng.permutation(len(names))]
    vid = {n: i for i, n in enumerate(order)}
    env = store.LMDBEnv(path, subdir=True)
    keys = []
    for c in range(4):
        txn = env.begin()
        for v in range(3):
            key = b"%09d" % vid[f"class{c}/video_{c}_{v}"]
            txn.put(key, msgpack.dumps([_bytes(rng, int(rng.integers(
                500, 3000))) for _ in range(5)]))
            keys.append(key)
        txn.commit()
        snap()
    txn = env.begin()
    txn.put(b"__keys__", msgpack.dumps(keys))
    txn.put(b"__len__", msgpack.dumps(len(keys)))
    txn.put(b"__order__", msgpack.dumps(order))
    txn.put(b"__vlen__", msgpack.dumps([5] * len(keys)))
    txn.commit()
    snap()
    env.close()


def _seq_huge_freelist_chunks(store, path, snap):
    rng = np.random.default_rng(7)
    big = _bytes(rng, 40960)
    env = store.LMDBEnv(path)
    txn = env.begin()
    for i in range(80):
        txn.put(b"%09d" % i, big)
    txn.commit()
    snap()
    txn = env.begin()
    for i in range(80):
        txn.put(b"%09d" % i, b"small%d" % i)
    txn.commit()
    snap()
    env.close()
    env = store.LMDBEnv(path)
    assert sum(len(v) for v in env.free_entries.values()) > 800
    txn = env.begin()
    for i in range(300):
        txn.put(b"new%06d" % i, b"v%d" % i)
    txn.commit()
    snap()
    env.close()


SEQUENCES = {
    "basic_cow": _seq_basic_cow,
    "splits_freelist_reuse": _seq_splits_freelist_reuse,
    "overflow_update_delete": _seq_overflow_update_delete,
    "reopen_and_append": _seq_reopen_and_append,
    "reference_write_pattern": _seq_reference_write_pattern,
    "huge_freelist_chunks": _seq_huge_freelist_chunks,
}


def _run(store, seq, path):
    files = []

    def snap():
        with open(_data_file(path), "rb") as f:
            files.append(f.read())

    seq(store, path, snap)
    return files


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_lmdb_env_writes_the_jax_bytes_after_each_commit(name, tmp_path):
    seq = SEQUENCES[name]
    jpath, ppath = str(tmp_path / "jax.mdb"), str(tmp_path / "port.mdb")
    want = _run(jstore, seq, jpath)
    got = _run(pstore, seq, ppath)
    assert len(got) == len(want) >= 2
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name}: file differs after commit {k}"
    for reader, path in ((pstore.LMDBReader, jpath),
                         (jstore.LMDBReader, ppath)):
        a, b = reader(path), jstore.LMDBReader(jpath)
        assert list(a.items()) == list(b.items()) and len(a) == len(b)
        a.close()
        b.close()
