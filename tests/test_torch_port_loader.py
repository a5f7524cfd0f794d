"""The port's loaders and device prefetch against the JAX package's, on the
CPU.

``PretrainLoader`` and ``FinetuneLoader`` yield bitwise the JAX batches
(epochs 1 and 2, data echo 2, two processes, the padded and masked val
tail): on the per-clip path over the synthetic reader, and on the batched
``read_clips`` path over each package's C++ CSTPack reader (a shard of raw
and JPEG videos). On a raw shard at the stored size the batched path gives
the per-clip path's batches. ``prefetch_to_device`` on the CPU keeps the
order, reuses the landed tensors for an echoed batch and raises a loader
error again.
"""

import itertools
import shutil
import threading

import numpy as np
import pytest
import torch

from cstp_tpu.data import loader as jloader
from cstp_tpu.data import native_reader as jnative
from cstp_tpu.data.synthetic import SyntheticVideoDataset as JSynthetic
from cstp_tpu_torch.data import loader as ploader
from cstp_tpu_torch.data import native_reader as pnative
from cstp_tpu_torch.data.packed import PackedDataset, PackedWriter
from cstp_tpu_torch.data.synthetic import (
    SyntheticVideoDataset as PSynthetic,
)

from _torch_threads import torch_threads  # noqa: F401

T = 4


def _ds(mod, n=11):
    # short videos (min 8 frames) exercise the wrap-around clips
    return mod(n_videos=n, n_classes=5, ingest_hw=(12, 16), min_frames=8,
               max_frames=40)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """CSTPack files of ``_ds``'s 11 videos at their stored 12x16: "raw"
    all raw, "mixed" with videos 8..10 as JPEG."""
    import io

    from PIL import Image

    ds = _ds(PSynthetic)
    root = tmp_path_factory.mktemp("loader_shards")
    paths = {}
    for kind in ("raw", "mixed"):
        paths[kind] = str(root / f"{kind}.cstp")
        w = PackedWriter(paths[kind])
        for i in range(ds.num_videos()):
            nf, label = ds.video_meta(i)
            frames = ds.read_frames(i, range(nf))
            if kind == "mixed" and i >= 8:
                blobs = []
                for f in frames:
                    buf = io.BytesIO()
                    Image.fromarray(f).save(buf, format="JPEG", quality=90)
                    blobs.append(buf.getvalue())
                w.add_video(f"v{i}", label, blobs)
            else:
                w.add_video_raw(f"v{i}", label, frames)
        w.close()
    assert jnative.load_native_lib() is not None
    yield paths
    shutil.rmtree(root, ignore_errors=True)


def _native(mod, path):
    return mod.NativePackedDataset(path, ingest_hw=(12, 16), n_threads=3)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


PRETRAIN_GRID = [(1, 1, (0, 1)), (2, 1, (0, 1)), (1, 2, (0, 1)),
                 (2, 1, (1, 2))]
FINETUNE_GRID = [(1, True, None, (0, 1)), (2, True, None, (0, 1)),
                 (1, False, False, (0, 1)), (1, False, False, (1, 2)),
                 (2, True, None, (1, 2))]


@pytest.mark.parametrize("epoch,echo,proc", PRETRAIN_GRID)
def test_pretrain_loader_is_the_jax_loader(epoch, echo, proc):
    kw = dict(batch_size=3, sample_duration=T, seed=5, num_workers=2,
              process_index=proc[0], process_count=proc[1], echo=echo)
    jl = jloader.PretrainLoader(_ds(JSynthetic), **kw)
    pl = ploader.PretrainLoader(_ds(PSynthetic), **kw)
    want, got = list(jl.epoch(epoch)), list(pl.epoch(epoch))
    assert len(pl) == len(jl) == len(got)
    _assert_batches_equal(got, want)
    if echo > 1:   # an echo is the same host object
        assert got[0] is got[1]


@pytest.mark.parametrize("epoch,train,drop_last,proc", FINETUNE_GRID)
def test_finetune_loader_is_the_jax_loader(epoch, train, drop_last, proc):
    kw = dict(batch_size=4, sample_duration=T, pb_rate=2, train=train,
              seed=3, num_workers=2, drop_last=drop_last,
              process_index=proc[0], process_count=proc[1])
    jl = jloader.FinetuneLoader(_ds(JSynthetic), **kw)
    pl = ploader.FinetuneLoader(_ds(PSynthetic), **kw)
    want, got = list(jl.epoch(epoch)), list(pl.epoch(epoch))
    assert len(pl) == len(jl) == len(got)
    _assert_batches_equal(got, want)
    if not train:
        # the val tail is padded and masked: every video counts once
        assert got[-1]["mask"].sum() < len(got[-1]["mask"])
        n_shard = len(range(proc[0], 11, proc[1]))
        assert sum(float(b["mask"].sum()) for b in got) == n_shard


@pytest.mark.parametrize("epoch,echo,proc", PRETRAIN_GRID)
def test_pretrain_loader_native_is_the_jax_loader_native(shards, epoch, echo,
                                                         proc):
    kw = dict(batch_size=3, sample_duration=T, seed=5, num_workers=2,
              process_index=proc[0], process_count=proc[1], echo=echo)
    jl = jloader.PretrainLoader(_native(jnative, shards["mixed"]), **kw)
    pl = ploader.PretrainLoader(_native(pnative, shards["mixed"]), **kw)
    want, got = list(jl.epoch(epoch)), list(pl.epoch(epoch))
    assert len(pl) == len(jl) == len(got)
    _assert_batches_equal(got, want)
    # on the raw shard the batched path gives the per-clip path's batches
    raw = ploader.PretrainLoader(_native(pnative, shards["raw"]), **kw)
    per_clip = ploader.PretrainLoader(
        PackedDataset(shards["raw"], ingest_hw=(12, 16)), **kw)
    _assert_batches_equal(list(raw.epoch(epoch)),
                          list(per_clip.epoch(epoch)))


@pytest.mark.parametrize("epoch,train,drop_last,proc", FINETUNE_GRID)
def test_finetune_loader_native_is_the_jax_loader_native(
        shards, epoch, train, drop_last, proc):
    kw = dict(batch_size=4, sample_duration=T, pb_rate=2, train=train,
              seed=3, num_workers=2, drop_last=drop_last,
              process_index=proc[0], process_count=proc[1])
    jl = jloader.FinetuneLoader(_native(jnative, shards["mixed"]), **kw)
    pl = ploader.FinetuneLoader(_native(pnative, shards["mixed"]), **kw)
    want, got = list(jl.epoch(epoch)), list(pl.epoch(epoch))
    assert len(pl) == len(jl) == len(got)
    _assert_batches_equal(got, want)
    if not train:
        n_shard = len(range(proc[0], 11, proc[1]))
        assert sum(float(b["mask"].sum()) for b in got) == n_shard
    raw = ploader.FinetuneLoader(_native(pnative, shards["raw"]), **kw)
    per_clip = ploader.FinetuneLoader(
        PackedDataset(shards["raw"], ingest_hw=(12, 16)), **kw)
    _assert_batches_equal(list(raw.epoch(epoch)),
                          list(per_clip.epoch(epoch)))


def test_epoch_permutation_is_the_jax_permutation():
    for n, e, s, shuffle in itertools.product((1, 7, 50), (1, 2), (0, 3),
                                              (True, False)):
        np.testing.assert_array_equal(
            ploader._epoch_permutation(n, e, s, shuffle),
            jloader._epoch_permutation(n, e, s, shuffle))


def test_prefetch_keeps_order_and_reuses_echoed_tensors():
    pl = ploader.PretrainLoader(_ds(PSynthetic), 3, T, seed=5, echo=2)
    host = list(pl.epoch(1))
    got = list(ploader.prefetch_to_device(iter(host), "cpu", depth=2))
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert g.keys() == h.keys()
        for k in h:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), h[k])
    for a, b in zip(got[::2], got[1::2]):
        assert a is b                       # the same landed tensors
        assert all(a[k] is b[k] for k in a)
    assert got[0] is not got[2]


def test_prefetch_raises_the_loader_error():
    def bad():
        yield {"x": np.zeros(2)}
        raise OSError("disk went away")

    it = ploader.prefetch_to_device(bad(), "cpu")
    assert next(it)["x"].shape == (2,)
    with pytest.raises(OSError, match="disk went away"):
        next(it)


def test_prefetch_stops_its_thread_when_closed_early():
    """A consumer that stops early (steps_per_epoch) closes the prefetch,
    which ends its thread and closes the loader."""
    closed = threading.Event()

    def endless():
        try:
            for i in itertools.count():
                yield {"i": np.asarray([i])}
        finally:
            closed.set()

    before = threading.active_count()
    it = ploader.prefetch_to_device(endless(), "cpu", depth=2)
    assert [int(next(it)["i"][0]) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert closed.wait(10)
    assert threading.active_count() == before
