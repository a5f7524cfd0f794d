"""The port's C++ CSTPack reader (``cstp_tpu_torch/csrc/cstpack_reader.cc``,
bound by ``data/native_reader.py``) against the JAX package's, on the CPU.

Both libraries are built from their own copy of the source (the port's
with ``g++`` into ``build/cstp_tpu_torch/<fingerprint>/``, JAX's with
``make`` in ``native/``) and held bitwise: meta, raw and JPEG frames at the stored
size and resized, ``read_clips``, and ``decode_jpeg_blobs``. Against the
Python ``PackedDataset`` the bounds are JAX's own
(``tests/test_native_reader.py``): raw frames bitwise, JPEG frames at the
stored size mean |diff| < 2.0 (the same libjpeg decode, PIL's resize
against the fixed-point one) and resized mean |diff| < 6.0. The library
built without libjpeg serves raw shards bitwise and refuses JPEG shards.
"""

import ctypes
import io
import logging
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from cstp_tpu.data import native_reader as jnative
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.data import native_reader as pnative
from cstp_tpu_torch.data.packed import PackedDataset, PackedWriter
from cstp_tpu_torch.ops import build
from cstp_tpu_torch.train.loops import build_dataset

from _torch_threads import torch_threads  # noqa: F401

STORED = (48, 64)
N_RAW, N_JPEG, N_FRAMES = 4, 2, 10


@pytest.fixture
def tmp_path(tmp_path):
    """The test's own directory, removed when the test ends, passed or
    failed: its checkpoints, .pth files and CLI outputs are read back
    inside the test, and left behind they would fill the disk over a
    whole run of the suite."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _frames(seed, n=N_FRAMES, hw=STORED):
    """Smooth frames (a colour ramp plus noise), so bilinear resizes of the
    two filters stay close, as real frames do."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    base = (x[..., None] * rng.uniform(1, 3, 3) + y[..., None]
            * rng.uniform(1, 3, 3))
    out = base[None] + rng.normal(0, 8, (n, *hw, 3)) + 40 * np.arange(n)[
        :, None, None, None]
    return np.clip(out % 256, 0, 255).astype(np.uint8)


def _jpeg(frame, quality=95) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """Videos 0..3 raw at the stored size, 4..5 JPEG."""
    root = tmp_path_factory.mktemp("pack")
    path = str(root / "shard.cstp")
    w = PackedWriter(path)
    for i in range(N_RAW):
        w.add_video_raw(f"raw{i}", i % 3, _frames(i))
    for i in range(N_RAW, N_RAW + N_JPEG):
        w.add_video(f"jpg{i}", i % 3, [_jpeg(f) for f in _frames(i)])
    w.close()
    yield path
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_lib():
    lib = jnative.load_native_lib()
    assert lib is not None, "the JAX package's native reader did not build"
    return lib


def _clips(rng, n_videos, b=5, l=6):
    vids = rng.integers(0, n_videos, b).astype(np.int32)
    idx = rng.integers(0, N_FRAMES, (b, l)).astype(np.int32)
    idx[:, 2] = idx[:, 1]            # repeated frames (the cached copy)
    return vids, idx


@pytest.mark.parametrize("hw", [STORED, (24, 32), (37, 50)])
def test_native_reader_is_bitwise_the_jax_native_reader(shard, jax_lib, hw):
    j = jnative.NativePackedDataset(shard, ingest_hw=hw, n_threads=3)
    p = pnative.NativePackedDataset(shard, ingest_hw=hw, n_threads=3)
    assert p.num_videos() == j.num_videos() == N_RAW + N_JPEG
    for i in range(p.num_videos()):
        assert p.video_meta(i) == j.video_meta(i)
    vids, idx = _clips(np.random.default_rng(1), p.num_videos())
    got = p.read_clips(vids, idx)
    assert got.shape == (5, 6, *hw, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, j.read_clips(vids, idx))
    for v in (0, N_RAW):             # one raw and one JPEG video
        np.testing.assert_array_equal(p.read_frames(v, [9, 0, 0, 4]),
                                      j.read_frames(v, [9, 0, 0, 4]))
    p.close()
    j.close()


def test_native_reader_against_the_python_reader(shard):
    idx = [0, 3, 3, 9]
    nat = pnative.NativePackedDataset(shard, ingest_hw=STORED, n_threads=2)
    py = PackedDataset(shard, ingest_hw=STORED)
    for i in range(N_RAW):
        assert nat.video_meta(i) == py.video_meta(i)
        np.testing.assert_array_equal(nat.read_frames(i, idx),
                                      py.read_frames(i, idx))
    for i in range(N_RAW, N_RAW + N_JPEG):
        d = np.abs(nat.read_frames(i, idx).astype(int)
                   - py.read_frames(i, idx).astype(int))
        assert d.mean() < 2.0, d.mean()
    small = pnative.NativePackedDataset(shard, ingest_hw=(24, 32))
    d = np.abs(small.read_frames(0, idx).astype(int)
               - PackedDataset(shard, ingest_hw=(24, 32)).read_frames(
                   0, idx).astype(int))
    assert d.mean() < 6.0, d.mean()


def test_read_clips_is_read_frames(shard):
    nat = pnative.NativePackedDataset(shard, ingest_hw=(32, 40), n_threads=4)
    vids, idx = _clips(np.random.default_rng(2), nat.num_videos(), b=7)
    out = nat.read_clips(vids, idx)
    for k in range(len(vids)):
        np.testing.assert_array_equal(out[k],
                                      nat.read_frames(int(vids[k]), idx[k]))


def test_corrupt_and_out_of_range_frames_zero_fill(tmp_path):
    good = _jpeg(_frames(7, n=1, hw=(32, 40))[0])
    bad = b"this is definitely not a jpeg bitstream" * 4
    path = str(tmp_path / "corrupt.cstp")
    w = PackedWriter(path)
    w.add_video("v0", 0, [good, bad, good])
    w.close()
    nat = pnative.NativePackedDataset(path, ingest_hw=(32, 40), n_threads=2)
    with pytest.warns(UserWarning, match="1 frame decode errors"):
        frames = nat.read_frames(0, [0, 1, 2])
    assert frames[1].max() == 0
    assert frames[0].std() > 1 and frames[2].std() > 1
    with pytest.warns(UserWarning, match="2 frame decode errors"):
        frames = nat.read_frames(0, [0, 999, -3])
    assert frames[1].max() == 0 and frames[2].max() == 0
    with pytest.warns(UserWarning):
        clips = nat.read_clips(np.asarray([5], np.int32),
                               np.asarray([[0, 1]], np.int32))
    assert clips.max() == 0
    with pytest.raises(IndexError):
        nat.video_meta(1)
    nat.close()
    with pytest.raises(ValueError, match="closed"):
        nat.read_frames(0, [0])


def test_decode_jpeg_blobs_is_the_jax_decode(jax_lib, monkeypatch):
    blobs = [_jpeg(f, q) for f, q in zip(_frames(3, n=3, hw=(40, 56)),
                                         (95, 80, 60))]
    monkeypatch.delenv("CSTP_FORCE_PIL_DECODE", raising=False)
    for hw in ((40, 56), (21, 30)):
        got = pnative.decode_jpeg_blobs(blobs, hw, n_threads=2)
        assert got.shape == (3, *hw, 3)
        np.testing.assert_array_equal(
            got, jnative.decode_jpeg_blobs(blobs, hw, n_threads=2))
    with pytest.warns(UserWarning, match="1 JPEG blob decode errors"):
        bad = pnative.decode_jpeg_blobs([b"notajpeg", blobs[0]], (16, 16))
    assert bad[0].max() == 0 and bad[1].std() > 1
    assert pnative.decode_jpeg_blobs([], (8, 8)).shape == (0, 8, 8, 3)
    monkeypatch.setenv("CSTP_FORCE_PIL_DECODE", "1")
    assert pnative.decode_jpeg_blobs(blobs, (16, 16)) is None
    assert jnative.decode_jpeg_blobs(blobs, (16, 16)) is None


def test_library_is_built_under_build_not_native():
    path = Path(pnative.load_native_lib()._name)
    assert path.parent == build.build_dir() == build.BUILD_DIR
    assert path.parts[-4:-2] == ("build", "cstp_tpu_torch")
    assert "native" not in path.parts
    assert path.name.startswith("libcstpack_reader_")
    assert build.has_jpeglib()       # the bitwise JPEG cases need libjpeg
    cmd = build.host_command("cstpack_reader", Path("x.so"), True)
    assert cmd[-2:] == ["-ljpeg", "-lpthread"] and "nvcc" not in cmd[0]


def test_build_dataset_packed_takes_the_native_reader(shard):
    cfg = Config(data_backend="packed", lmdb_path=shard, n_workers=3)
    ds = build_dataset(cfg.finalize(), "train")
    assert isinstance(ds, pnative.NativePackedDataset)
    assert ds.n_threads == 3 and ds.num_videos() == N_RAW + N_JPEG


def test_a_failed_build_raises_with_the_compiler_message(tmp_path,
                                                         monkeypatch):
    (tmp_path / "broken.cc").write_text("int f() { return undeclared; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for "
                       "csrc/broken.cc.*undeclared"):
        build.build_host("broken", jpeg=True)


@pytest.fixture
def no_jpeg_lib(monkeypatch):
    """The reader built with its JPEG decode compiled out, as on a host
    without ``jpeglib.h``, in place of the library built with libjpeg."""
    lib = build.bind(ctypes.CDLL(build.build_host("cstpack_reader",
                                                  jpeg=False)),
                     pnative.SIGNATURES)
    assert lib.cstp_has_jpeg() == 0
    assert pnative.load_native_lib().cstp_has_jpeg() == 1
    monkeypatch.setattr(pnative, "load_native_lib", lambda: lib)
    return lib


def test_reader_without_libjpeg(shard, tmp_path, no_jpeg_lib, monkeypatch,
                                caplog):
    """Raw shards read bitwise as with libjpeg; a JPEG shard is refused
    (never zero-filled), and build_dataset hands it to the Python reader
    with a warning; JPEG blobs go to PIL."""
    raw = str(tmp_path / "raw.cstp")
    w = PackedWriter(raw)
    for i in range(N_RAW):
        w.add_video_raw(f"raw{i}", i, _frames(i))
    w.close()
    vids, idx = _clips(np.random.default_rng(4), N_RAW)
    for hw in (STORED, (24, 32)):
        got = pnative.NativePackedDataset(raw, ingest_hw=hw).read_clips(
            vids, idx)
        want = jnative.NativePackedDataset(raw, ingest_hw=hw).read_clips(
            vids, idx)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(pnative.NoJpegDecoder, match="holds 2 JPEG videos"):
        pnative.NativePackedDataset(shard)
    cfg = Config(data_backend="packed", lmdb_path=shard).finalize()
    with caplog.at_level(logging.WARNING, logger="cstp_tpu_torch.data"):
        ds = build_dataset(cfg, "train")
    assert type(ds) is PackedDataset
    assert "reading it with the Python PackedDataset" in caplog.text
    assert isinstance(build_dataset(
        Config(data_backend="packed", lmdb_path=raw).finalize(), "train"),
        pnative.NativePackedDataset)
    monkeypatch.delenv("CSTP_FORCE_PIL_DECODE", raising=False)
    assert pnative.decode_jpeg_blobs([_jpeg(_frames(0)[0])], (8, 8)) is None
