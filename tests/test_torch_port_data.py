"""The port's host data layer against the JAX package's, on the CPU.

Held bitwise: every reader's ``num_videos`` / ``video_meta`` /
``read_frames`` on the same files (synthetic, frame-dir JPEGs, CSTPack raw
and JPEG, LMDB decoded with PIL and with the native pool, a cv2-written
video), the CSTPack writer's bytes, the label
parsers, the clip-pair sampler on a grid, the cosine schedule, the parsed
``Config`` of the recipes' command lines, and the TensorBoard records.
``PreemptionGuard`` reports a SIGTERM sent to the process.
"""

import dataclasses
import os
import shutil
import signal
import warnings

import msgpack
import numpy as np
import pytest
from PIL import Image

from cstp_tpu import config as jconfig
from cstp_tpu.data import framedir as jframedir
from cstp_tpu.data import labels as jlabels
from cstp_tpu.data import lmdb_dataset as jlmdb_dataset
from cstp_tpu.data import packed as jpacked
from cstp_tpu.data import synthetic as jsynthetic
from cstp_tpu.data import video as jvideo
from cstp_tpu.data.lmdb_store import write_lmdb
from cstp_tpu.pretext import sampling as jsampling
from cstp_tpu.train import optim as joptim
from cstp_tpu.utils import tb as jtb
from cstp_tpu_torch import config as pconfig
from cstp_tpu_torch.data import framedir as pframedir
from cstp_tpu_torch.data import labels as plabels
from cstp_tpu_torch.data import lmdb_dataset as plmdb_dataset
from cstp_tpu_torch.data import packed as ppacked
from cstp_tpu_torch.data import synthetic as psynthetic
from cstp_tpu_torch.data import video as pvideo
from cstp_tpu_torch.pretext import sampling as psampling
from cstp_tpu_torch.train import optim as poptim
from cstp_tpu_torch.utils import tb as ptb
from cstp_tpu_torch.utils.preemption import PreemptionGuard

from _torch_threads import torch_threads  # noqa: F401

HW = (24, 32)          # ingest size of the file-backed cases
N_VIDEOS, N_FRAMES = 3, 7
# frame indices to read: in order, reversed, repeated
READS = [[0, 1, 2, 3], [6, 2, 2, 0], [5, 5, 5, 1]]


@pytest.fixture
def tmp_path(tmp_path):
    """The test's own directory, removed when the test ends, passed or
    failed: its checkpoints, .pth files and CLI outputs are read back
    inside the test, and left behind they would fill the disk over a
    whole run of the suite."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _frames(seed, n=N_FRAMES, hw=(30, 40)):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *hw, 3), dtype=np.uint8)


def _jpeg(frame) -> bytes:
    import io

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _ucf_lists(ann, names, n_frames=N_FRAMES):
    ann.mkdir(exist_ok=True)
    lines = "\n".join(f"{n}.avi {i % 2} {n_frames}"
                      for i, n in enumerate(names)) + "\n"
    for f in ("trainlist01_nframe.txt", "testlist01_nframe.txt"):
        (ann / f).write_text(lines)


def _names():
    return [f"class{i % 2}/v_{i:02d}" for i in range(N_VIDEOS)]


def _framedir(tmp_path):
    root = tmp_path / "frames"
    for i, rel in enumerate(_names()):
        d = root / rel
        d.mkdir(parents=True)
        for k, f in enumerate(_frames(i)):
            Image.fromarray(f).save(d / ("%05d.jpg" % (k + 1)), quality=90)
    _ucf_lists(tmp_path / "ann", _names())
    return str(root), str(tmp_path / "ann")


def _pack(tmp_path, codec, writer_mod):
    path = str(tmp_path / f"{codec}_{writer_mod.__name__.split('.')[0]}.cstp")
    w = writer_mod.PackedWriter(path)
    for i, rel in enumerate(_names()):
        frames = _frames(i)
        if codec == "raw":
            w.add_video_raw(rel, i % 2, frames)
        else:
            w.add_video(rel, i % 2, [_jpeg(f) for f in frames])
    w.close()
    return path


def _readers(kind, tmp_path, monkeypatch):
    """(JAX reader, port reader) over the same files."""
    if kind.startswith("synthetic"):
        kw = dict(n_videos=N_VIDEOS, n_classes=5, ingest_hw=HW,
                  learnable=kind.endswith("1"))
        return (jsynthetic.SyntheticVideoDataset(**kw),
                psynthetic.SyntheticVideoDataset(**kw))
    if kind == "framedir":
        root, ann = _framedir(tmp_path)
        return (jframedir.FrameDirDataset(root, ann, ingest_hw=HW),
                pframedir.FrameDirDataset(root, ann, ingest_hw=HW))
    if kind.startswith("packed"):
        codec = kind.split("_")[1]
        path = _pack(tmp_path, codec, jpacked)
        # raw frames are stored at 30x40: ingest HW resizes them with PIL
        return (jpacked.PackedDataset(path, ingest_hw=HW),
                ppacked.PackedDataset(path, ingest_hw=HW))
    if kind.startswith("lmdb"):
        # JAX's frame_dir_to_lmdb over a frame directory. "lmdb": both
        # readers decode with PIL (CSTP_FORCE_PIL_DECODE=1); "lmdb_native":
        # both through their own native libjpeg pool
        if kind == "lmdb":
            monkeypatch.setenv("CSTP_FORCE_PIL_DECODE", "1")
        else:
            from cstp_tpu.data import native_reader as jnative

            monkeypatch.delenv("CSTP_FORCE_PIL_DECODE", raising=False)
            assert jnative.load_native_lib() is not None
        root, ann = _framedir(tmp_path)
        db = str(tmp_path / "db")
        assert jlmdb_dataset.frame_dir_to_lmdb(root, db) == N_VIDEOS
        kw = dict(dataset="UCF101", data_type="train", ingest_hw=HW)
        return (jlmdb_dataset.LMDBVideoDataset(db, ann, **kw),
                plmdb_dataset.LMDBVideoDataset(db, ann, **kw))
    if kind == "video":
        import cv2

        root = tmp_path / "videos"
        for i, rel in enumerate(_names()):
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            vw = cv2.VideoWriter(str(root / (rel + ".avi")),
                                 cv2.VideoWriter_fourcc(*"MJPG"), 10,
                                 (40, 30))
            for f in _frames(i):
                vw.write(f)
            vw.release()
        _ucf_lists(tmp_path / "ann", _names())
        kw = dict(dataset="UCF101", data_type="train", ingest_hw=HW)
        return (jvideo.VideoDataset(str(root), str(tmp_path / "ann"), **kw),
                pvideo.VideoDataset(str(root), str(tmp_path / "ann"), **kw))
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [
    "synthetic0", "synthetic1", "framedir", "packed_raw", "packed_jpeg",
    "lmdb", "lmdb_native", "video"])
def test_readers_are_bitwise_the_jax_readers(kind, tmp_path, monkeypatch):
    jds, pds = _readers(kind, tmp_path, monkeypatch)
    assert pds.num_videos() == jds.num_videos() == N_VIDEOS
    for i in range(N_VIDEOS):
        assert pds.video_meta(i) == jds.video_meta(i)
        for idx in READS:
            want = jds.read_frames(i, idx)
            got = pds.read_frames(i, idx)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    if kind.startswith("synthetic"):
        # synthetic content is not flat: the comparison sees real pixels
        assert jds.read_frames(0, [0, 9]).std() > 10


@pytest.mark.parametrize("codec", ["raw", "jpeg"])
def test_packed_writer_writes_the_jax_bytes(codec, tmp_path):
    with open(_pack(tmp_path, codec, jpacked), "rb") as f:
        want = f.read()
    with open(_pack(tmp_path, codec, ppacked), "rb") as f:
        assert f.read() == want


def test_packed_reader_refuses_a_foreign_file(tmp_path):
    p = tmp_path / "x.cstp"
    p.write_bytes(b"NOPE" + bytes(40))
    with pytest.raises(ValueError, match="not a CSTPack"):
        ppacked.PackedDataset(str(p))


def test_lmdb_reader_on_overflow_values(tmp_path):
    """Values past a page go to overflow pages; the port's reader gets them
    (and a missing key) as the JAX reader does."""
    from cstp_tpu.data.lmdb_store import LMDBReader as JReader
    from cstp_tpu_torch.data.lmdb_store import LMDBReader as PReader

    rng = np.random.default_rng(0)
    items = {b"%05d" % i: rng.bytes(int(rng.integers(1, 9000)))
             for i in range(300)}
    path = write_lmdb(str(tmp_path / "db.mdb"), items)
    j, p = JReader(path), PReader(path)
    assert len(p) == len(j) == 300
    for k, v in items.items():
        assert p[k] == v
    assert p.get(b"zzz") is None
    assert list(p.items()) == list(j.items())
    j.close()
    p.close()


def _label_files(tmp_path):
    ucf = tmp_path / "trainlist01_nframe.txt"
    ucf.write_text("ApplyEyeMakeup/v_ApplyEyeMakeup_g08_c01.avi 0 164\n"
                   "Archery/v_Archery_g01_c01.avi 2 120\n")
    plain = tmp_path / "testlist01.txt"
    plain.write_text("ApplyEyeMakeup/v_ApplyEyeMakeup_g08_c01.mp4 0\n"
                     "Archery/v_Archery_g01_c01.mp4 2\n")
    kin = tmp_path / "val_list_label_nframe.txt"
    kin.write_text("val/abseiling/x.mp4  3  250\n")
    kin2 = tmp_path / "train_list_label.txt"
    kin2.write_text("val/abseiling/x.mp4  3\nval/archery/y.mp4  5\n")
    (tmp_path / "classInd.txt").write_text("1 Alpha\n2 Beta\n")
    return ucf, plain, kin, kin2


@pytest.mark.parametrize("case", [
    "ucf", "ucf_plain", "kinetics", "kinetics_plain", "list_paths",
    "class_names"])
def test_label_parsers_are_the_jax_parsers(case, tmp_path):
    ucf, plain, kin, kin2 = _label_files(tmp_path)
    calls = {
        "ucf": lambda m: m.parse_ucf_list(str(ucf)),
        "ucf_plain": lambda m: m.parse_ucf_list(str(plain)),
        "kinetics": lambda m: m.parse_kinetics_list(str(kin)),
        "kinetics_plain": lambda m: m.parse_kinetics_list(str(kin2)),
        "list_paths": lambda m: [
            m.ucf_list_path(str(tmp_path), t, "1") for t in ("train", "test")
        ] + [m.kinetics_list_path(str(tmp_path), t) for t in ("train", "val")
             ] + [m.train_list_name("2"), m.test_list_name("3")],
        "class_names": lambda m: [m.read_class_names(str(tmp_path)),
                                  m.read_class_names(str(tmp_path / "no"))],
    }[case]
    want, got = calls(jlabels), calls(plabels)

    def plain_(x):
        return ([dataclasses.asdict(r) for r in x]
                if x and dataclasses.is_dataclass(x[0]) else x)
    assert plain_(got) == plain_(want)
    if case == "ucf":
        assert got[0].path == "ApplyEyeMakeup/v_ApplyEyeMakeup_g08_c01"
        assert (got[0].label, got[0].nframes) == (0, 164)


def test_clip_pair_sampler_is_the_jax_sampler():
    """The same generator gives the same frame indices and labels, on a
    grid of video lengths (short videos wrap around) and durations."""
    fields = ("pb_label", "tem_label", "rot_label_1", "rot_label_2")
    for total in (3, 8, 15, 16, 31, 47, 64, 121, 300):
        for duration in (4, 8, 16):
            assert (psampling.max_playback_label(total, duration)
                    == jsampling.max_playback_label(total, duration))
            for start in (0, 5, 40):
                for cr in (3, 15, 60):
                    assert (psampling.valid_temporal_offsets(start, total, cr)
                            == jsampling.valid_temporal_offsets(start, total,
                                                                cr))
            for seed in range(4):
                want = jsampling.sample_clip_pair_host(
                    np.random.default_rng(seed), total, duration)
                gen = np.random.default_rng(seed)
                got = psampling.sample_clip_pair_host(gen, total, duration)
                np.testing.assert_array_equal(got.indices_1, want.indices_1)
                np.testing.assert_array_equal(got.indices_2, want.indices_2)
                assert got.indices_1.dtype == want.indices_1.dtype
                for f in fields:
                    assert getattr(got, f) == getattr(want, f)
                # and the generator was advanced as far
                ref = np.random.default_rng(seed)
                jsampling.sample_clip_pair_host(ref, total, duration)
                assert gen.integers(1 << 30) == ref.integers(1 << 30)
    assert psampling.PACE == jsampling.PACE
    assert psampling.ROTATE_DEG == jsampling.ROTATE_DEG


@pytest.mark.parametrize("max_lr,epochs", [(0.03, 300), (0.1, 7)])
def test_cosine_schedule_is_the_jax_schedule(max_lr, epochs):
    want = joptim.cosine_warmup_restarts(max_lr, epochs, 0.5 * epochs,
                                         min_lr=1e-5, gamma=0.5)
    got = poptim.cosine_warmup_restarts(max_lr, epochs, 0.5 * epochs,
                                        min_lr=1e-5, gamma=0.5)
    # every epoch of two cycles: the restart halves the peak
    for e in range(2 * epochs):
        assert got(e) == want(e)
    with pytest.raises(ValueError):
        poptim.cosine_warmup_restarts(0.1, 7, 7)


def _script_lines():
    """The recipe scripts' and the verify notes' command lines."""
    root = os.path.join(os.path.dirname(__file__), "..")
    lines = []
    for script in ("script/r2p1d/kin400/run_kin400_r21d_bs128_lr9e2_wd5e4.sh",
                   "script/r2p1d/ucf101/run_ucf101_r21d_bs60_lr3e2.sh"):
        text = open(os.path.join(root, script)).read().replace("\\\n", " ")
        for line in text.splitlines():
            if "python -m cstp_tpu.cli." in line:
                argv = line.split("python -m ", 1)[1].split()[1:]
                lines.append([a.strip('"') for a in argv])
    common = ["--model_name", "r21d", "--model_depth", "1",
              "--data_backend", "synthetic", "--synthetic_len", "16",
              "--dataset", "UCF101", "--sample_duration", "4",
              "--sample_size", "32", "--compute_dtype", "float32",
              "--result_path", "R"]
    cls = ["--n_classes", "10", "--n_finetune_classes", "10"]
    lines += [
        common + ["--task", "loss_com", "--batch_size", "8", "--n_epochs",
                  "2", "--ckpt_every_epochs", "2", "--learning_rate", "0.03",
                  "--n_workers", "2"],
        common + cls + ["--task", "ft_all", "--pretrained_path",
                        "R/UCF101/loss_com/save_2", "--batch_size", "8",
                        "--pb_rate", "2", "--n_epochs", "2",
                        "--learning_rate", "0.02", "--n_workers", "2"],
        common + cls + ["--task", "test", "--t_ft_task", "ft_all",
                        "--pb_rate", "2"],
        common + cls + ["--task", "retrieval", "--t_ft_task", "ft_all",
                        "--retrieval_clips", "2"],
    ]
    return lines


@pytest.mark.parametrize("i", range(10))
def test_parse_opts_gives_the_jax_values(i):
    argv = _script_lines()[i]
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jconfig.parse_opts(argv)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        got = pconfig.parse_opts(argv)
    shared = ({f.name for f in dataclasses.fields(want)}
              & {f.name for f in dataclasses.fields(got)})
    assert len(shared) == len(dataclasses.fields(want))
    for name in sorted(shared):
        assert getattr(got, name) == getattr(want, name), name
    assert got.clip_stride == want.clip_stride
    # the same legacy-name warning, word for word
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    assert pconfig.Config.from_json(got.to_json()) == got


def test_the_recipe_lines_are_all_there():
    lines = _script_lines()
    assert len(lines) == 10
    assert sum("--pretrained_path" in a for a in lines) == 3


def test_tb_writer_writes_the_jax_records(tmp_path, monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1234567.25)
    out = []
    for mod, sub in ((jtb, "j"), (ptb, "p")):
        w = mod.TBWriter(str(tmp_path / sub))
        w.add_scalar("loss", 1.5, 3)
        w.add_scalars({"a": 0.25, "b": None, "c": -2.0}, 7, prefix="ep/")
        w.close()
        out.append((os.path.basename(w.path), open(w.path, "rb").read()))
    assert out[1] == out[0]
    assert ptb.maybe_tb_writer("") is None


def test_preemption_guard_reports_a_sigterm():
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(enabled=True)
    try:
        assert not guard.requested(1)
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested(2)
    finally:
        guard.close()
    assert signal.getsignal(signal.SIGTERM) == before
    off = PreemptionGuard(enabled=False)
    assert not off.requested(1)
    off.close()


def test_lmdb_reader_msgpack_layout_sanity(tmp_path):
    """The LMDB fixture holds the reference layout the readers expect."""
    _framedir(tmp_path)
    db = str(tmp_path / "db")
    jlmdb_dataset.frame_dir_to_lmdb(str(tmp_path / "frames"), db)
    from cstp_tpu_torch.data.lmdb_store import LMDBReader

    r = LMDBReader(db)
    order = msgpack.loads(r[b"__order__"])
    assert sorted(order) == sorted(_names())
    assert msgpack.loads(r[b"__vlen__"]) == [N_FRAMES] * N_VIDEOS
    r.close()
