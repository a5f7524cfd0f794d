"""The port's ingest tools against the JAX package's, on the CPU, and its
single-device entry point against ``__graft_entry__.entry``.

* ``python -m cstp_tpu_torch.data.pack``: ``frames`` (JPEG and
  ``--raw-hw``), ``make-lmdb`` (subdir and ``--file``), ``lmdb`` and
  ``info`` write byte-identical files and print the same lines as JAX's
  ``pack``.
* ``python -m cstp_tpu_torch.data.extract_frames``: with the stub
  ffmpeg/ffprobe of ``tests/test_extract_frames.py`` the same command lines,
  frames, ``done`` markers and list file as JAX's; without ffmpeg, the
  cv2 decoder's frames are bitwise JAX's.
* ``graft_entry.entry()``: the same example arguments as JAX's entry, and
  the same forward from the same weights on the same seeded clips. In
  float32 (both entries' ``Config`` set to compute in float32) it is held
  to the tolerance of the pretrain-forward parity tests
  (``test_torch_port_families.py``): loss and logits rtol 1e-4, atol 1e-5.
  In the entries' own bf16 the loss is held to chip_smoke phase 4's bf16
  rule, relative error 2e-2.
"""

import os
import shutil
import stat
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import __graft_entry__ as jentry
from cstp_tpu import config as jconfig
from cstp_tpu.data import extract_frames as jextract
from cstp_tpu.data import pack as jpack
from cstp_tpu.ssl.byol import CSTPPretrain as JaxPretrain
from cstp_tpu_torch import graft_entry
from cstp_tpu_torch.data import extract_frames as pextract
from cstp_tpu_torch.data import pack as ppack
from cstp_tpu_torch.models.bridge import export_jax_variables

from _torch_threads import torch_threads  # noqa: F401

NAMES = ["classA/v_00", "classA/v_01", "classB/v_02", "classB/v_03"]


@pytest.fixture
def tmp_path(tmp_path):
    """The test's own directory, removed when the test ends, passed or
    failed: its checkpoints, .pth files and CLI outputs are read back
    inside the test, and left behind they would fill the disk over a
    whole run of the suite."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _frame_tree(root):
    rng = np.random.default_rng(0)
    for i, rel in enumerate(NAMES):
        d = root / "frames" / rel
        d.mkdir(parents=True)
        for k in range(5 + i):
            Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
                            ).save(d / ("%05d.jpg" % (k + 1)), quality=90)
    ann = root / "ann"
    ann.mkdir()
    (ann / "trainlist01_nframe.txt").write_text("".join(
        f"{rel}.avi {i % 2} {5 + i}\n" for i, rel in enumerate(NAMES)))
    return str(root / "frames"), str(ann)


def _read(path):
    if os.path.isdir(path):
        path = os.path.join(path, "data.mdb")
    with open(path, "rb") as f:
        return f.read()


def _remove(path):
    if os.path.isdir(path):
        shutil.rmtree(path)
    else:
        os.remove(path)


def _both(argv, out, capsys):
    """Run JAX's then the port's ``pack`` with ``argv``; returns their
    (return code, printed text, bytes of ``out``)."""
    res = []
    for mod in (jpack, ppack):
        rc = mod.main(argv)
        text = capsys.readouterr().out
        res.append((rc, text, _read(out) if out else None))
        if out and mod is jpack:
            _remove(out)
    return res


def test_pack_cli_writes_the_jax_files_and_lines(tmp_path, capsys):
    frames, ann = _frame_tree(tmp_path)
    train_list = os.path.join(ann, "trainlist01_nframe.txt")
    shard, raw, db, dbfile, conv = (str(tmp_path / n) for n in (
        "train.cstp", "raw.cstp", "db", "db.mdb", "conv.cstp"))
    runs = [
        (["frames", "--frame-dir", frames, "--annotation", train_list,
          "--out", shard], shard),
        (["frames", "--frame-dir", frames, "--annotation", train_list,
          "--out", raw, "--raw-hw", "24", "32", "--limit", "3"], raw),
        (["make-lmdb", "--frame-dir", frames, "--out", dbfile, "--file"],
         dbfile),
        (["make-lmdb", "--frame-dir", frames, "--out", db], db),
        (["lmdb", "--lmdb", db, "--annotation-path", ann, "--out", conv],
         conv),
        (["info", shard], None),
        (["info", raw], None),
    ]
    for argv, out in runs:
        (jrc, jtext, jbytes), (prc, ptext, pbytes) = _both(argv, out, capsys)
        assert prc == jrc == 0
        assert ptext == jtext and ptext.strip(), argv
        assert pbytes == jbytes, argv
    assert ptext.endswith("3 videos, 18 frames, codecs={1}\n")
    assert _read(conv)[:4] == b"CSTP"


FFPROBE_STUB = """#!/bin/bash
echo "ffprobe $*" >> "$STUB_LOG"
read -r line < "${@: -1}"
echo "width=${line%x*}"
echo "height=${line#*x}"
"""

FFMPEG_STUB = """#!/bin/bash
echo "ffmpeg $*" >> "$STUB_LOG"
pattern="${@: -1}"
outdir=$(dirname "$pattern")
for i in 1 2 3; do
  printf 'JPG' > "$outdir/$(printf '%05d' $i).jpg"
done
"""


def _tree_listing(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _extract_both(argv, tmp_path, capsys, monkeypatch):
    """JAX's extract_frames, then the port's, with the same ``argv`` (its
    frame dir ``tmp_path/frames``, list file ``tmp_path/list.txt``);
    returns per package the return code, printed text, files under the
    frame dir, the list file and the stub ffmpeg/ffprobe command lines."""
    res = []
    for k, mod in enumerate((jextract, pextract)):
        log = tmp_path / f"stub{k}.log"
        log.write_text("")
        monkeypatch.setenv("STUB_LOG", str(log))
        shutil.rmtree(tmp_path / "frames", ignore_errors=True)
        rc = mod.main(argv)
        cap = capsys.readouterr()
        res.append(dict(rc=rc, out=cap.out, err=cap.err,
                        files=_tree_listing(tmp_path / "frames"),
                        listed=(tmp_path / "list.txt").read_text(),
                        cmds=sorted(log.read_text().splitlines())))
    return res


def test_extract_frames_ffmpeg_commands_are_jax_commands(tmp_path, capsys,
                                                         monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name, body in (("ffprobe", FFPROBE_STUB), ("ffmpeg", FFMPEG_STUB)):
        p = bindir / name
        p.write_text(body)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    vd = tmp_path / "videos"
    for cls, wh in (("classA", "640x360"), ("classB", "360x640")):
        (vd / cls).mkdir(parents=True)
        for v in ("vid1.mp4", "vid 2.avi"):
            (vd / cls / v).write_text(wh + "\n")
    fd = str(tmp_path / "frames")
    argv = ["--vid-dir", str(vd), "--frame-dir", fd, "--res", "128",
            "--fps", "25", "--workers", "2", "--list-file",
            str(tmp_path / "list.txt"), "--ffmpeg", str(bindir / "ffmpeg"),
            "--ffprobe", str(bindir / "ffprobe")]
    want, got = _extract_both(argv, tmp_path, capsys, monkeypatch)
    assert got == want and got["rc"] == 0
    assert len(got["cmds"]) == 8
    assert any("scale=-1:128" in c for c in got["cmds"])
    assert any("scale=128:-1" in c for c in got["cmds"])
    assert "classA/vid 2/done" in got["files"]
    assert sorted(got["listed"].splitlines()) == [
        "classA/vid 2 0 3", "classA/vid1 0 3", "classB/vid 2 1 3",
        "classB/vid1 1 3"]
    # a second run skips the finished videos (done markers)
    assert pextract.main(argv) == 0
    assert _tree_listing(fd) == got["files"]


def test_extract_frames_cv2_path_is_bitwise_jax(tmp_path, capsys,
                                               monkeypatch):
    cv2 = pytest.importorskip("cv2")
    vd = tmp_path / "videos"
    rng = np.random.default_rng(1)
    for cls, (n, fps, w, h) in (("a", (9, 30, 64, 48)),
                                ("b", (7, 20, 40, 56))):
        (vd / cls).mkdir(parents=True)
        wr = cv2.VideoWriter(str(vd / cls / "clip.avi"),
                             cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
        assert wr.isOpened()
        base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for t in range(n):
            wr.write(np.roll(base, 3 * t, axis=1))
        wr.release()
    fd = str(tmp_path / "frames")
    argv = ["--vid-dir", str(vd), "--frame-dir", fd, "--res", "32", "--fps",
            "25", "--workers", "2", "--list-file", str(tmp_path / "list.txt"),
            "--ffmpeg", "definitely-not-here-ffmpeg"]
    want, got = _extract_both(argv, tmp_path, capsys, monkeypatch)
    assert got == want and got["rc"] == 0
    assert "cv2 decoder" in got["err"]
    assert sorted(got["listed"].splitlines()) == ["a/clip 0 8", "b/clip 1 9"]
    with Image.open(os.path.join(fd, "b", "clip", "00001.jpg")) as img:
        assert img.size == (32, 45)        # short side -> 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graft_entry_matches_the_jax_entry(dtype, monkeypatch):
    if dtype == "float32":
        pcfg, jcfg = graft_entry.Config, jconfig.Config
        monkeypatch.setattr(graft_entry, "Config", lambda **kw: pcfg(
            **{**kw, "compute_dtype": "float32"}))
        monkeypatch.setattr(jconfig, "Config", lambda **kw: jcfg(
            **{**kw, "compute_dtype": "float32"}))
    fn, (model, x, x_) = graft_entry.entry("cpu")
    assert x is x_ and x.shape == (2, 8, 112, 112, 3)
    assert x.dtype == torch.bfloat16 and not x.any()
    # JAX's entry takes the port's initial weights in place of its init
    params, stats = jax.tree_util.tree_map(np.copy,
                                           export_jax_variables(model))
    monkeypatch.setattr(JaxPretrain, "init", lambda self, *a, **k: {
        "params": params, "batch_stats": stats})
    jfn, (jparams, jstats, jx, _) = jentry.entry()
    assert jx.shape == tuple(x.shape) and jx.dtype == jnp.bfloat16
    s = 32 if dtype == "float32" else 112
    rng = np.random.default_rng(5)
    x1, x2 = (rng.uniform(-1, 1, (2, 8, s, s, 3)).astype(np.float32)
              for _ in range(2))
    jloss, jlogits = jax.jit(jfn)(jparams, jstats,
                                  jnp.asarray(x1, jnp.bfloat16),
                                  jnp.asarray(x2, jnp.bfloat16))
    before = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        loss, logits = fn(model, torch.from_numpy(x1).to(torch.bfloat16),
                          torch.from_numpy(x2).to(torch.bfloat16))
    assert [tuple(o.shape) for o in logits] == [
        tuple(o.shape) for o in jlogits]
    assert len(logits) == 6 and all(o.shape[0] == 2 for o in logits)
    # train mode: the running statistics moved
    assert any(not torch.equal(before[k], v)
               for k, v in model.named_buffers() if k.endswith(".mean"))
    if dtype == "float32":
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4,
                                   atol=1e-5)
        for g, w in zip(logits, jlogits):
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-5)
    else:
        assert abs(loss.item() - float(jloss)) <= 2e-2 * abs(float(jloss))
