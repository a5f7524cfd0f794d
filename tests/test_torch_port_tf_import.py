"""The port's kinetics-i3d TensorFlow checkpoint importer (``--tf_i3d_ckpt``):
``models/tf_checkpoint.py`` (a V2 checkpoint reader with numpy and the
standard library) and ``models/i3d_tf_import.py`` (the Sonnet names onto
the port's I3D), on the CPU.

With TensorFlow (skipped without it, as ``tests/test_i3d_tf_import.py``):
a Sonnet-named checkpoint at I3D's full widths written by
``tf.compat.v1.train.Saver`` reads back bitwise as TensorFlow reads it,
lands bitwise where the JAX package's importer lands it, and the writer
``chip_smoke.py`` uses gives files TensorFlow reads back bitwise. Without
TensorFlow: the reader's refusals on hand-made bytes, the importer's
``strict``, and the finetune and pretrain loops loading a checkpoint into
the right towers. Everything loaded is compared bitwise.
"""

import os
import struct

import numpy as np
import pytest
import torch

import chip_smoke
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models import make_backbone
from cstp_tpu_torch.models import tf_checkpoint as tfc
from cstp_tpu_torch.models.i3d_tf_import import load_tf_i3d, sonnet_name_map

N_CLASSES = 5


@pytest.fixture(scope="module")
def i3d():
    return make_backbone("i3d_byol", dtype=torch.float32,
                         gen=torch.Generator().manual_seed(0))


def sonnet_tensors(model, seed=0, skip=()):
    """Sonnet names -> numpy-seeded float32 tensors of the port I3D's
    shapes (DHWIO kernels, BN statistics shaped (1, 1, 1, 1, C) as the
    public checkpoints store them), plus the classifier the importer
    skips."""
    rng = np.random.default_rng(seed)
    out = {}
    for scope, path in sonnet_name_map("rgb").items():
        if scope in skip:
            continue
        unit = model.get_submodule(".".join(path))
        kshape = tuple(unit.conv.weight.permute(2, 3, 4, 1, 0).shape)
        c = kshape[-1]
        out[f"{scope}/conv_3d/w"] = (rng.normal(size=kshape) * 1e-2).astype(
            np.float32)
        out[f"{scope}/batch_norm/beta"] = rng.normal(size=c).astype(
            np.float32)
        for leaf in ("moving_mean", "moving_variance"):
            out[f"{scope}/batch_norm/{leaf}"] = rng.uniform(
                0.5, 1.5, (1, 1, 1, 1, c)).astype(np.float32)
    out["RGB/inception_i3d/Logits/Conv3d_0c_1x1/conv_3d/w"] = rng.normal(
        size=(1, 1, 1, 1024, 400)).astype(np.float32)
    return out


def assert_loaded(backbone, tensors):
    """Every unit of ``backbone`` holds its checkpoint tensors bitwise."""
    for scope, path in sonnet_name_map("rgb").items():
        unit = backbone.get_submodule(".".join(path))
        w = tensors[f"{scope}/conv_3d/w"].transpose(4, 3, 0, 1, 2)
        assert torch.equal(unit.conv.weight.detach().cpu(),
                           torch.from_numpy(np.ascontiguousarray(w))), scope
        bn = unit.bn
        for t, leaf in ((bn.bias, "beta"), (bn.mean, "moving_mean"),
                        (bn.var, "moving_variance")):
            want = tensors[f"{scope}/batch_norm/{leaf}"].reshape(-1)
            assert torch.equal(t.detach().cpu(), torch.from_numpy(want)), \
                (scope, leaf)
        assert torch.equal(bn.scale.detach().cpu(),
                           torch.ones_like(bn.scale.cpu()))


# ------------------------------------------------------------ TensorFlow

@pytest.fixture(scope="module")
def saver_ckpt(tmp_path_factory, i3d):
    """A Sonnet-named I3D checkpoint written by TensorFlow's own Saver,
    with an int64 ``global_step`` beside the float32 variables."""
    tf = pytest.importorskip("tensorflow")
    tensors = sonnet_tensors(i3d)
    tf.compat.v1.reset_default_graph()
    with tf.compat.v1.Session() as sess:
        for name, v in tensors.items():
            tf.compat.v1.get_variable(name, initializer=v)
        tf.compat.v1.get_variable("global_step", initializer=np.int64(300))
        sess.run(tf.compat.v1.global_variables_initializer())
        path = tf.compat.v1.train.Saver().save(
            sess, str(tmp_path_factory.mktemp("tf") / "model.ckpt"))
    return tf, path, tensors


def test_reader_returns_what_tensorflow_reads(saver_ckpt):
    tf, path, _ = saver_ckpt
    want = tf.train.load_checkpoint(path)
    got = tfc.load_checkpoint(path)
    shapes = want.get_variable_to_shape_map()
    assert got.get_variable_to_shape_map() == shapes
    assert len(shapes) == 4 * 57 + 2
    for name in shapes:
        a, b = got.get_tensor(name), want.get_tensor(name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_load_lands_where_jax_lands_it(saver_ckpt, i3d):
    """The port's ``load_tf_i3d`` onto its I3D, exported through the bridge,
    equals bitwise what the JAX package's ``load_tf_i3d`` makes of the same
    starting variables, typo scope included."""
    import jax

    from cstp_tpu.models.i3d_tf_import import load_tf_i3d as jax_load
    from cstp_tpu_torch.models.bridge import export_jax_variables

    _, path, tensors = saver_ckpt
    assert "RGB/inception_i3d/Mixed_5b/Branch_2/Conv3d_0a_3x3/conv_3d/w" \
        in tensors
    params, stats = jax.tree_util.tree_map(np.copy,
                                           export_jax_variables(i3d))
    want = jax_load(params, stats, path)
    model = make_backbone("i3d_byol", dtype=torch.float32,
                          gen=torch.Generator().manual_seed(0))
    assert load_tf_i3d(model, path) == 57
    assert_loaded(model, tensors)
    got = export_jax_variables(model)
    for g, w in zip(got, want):
        gf = dict(jax.tree_util.tree_flatten_with_path(g)[0])
        wf = dict(jax.tree_util.tree_flatten_with_path(w)[0])
        assert gf.keys() == wf.keys()
        for k in wf:
            assert np.asarray(gf[k]).tobytes() == np.asarray(
                wf[k], np.float32).tobytes(), jax.tree_util.keystr(k)


def test_chip_smoke_writer_is_read_by_tensorflow(tmp_path, i3d):
    tf = pytest.importorskip("tensorflow")
    tensors = sonnet_tensors(i3d, seed=1)
    tensors["scalar"] = np.float32(2.5)
    prefix = str(tmp_path / "written.ckpt")
    chip_smoke.write_tf_checkpoint(prefix, tensors)
    reader = tf.train.load_checkpoint(prefix)
    assert set(reader.get_variable_to_shape_map()) == set(tensors)
    for name, v in tensors.items():
        got = reader.get_tensor(name)
        assert got.dtype == np.float32 and got.shape == np.shape(v), name
        assert got.tobytes() == np.asarray(v).tobytes(), name


# ------------------------------------------------------------ no TensorFlow

def _small(tmp_path, name="small.ckpt"):
    prefix = str(tmp_path / name)
    tensors = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
               "b/c": np.linspace(0, 1, 2000, dtype=np.float32)}
    chip_smoke.write_tf_checkpoint(prefix, tensors)
    return prefix, tensors


def _data_block(index: bytes):
    """(offset, size) of the first data block of an index file."""
    footer = index[-tfc.FOOTER_BYTES:]
    (_, _), pos = tfc._handle(footer)
    (ioff, isize), _ = tfc._handle(footer, pos)
    _, value = tfc.block_entries(index[ioff:ioff + isize])[0]
    return tfc._handle(value)[0]


def test_reader_reads_the_writer(tmp_path):
    prefix, tensors = _small(tmp_path)
    reader = tfc.load_checkpoint(prefix)
    assert reader.get_variable_to_shape_map() == {"a": [2, 3],
                                                 "b/c": [2000]}
    for k, v in tensors.items():
        assert reader.get_tensor(k).tobytes() == v.tobytes()
    with pytest.raises(KeyError):
        reader.get_tensor("x")


def _rewrite(path, edit):
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    edit(buf)
    with open(path, "wb") as f:
        f.write(bytes(buf))


def _compress(buf):
    off, size = _data_block(bytes(buf))
    buf[off + size] = 1                      # snappy


def _index_of_a(prefix, header=b"", entry_prefix=b"", entry_suffix=b""):
    """An index holding only "a", its header fields and entry edited."""
    entry = chip_smoke.bundle_entry(np.zeros((2, 3), np.float32), 0)
    with open(prefix + ".index", "wb") as f:
        f.write(chip_smoke.sstable_bytes(
            [(b"", chip_smoke._field(1, 1) + header),
             (b"a", entry_prefix + entry + entry_suffix)]))


@pytest.mark.parametrize("case, match", [
    ("compressed block", "compressed"), ("sliced entry", "sliced"),
    ("v1 checkpoint", "V1"), ("truncated shard", "run past"),
    ("bad magic", "not an SSTable"), ("flipped byte", "crc32c"),
    ("big-endian", "big-endian"), ("string dtype", "dtype 7")])
def test_reader_refuses(tmp_path, case, match):
    prefix, _ = _small(tmp_path)
    index, shard = prefix + ".index", prefix + ".data-00000-of-00001"
    if case == "compressed block":
        _rewrite(index, _compress)
    elif case == "sliced entry":
        _index_of_a(prefix, entry_suffix=chip_smoke._field(7, b""))
    elif case == "big-endian":
        _index_of_a(prefix, header=chip_smoke._field(2, 1))
    elif case == "string dtype":          # a later field 1 overrides
        _index_of_a(prefix, entry_suffix=chip_smoke._field(1, 7))
    elif case == "v1 checkpoint":
        os.rename(index, prefix)             # one file named by the prefix
    elif case == "truncated shard":
        _rewrite(shard, lambda b: b.__delitem__(slice(len(b) - 4, None)))
    elif case == "bad magic":
        _rewrite(index, lambda b: b.__setitem__(slice(-8, None),
                                                struct.pack("<Q", 1)))
    elif case == "flipped byte":
        _rewrite(shard, lambda b: b.__setitem__(100, b[100] ^ 1))
    with pytest.raises(ValueError, match=match):
        reader = tfc.load_checkpoint(prefix)
        reader.get_tensor("a")
        reader.get_tensor("b/c")


def test_crc32c_matches_the_standard_vectors():
    """RFC 3720's check value, and the parallel path against the byte loop
    on an odd length."""
    assert tfc.crc32c(b"123456789") == 0xE3069283
    assert tfc.crc32c(b"\0" * 32) == 0x8A9136AA
    data = np.random.default_rng(0).integers(0, 256, 300001, np.uint8)
    assert tfc.crc32c(data) == tfc._crc_bytes(
        0xFFFFFFFF, data.tolist()) ^ 0xFFFFFFFF


def test_strict_refuses_a_missing_scope(tmp_path, i3d):
    skip = "RGB/inception_i3d/Mixed_4c/Branch_3/Conv3d_0b_1x1"
    tensors = sonnet_tensors(i3d, skip=(skip,))
    prefix = str(tmp_path / "partial.ckpt")
    chip_smoke.write_tf_checkpoint(prefix, tensors)
    model = make_backbone("i3d_byol", dtype=torch.float32)
    with pytest.raises(KeyError, match="Mixed_4c/Branch_3"):
        load_tf_i3d(model, prefix)
    before = model.mixed_4c.branch_3_1.conv.weight.detach().clone()
    assert load_tf_i3d(model, prefix, strict=False) == 56
    assert torch.equal(model.mixed_4c.branch_3_1.conv.weight, before)
    with pytest.raises(ValueError, match="no I3D unit"):
        load_tf_i3d(model, _small(tmp_path)[0], strict=False)


@pytest.fixture(scope="module")
def written_ckpt(tmp_path_factory, i3d):
    tensors = sonnet_tensors(i3d, seed=2)
    prefix = str(tmp_path_factory.mktemp("ckpt") / "rgb_imagenet.ckpt")
    chip_smoke.write_tf_checkpoint(prefix, tensors)
    return prefix, tensors


def _loop_argv(tmp_path, task, ckpt, **over):
    kw = dict(model_name="i3d_byol", sample_duration=8, sample_size=32,
              batch_size=4, compute_dtype="float32",
              data_backend="synthetic", synthetic_len=8,
              n_classes=N_CLASSES, n_finetune_classes=N_CLASSES,
              result_path=str(tmp_path), n_workers=1, log_every=0,
              n_epochs=0, task=task, tf_i3d_ckpt=ckpt)
    kw.update(over)
    return [a for k, v in kw.items() for a in (f"--{k}", str(v))]


def test_main_ft_loads_the_checkpoint_into_online_net(tmp_path,
                                                      written_ckpt):
    """``main_ft --tf_i3d_ckpt``: the finetune model's backbone holds the
    checkpoint; its head keeps its initial weights."""
    from cstp_tpu_torch.cli import main_ft
    from cstp_tpu_torch.train import finetune as ft

    prefix, tensors = written_ckpt
    argv = _loop_argv(tmp_path, "ft_all", prefix)
    out = main_ft.main(argv, device="cpu")
    assert_loaded(out["model"].online_net, tensors)
    from cstp_tpu_torch.config import parse_opts

    init = ft.create_classify_model(parse_opts(argv), N_CLASSES, seed=1,
                                    device="cpu")
    assert torch.equal(out["model"].classify.weight, init.classify.weight)


def test_run_pretrain_loads_the_checkpoint_into_both_towers(tmp_path,
                                                            written_ckpt):
    """``run_pretrain`` with ``--tf_i3d_ckpt`` (one epoch of one step): the
    checkpoint is in both towers before the step; the step then moves the
    online tower."""
    from cstp_tpu_torch.config import parse_opts
    from cstp_tpu_torch.train import loops

    prefix, tensors = written_ckpt
    seen = []
    make_step = loops.make_pretrain_step

    def checked(model, tx, config):
        assert_loaded(model.online_net, tensors)
        assert_loaded(model.target_net, tensors)
        seen.append(True)
        return make_step(model, tx, config)

    cfg = parse_opts(_loop_argv(tmp_path, "loss_com", prefix, n_epochs=1,
                                steps_per_epoch=1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loops, "make_pretrain_step", checked)
        out = loops.run_pretrain(cfg, device="cpu")
    assert seen == [True]
    assert len(out["history"]) == 1
    w = out["model"].online_net.conv3d_1a_7x7.conv.weight.detach()
    assert not torch.equal(w, torch.from_numpy(np.ascontiguousarray(
        tensors["RGB/inception_i3d/Conv3d_1a_7x7/conv_3d/w"].transpose(
            4, 3, 0, 1, 2))))


def test_config_takes_the_flags():
    cfg = Config(model_name="i3d_byol", i3d_conv_head=1,
                 tf_i3d_ckpt="rgb_imagenet/model.ckpt").finalize()
    assert cfg.i3d_conv_head == 1 and cfg.tf_i3d_ckpt
