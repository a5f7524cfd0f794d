"""The port's checkpoints, pretrained-backbone load, plateau schedule and
meters against the JAX package's, on the CPU.

A save/restore round trip is bitwise. ``load_pretrained`` from a port
pretrain checkpoint gives the same finetune logits as the JAX finetune
model with the same pretrained online weights merged in by name (float32,
rtol 1e-4, atol 1e-5, as the classify forward). ``ReduceLROnPlateau``, the
meters and the checkpoint-name helpers are held exactly.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.ckpt import checkpoint as jck
from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.train import meters as jmeters
from cstp_tpu.train.finetune import create_finetune_state as jax_ft_state
from cstp_tpu.train.optim import ReduceLROnPlateau as JaxPlateau
from cstp_tpu.train.pretrain import create_pretrain_state as jax_pt_state
from cstp_tpu_torch.ckpt import checkpoint as ck
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models.bridge import load_jax_variables
from cstp_tpu_torch.train import meters
from cstp_tpu_torch.train.finetune import create_finetune_state
from cstp_tpu_torch.train.optim import ReduceLROnPlateau
from cstp_tpu_torch.train.pretrain import create_pretrain_state

from _torch_threads import torch_threads  # noqa: F401

B, T, S = 4, 4, 32
N_CLASSES = 5


@pytest.fixture
def tmp_path(tmp_path):
    """The test's own directory, removed when the test ends, passed or
    failed: its checkpoints, .pth files and CLI outputs are read back
    inside the test, and left behind they would fill the disk over a
    whole run of the suite."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _kw(**over):
    kw = dict(model_name="r21d", model_depth=1, sample_duration=T,
              sample_size=S, batch_size=B, compute_dtype="float32",
              n_finetune_classes=N_CLASSES)
    kw.update(over)
    return kw


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _perturbed(tree, rng):
    """A BN-statistics tree moved away from its (0, 1) init."""
    def move(path, v):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        return (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """A JAX pretrain state, bridged into a port pretrain state and saved
    as a port checkpoint."""
    jcfg = JaxConfig(**_kw()).finalize()
    _, jstate, _ = jax_pt_state(jcfg, jax.random.PRNGKey(3))
    params = _np_tree(jstate.params)
    stats = _perturbed(_np_tree(jstate.batch_stats), np.random.default_rng(0))
    cfg = Config(**_kw()).finalize()
    model, state, _ = create_pretrain_state(cfg, seed=1, device="cpu")
    load_jax_variables(model, params, stats)
    ckdir = tmp_path_factory.mktemp("ckpt")
    path = str(ckdir / ck.ckpt_name(7))
    ck.save_checkpoint(path, ck.state_tree(state),
                       meta={"arch": cfg.arch, "epoch": 8})
    yield dict(params=params, stats=stats, state=state, path=path, cfg=cfg)
    shutil.rmtree(ckdir, ignore_errors=True)


def test_save_restore_round_trip(pretrained):
    tree, meta = ck.restore_checkpoint(pretrained["path"])
    assert meta == {"arch": "r21d-1", "epoch": 8}
    state = pretrained["state"]
    assert tree["step"] == state.step
    own = state.model.state_dict()
    assert tree["model"].keys() == own.keys()
    for k, v in own.items():
        assert torch.equal(tree["model"][k], v), k
    trace = state.opt_state["trace"]
    assert tree["opt_state"]["trace"].keys() == trace.keys()
    for k, v in trace.items():
        assert torch.equal(tree["opt_state"]["trace"][k], v), k


def test_restore_into_a_target_merges_by_name(pretrained):
    target = {"model": {"a": torch.zeros(2)}, "step": 0, "extra": 5}
    tree, _ = ck.restore_checkpoint(pretrained["path"], target)
    assert tree.keys() == target.keys()
    assert torch.equal(tree["model"]["a"], torch.zeros(2))
    assert tree["step"] == pretrained["state"].step and tree["extra"] == 5


def test_merge_by_name_matches_jax():
    target = {"a": np.zeros(2), "b": {"c": np.ones(3), "d": (1, 2)},
              "e": [np.zeros(1), np.zeros(1)], "f": 7}
    restored = {"a": np.full(2, 3.0), "b": {"c": np.full(3, 4.0),
                                            "d": (5, 6), "x": 1},
                "e": [np.ones(1)], "f": None, "g": 9}
    got = ck._merge_by_name(target, restored)
    want = jck._merge_by_name(target, restored)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)


def test_load_pretrained_gives_the_logits_of_the_merged_jax_weights(
        pretrained):
    kw = _kw(task="ft_all")
    jmodel, jstate, _ = jax_ft_state(JaxConfig(**kw).finalize(),
                                     jax.random.PRNGKey(4), N_CLASSES)
    head_params = _np_tree(jstate.params)
    head_stats = _np_tree(jstate.batch_stats)
    cfg = Config(**kw).finalize()
    model, state, _ = create_finetune_state(cfg, N_CLASSES, device="cpu")
    load_jax_variables(model, head_params, head_stats)
    ck.load_pretrained(state, pretrained["path"], cfg)
    # the JAX loop's load: the finetune tree overlaid by name
    params = jck._merge_by_name(head_params, pretrained["params"])
    stats = jck._merge_by_name(head_stats, pretrained["stats"])
    x = np.random.default_rng(5).uniform(-1, 1, (B, T, S, S, 3)).astype(
        np.float32)
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), train=False)
    got = model(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    # the head kept its initial values
    np.testing.assert_array_equal(model.classify.bias.detach().numpy(),
                                  head_params["classify"]["bias"])


def test_load_pretrained_refuses_another_arch(pretrained, tmp_path):
    path = str(tmp_path / "save_1")
    ck.save_checkpoint(path, ck.state_tree(pretrained["state"]),
                       meta={"arch": "c3d-1"})
    cfg = Config(**_kw(task="ft_all")).finalize()
    _, state, _ = create_finetune_state(cfg, N_CLASSES, device="cpu")
    with pytest.raises(ValueError, match="arch"):
        ck.load_pretrained(state, path, cfg)


def test_checkpoint_names_match_jax(tmp_path):
    for epoch, best in ((0, False), (12, True), (400, False)):
        assert ck.ckpt_name(epoch, best) == jck.ckpt_name(epoch, best)
    for name in ("save_3", "save_12_max", "/a/b/save_7/"):
        assert ck.epoch_from_name(name) == jck.epoch_from_name(name)
    with pytest.raises(ValueError):
        ck.epoch_from_name("last")
    assert ck.latest_checkpoint(str(tmp_path)) is None
    for e in (2, 10, 9):
        os.makedirs(tmp_path / ck.ckpt_name(e))
    open(tmp_path / "save_99", "w").close()          # a file, not a checkpoint
    assert (ck.latest_checkpoint(str(tmp_path))
            == jck.latest_checkpoint(str(tmp_path))
            == str(tmp_path / "save_10"))
    with pytest.raises(FileNotFoundError):
        ck.find_best_checkpoint(str(tmp_path))
    os.makedirs(tmp_path / ck.ckpt_name(4, best=True))
    assert ck.find_best_checkpoint(str(tmp_path)) == jck.find_best_checkpoint(
        str(tmp_path))
    os.makedirs(tmp_path / ck.ckpt_name(5, best=True))
    with pytest.raises(ValueError):
        ck.find_best_checkpoint(str(tmp_path))
    ck.delete_checkpoint(str(tmp_path / "save_2"))
    assert not os.path.exists(tmp_path / "save_2")


@pytest.mark.parametrize("kw", [dict(), dict(patience=2, factor=0.5,
                                             min_lr=0.01)])
def test_plateau_matches_jax(kw):
    rng = np.random.default_rng(6)
    metrics = np.concatenate([np.linspace(5, 1, 10), np.full(30, 1.0),
                              rng.uniform(0.5, 2, 20)])
    got, want = ReduceLROnPlateau(lr=0.1, **kw), JaxPlateau(lr=0.1, **kw)
    for i, m in enumerate(metrics):
        assert got.step(float(m)) == want.step(float(m))
        assert got.state_dict() == want.state_dict()
        if i == 25:
            got = ReduceLROnPlateau.from_state_dict(got.state_dict())
    assert got.lr < 0.1


def test_meters_match_jax(tmp_path):
    got, want = meters.AverageMeter(), jmeters.AverageMeter()
    for v, n in ((2.0, 1), (4.0, 3), (0.5, 2)):
        got.update(v, n)
        want.update(v, n)
        assert (got.val, got.sum, got.count, got.avg) == (
            want.val, want.sum, want.count, want.avg)
    got.reset()
    assert got.avg == 0.0 and got.count == 0
    header = ["epoch", "loss", "acc"]
    rows = [{"epoch": 1, "loss": 1.25, "acc": None},
            {"epoch": 2, "loss": 0.5, "acc": 0.75}]
    for mod, name in ((meters, "port.log"), (jmeters, "jax.log")):
        with mod.Logger(str(tmp_path / name), header) as lg:
            for r in rows:
                lg.log(r)
        with mod.Logger(str(tmp_path / name), header, overlay=False) as lg:
            lg.log(rows[0])
    assert ((tmp_path / "port.log").read_bytes()
            == (tmp_path / "jax.log").read_bytes())
    with meters.Logger(str(tmp_path / "x.log"), header) as lg:
        with pytest.raises(KeyError):
            lg.log({"epoch": 1})
    logits = np.random.default_rng(7).normal(size=(9, 4))
    targets = np.arange(9) % 4
    assert meters.calculate_accuracy(logits, targets) == \
        jmeters.calculate_accuracy(logits, targets)
    assert meters.calculate_accuracy(torch.from_numpy(logits),
                                     torch.from_numpy(targets)) == \
        jmeters.calculate_accuracy(logits, targets)
    timer = meters.StepTimer()
    timer.data_tick()
    timer.batch_tick()
    assert timer.batch_time.count == timer.data_time.count == 1
    assert timer.batch_time.val >= timer.data_time.val >= 0.0
