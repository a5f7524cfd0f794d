"""The port's reference-checkpoint importer (``models/torch_import.py``)
against the JAX package's, on the CPU.

The reference-format checkpoints (``save_{E}.pth``: ``module.``-prefixed
names, ``num_batches_tracked``) are written by the JAX package's
``save_torch_checkpoint`` from JAX model trees at a small size; no file is
downloaded. The trees of the five families' pretrain and finetune models
take JAX's structure (``eval_shape`` of ``init``) and numpy-seeded values,
so every leaf is distinct; the output comparisons use JAX-initialised
weights.

Tolerances: converted and exported trees exactly equal; the outputs of a
loaded model rtol 1e-4, atol 1e-5 (a float32 forward in another
convolution and reduction order); loaded weights bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstp_tpu.config import Config as JaxConfig
from cstp_tpu.models import torch_import as jti
from cstp_tpu.ssl.byol import CSTPClassify as JaxClassify
from cstp_tpu.ssl.byol import CSTPPretrain as JaxPretrain
from cstp_tpu.train import loops as jloops
from cstp_tpu_torch.ckpt import checkpoint as ck
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models import torch_import as pti
from cstp_tpu_torch.models.bridge import (
    export_jax_variables,
    export_state_dict,
    load_jax_variables,
)
from cstp_tpu_torch.ssl.byol import CSTPClassify, CSTPPretrain
from cstp_tpu_torch.train import loops

B, T, S = 4, 8, 32
N_CLASSES = 6
# family -> (model_name, depth)
FAMILIES = {"r21d": ("r21d_byol", 1), "c3d": ("c3d_byol", 1),
            "r3d": ("r3d_byol", 18), "s3d": ("s3d_byol", 1),
            "i3d": ("i3d_byol", 1)}
PORTED = ("r21d", "c3d", "r3d")


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _jax_module(fam, kind):
    name, depth = FAMILIES[fam]
    if kind == "pretrain":
        return JaxPretrain(backbone=name, depth=depth, dtype=jnp.float32)
    if kind == "classify-mlp":
        return JaxClassify(backbone=f"{fam}_classify", depth=depth,
                           num_classes=N_CLASSES, head_style="mlp",
                           dtype=jnp.float32)
    return JaxClassify(backbone=name, depth=depth, num_classes=N_CLASSES,
                       dtype=jnp.float32)


def _init_args(kind):
    x = jnp.zeros((2, T, S, S, 3), jnp.float32)
    return (x, x, True) if kind == "pretrain" else (x, True)


def _seeded_tree(fam, kind, seed=0):
    """JAX's variable structure for the model, numpy-seeded values (BN
    variances positive)."""
    m = _jax_module(fam, kind)
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                           *_init_args(kind)))
    rng = np.random.default_rng(seed)
    out = {}
    for col in ("params", "batch_stats"):
        out[col] = jax.tree_util.tree_map_with_path(
            lambda p, s: (rng.uniform(0.5, 1.5, s.shape) if
                          jax.tree_util.keystr(p).endswith("['var']")
                          else rng.normal(size=s.shape)).astype(np.float32),
            shapes[col])
    return out


def _arch(fam, kind):
    return f"{fam}_classify" if kind == "classify-mlp" else FAMILIES[fam][0]


TREE_CASES = [(f, k) for f in FAMILIES for k in ("pretrain", "classify")] \
    + [("s3d", "classify-mlp")]


@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    """Per case: the seeded tree and its reference .pth (JAX's writer)."""
    d = tmp_path_factory.mktemp("pth")
    out = {}
    for fam, kind in TREE_CASES:
        tree = _seeded_tree(fam, kind)
        path = str(d / f"{fam}_{kind}.pth")
        jti.save_torch_checkpoint(path, tree, _arch(fam, kind), epoch=300)
        out[fam, kind] = (tree, path)
    return out


@pytest.mark.parametrize("fam, kind", TREE_CASES,
                         ids=[f"{f}-{k}" for f, k in TREE_CASES])
def test_convert_matches_jax(reference_files, fam, kind):
    """The port's tree equals JAX's leaf for leaf, and both are the tree
    the file was written from: r3d/i3d's ``rot_cls`` comes back as
    ``rotate_cls``."""
    tree, path = reference_files[fam, kind]
    arch = _arch(fam, kind)
    sd = torch.load(path, weights_only=True)["state_dict"]
    assert all(k.startswith("module.") for k in sd)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    if kind == "pretrain":
        head = "rot_cls" if fam in ("r3d", "i3d") else "rotate_cls"
        assert any(k.startswith(f"module.{head}.") for k in sd)
    got = pti.convert_torch_state_dict(sd, arch)
    _assert_trees_equal(got, jti.convert_torch_state_dict(sd, arch))
    if kind == "classify-mlp":
        # both packages leave the MLP head's modules ``classify.{0,1,3}``
        # unmapped (``_top_path`` maps ``classify.N`` only below a module
        # path of 3 parts): the head comes back under its reference
        # indices, so a load keeps the model's own head
        for col in ("params", "batch_stats"):
            assert set(got[col].pop("classify")) <= {"0", "1", "3"}
            tree = {**tree, col: {k: v for k, v in tree[col].items()
                                  if k != "classify"}}
    _assert_trees_equal(got, tree)
    got_meta = pti.load_torch_checkpoint(path, arch)[1]
    assert got_meta == jti.load_torch_checkpoint(path, arch)[1] == {
        "epoch": 300, "arch": arch}


def test_convert_drops_the_s3d_block_aliases(reference_files):
    """coclr S3D's ``blockN`` Sequentials alias the named modules, so its
    state_dict holds each tensor twice: both packages keep the canonical
    names."""
    tree, path = reference_files["s3d", "pretrain"]
    sd = torch.load(path, weights_only=True)["state_dict"]
    aliased = dict(sd)
    for k, v in sd.items():
        for net in ("online_net", "target_net"):
            if k.startswith(f"module.{net}.Conv_1a."):
                aliased[k.replace(f"{net}.Conv_1a.", f"{net}.block1.0.")] = v
    assert len(aliased) > len(sd)
    got = pti.convert_torch_state_dict(aliased, "s3d_byol")
    _assert_trees_equal(got, jti.convert_torch_state_dict(aliased,
                                                          "s3d_byol"))
    _assert_trees_equal(got, tree)


@pytest.mark.parametrize("kind", ["pretrain", "classify"])
@pytest.mark.parametrize("fam", PORTED)
def test_export_of_a_port_model_matches_jax(reference_files, fam, kind):
    """A port model holding the tree's weights exports (through the
    bridge) the reference state_dict JAX exports from the tree."""
    tree, _ = reference_files[fam, kind]
    name, depth = FAMILIES[fam]
    if kind == "pretrain":
        model = CSTPPretrain(name, depth, torch.float32)
    else:
        model = CSTPClassify(name, depth, N_CLASSES, dtype=torch.float32)
    load_jax_variables(model, tree["params"], tree["batch_stats"])
    arch = _arch(fam, kind)
    got = pti.export_torch_state_dict(export_state_dict(model.state_dict()),
                                      arch, ddp_prefix=True)
    want = jti.export_torch_state_dict(tree, arch, ddp_prefix=True)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fam", PORTED)
def test_a_pth_loaded_into_a_port_model_gives_the_jax_outputs(tmp_path, fam):
    """JAX-initialised pretrain weights written as a reference .pth and laid
    over a port model (initialised from another seed) give the JAX model's
    loss, logits and running statistics."""
    name, depth = FAMILIES[fam]
    jmodel = _jax_module(fam, "pretrain")
    rng = np.random.default_rng(1)
    x1 = rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32)
    variables = jax.jit(jmodel.init, static_argnums=3)(
        jax.random.PRNGKey(2), jnp.asarray(x1), jnp.asarray(x2), True)
    path = str(tmp_path / "save_1.pth")
    jti.save_torch_checkpoint(path, jax.device_get(variables), name)
    model = CSTPPretrain(name, depth, torch.float32,
                         gen=torch.Generator().manual_seed(9))
    tree, _ = pti.load_torch_checkpoint(path, name)
    pti.load_into(model, tree)
    (jloss, jout), mutated = jmodel.apply(
        variables, jnp.asarray(x1), jnp.asarray(x2), True,
        mutable=["batch_stats"])
    loss, out = model(torch.from_numpy(x1), torch.from_numpy(x2), True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4,
                               atol=1e-5)
    for g, w in zip(out, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)
    _, stats = export_jax_variables(model)
    g, w = _flat(stats), _flat(jax.device_get(mutated["batch_stats"]))
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _loop_kw(tmp_path, name, depth, **over):
    kw = dict(model_name=name, model_depth=depth, sample_duration=T,
              sample_size=S, batch_size=8, compute_dtype="float32",
              data_backend="synthetic", synthetic_len=4, n_classes=N_CLASSES,
              n_finetune_classes=N_CLASSES, result_path=str(tmp_path),
              n_workers=1, log_every=0, n_epochs=0)
    kw.update(over)
    return kw


def _online(tree):
    return {"params": tree["params"]["online_net"],
            "batch_stats": tree["batch_stats"]["online_net"]}


class _Loaded(Exception):
    pass


@pytest.mark.parametrize("fam", PORTED)
def test_finetune_and_retrieval_load_a_pth_as_jax_does(
        reference_files, tmp_path, monkeypatch, fam):
    """``--pretrained_path <file>.pth``: run_finetune (no epoch) and
    run_retrieval (stopped once its weights are loaded) hold bitwise the
    ``online_net`` weights and statistics JAX's run_finetune loads from the
    same file; the head keeps its initial values."""
    _, path = reference_files[fam, "pretrain"]
    name, depth = FAMILIES[fam]
    kw = _loop_kw(tmp_path, name, depth, task="ft_all", pretrained_path=path)
    jstate = jloops.run_finetune(JaxConfig(**kw).finalize())["state"]
    want = _online({"params": jax.device_get(jstate.params),
                    "batch_stats": jax.device_get(jstate.batch_stats)})
    cfg = Config(**kw).finalize()
    ft = loops.run_finetune(cfg, device="cpu")
    params, stats = export_jax_variables(ft["model"])
    _assert_trees_equal(_online({"params": params, "batch_stats": stats}),
                        want)
    init = loops.create_finetune_state(cfg, N_CLASSES, seed=cfg.manual_seed,
                                       device="cpu")[0]
    assert torch.equal(ft["model"].classify.weight, init.classify.weight)

    def stop(model, config):
        p, s = export_jax_variables(model)
        _assert_trees_equal(_online({"params": p, "batch_stats": s}), want)
        raise _Loaded

    monkeypatch.setattr(loops, "make_features_step", stop)
    with pytest.raises(_Loaded):
        loops.run_retrieval(Config(**_loop_kw(
            tmp_path, name, depth, task="retrieval",
            pretrained_path=path)).finalize(), device="cpu")


def test_a_pth_of_another_arch_is_refused_as_in_jax(reference_files,
                                                    tmp_path):
    """An r21d file whose arch tag says r3d: both packages convert it and
    refuse it on the tag."""
    _, src = reference_files["r21d", "pretrain"]
    blob = torch.load(src, weights_only=True)
    blob["arch"] = "r3d_byol"
    path = str(tmp_path / "save_1.pth")
    torch.save(blob, path)
    kw = _loop_kw(tmp_path, "r21d_byol", 1, task="ft_all",
                  pretrained_path=path)
    with pytest.raises(AssertionError):
        jloops.run_finetune(JaxConfig(**kw).finalize())
    with pytest.raises(ValueError, match="arch"):
        loops.run_finetune(Config(**kw).finalize(), device="cpu")


@pytest.mark.parametrize("fam", PORTED)
def test_main_round_trips_a_pth(reference_files, tmp_path, fam):
    """``.pth`` -> port checkpoint -> ``--export`` ``.pth`` gives the same
    tensors under the same names; the port checkpoint loads by name into a
    finetune state."""
    _, path = reference_files[fam, "pretrain"]
    name, depth = FAMILIES[fam]
    ckpt, out = str(tmp_path / "save_300"), str(tmp_path / "out.pth")
    pti.main([path, ckpt, "--arch", name])
    pti.main(["--export", ckpt, out, "--arch", name])
    a = torch.load(path, weights_only=True)
    b = torch.load(out, weights_only=True)
    assert b["epoch"] == a["epoch"] == 300 and b["arch"] == name
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for k, v in a["state_dict"].items():
        assert torch.equal(b["state_dict"][k], v), k
    cfg = Config(**_loop_kw(tmp_path, name, depth, task="ft_all")).finalize()
    _, state, _ = loops.create_finetune_state(cfg, N_CLASSES, device="cpu")
    ck.load_pretrained(state, ckpt, cfg)
    want = _online(pti.load_torch_checkpoint(path, name)[0])
    for col in want.values():             # r21d's projector: pretrain only
        col.pop("project", None)
    got = export_jax_variables(state.model)
    _assert_trees_equal(_online({"params": got[0], "batch_stats": got[1]}),
                        want)
