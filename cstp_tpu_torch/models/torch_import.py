"""Import and export reference PyTorch checkpoints (``save_{E}.pth``).

The port of ``cstp_tpu/models/torch_import.py``, with its own copy of the
name maps. The reference saves ``{'epoch', 'arch', 'state_dict',
'optimizer'}`` with DDP ``module.``-prefixed parameter names
(``main_byol.py:134-140``). :func:`convert_torch_state_dict` translates
those names into the JAX package's Flax-layout tree (``{'params',
'batch_stats'}``, conv DHWIO, dense ``(in, out)``), the tree that
``models/bridge.py`` maps onto the port's modules; :func:`load_into` lays
it over a port model by name (``neq_load_customized``: keys in both load,
model-only keys keep their values, checkpoint-only keys are dropped). So
a reference checkpoint finetunes directly:

    python -m cstp_tpu_torch.cli.main_ft --pretrained_path save_300.pth ...

:func:`export_torch_state_dict` is the inverse: a port checkpoint written
out under the reference's module names, for the reference PyTorch stack.
From the command line (:func:`main`):

    python -m cstp_tpu_torch.models.torch_import save_300.pth out_dir \
        --arch r21d_byol                   # .pth -> port checkpoint
    python -m cstp_tpu_torch.models.torch_import --export ckpt_dir \
        out.pth --arch r21d_byol           # port checkpoint -> .pth

The maps cover the five reference families (r21d, c3d, r3d, s3d, i3d).
SlowFast has none, in the JAX package either: ``slowfast`` and
``slowfast_fb`` raise ``ValueError("unknown model family ...")`` both
ways. As in the JAX package, the S3DClassify MLP head's reference names
``classify.{0,1,3}`` map to no port module (a module path of two parts is
not read as ``classify.N``): a finetune model loaded from such a file
keeps its own head. The ``--legacy_pace`` head of bare ``r21d`` exports as
``classify.{0,1,3}`` and ``pace_bn``; loaded back, ``pace_bn`` loads and
``classify`` keeps its own values, for the same reason.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from cstp_tpu_torch.ckpt.checkpoint import _merge_by_name
from cstp_tpu_torch.models.bridge import (
    _flatten,
    export_state_dict,
    port_name,
    to_port_layout,
)

# Sequential(Linear, BN1d, ReLU, Linear) index -> our MLPHead child
_MLP_IDX = {"0": "fc1", "1": "bn", "3": "fc2"}


def _r21d_path(parts: List[str]) -> List[str]:
    """reference r21d_byol.R2Plus1DNet names -> the Flax r21d paths."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "blocks":  # conv{N}.blocks.K -> block{K+2}
            out.append(f"block{int(parts[i + 1]) + 2}")
            i += 2
            continue
        if p == "project":  # Projector.net.{0,1,3} -> MLPHead children
            out.append("project")
            assert parts[i + 1] == "net"
            out.append(_MLP_IDX[parts[i + 2]])
            i += 3
            continue
        out.append(p)
        i += 1
    return out


def _c3d_path(parts: List[str]) -> List[str]:
    """c3d_byol.C3D: convXy + bnXy -> convXy/{conv,bn}."""
    p = parts[0]
    if p.startswith("bn"):
        return ["conv" + p[2:], "bn"] + parts[1:]
    if p.startswith("conv"):
        return [p, "conv"] + parts[1:]
    return list(parts)


def _r3d_path(parts: List[str]) -> List[str]:
    """BE/r3d_byol.ResNet: layer{i}.{j} -> layer{i}_block{j+1};
    downsample.{0,1} -> downsample_{conv,bn}."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        m = re.fullmatch(r"layer(\d)", p)
        if m and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"layer{m.group(1)}_block{int(parts[i + 1]) + 1}")
            i += 2
            continue
        if p == "downsample":
            out.append("downsample_conv" if parts[i + 1] == "0"
                       else "downsample_bn")
            i += 2
            continue
        out.append(p)
        i += 1
    return out


def _s3d_path(parts: List[str]) -> List[str]:
    """coclr/s3dg.S3D: Mixed branches are Sequentials ->
    branch{K}_{idx} module names; branch0.0 -> branch0."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if re.fullmatch(r"branch[0-3]", p) and i + 1 < len(parts) and \
                parts[i + 1].isdigit():
            idx = parts[i + 1]
            if p == "branch0":
                out.append("branch0")          # Sequential of one
            elif p == "branch3":
                out.append("branch3_1")        # [pool, conv] -> conv only
            else:
                out.append(f"{p}_{idx}")
            i += 2
            continue
        if p == "project":
            out.append("project")
            assert parts[i + 1] == "net"
            out.append(_MLP_IDX[parts[i + 2]])
            i += 3
            continue
        # drop the blockN Sequential aliases (block1..block5 share modules
        # with the named attributes; state_dict emits both)
        out.append(p)
        i += 1
    return out


def _i3d_path(parts: List[str]) -> List[str]:
    """BE/i3d_byol.I3D: Unit3Dpy conv3d/batch3d -> conv/bn; Mixed branch
    Sequentials -> branch_{K}_{idx}."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "conv3d":
            out.append("conv")
            i += 1
            continue
        if p == "batch3d":
            out.append("bn")
            i += 1
            continue
        if re.fullmatch(r"branch_[0-3]", p) and i + 1 < len(parts) and \
                parts[i + 1].isdigit():
            idx = parts[i + 1]
            out.append("branch_3_1" if p == "branch_3" else f"{p}_{idx}")
            i += 2
            continue
        out.append(p)
        i += 1
    return out


_BACKBONE_PATHS = {
    "r21d": _r21d_path,
    "c3d": _c3d_path,
    "r3d": _r3d_path,
    "s3d": _s3d_path,
    "i3d": _i3d_path,
}

# heads whose reference form is Sequential(Linear, BN, ReLU, Linear); our
# PretextHead 'mlp' style nests an MLPHead under "mlp". The r3d/i3d BYOL
# wrappers name the rotation head ``rot_cls`` (r3d_byol.py:253,
# i3d_byol.py:628) where r21d/c3d/s3d use ``rotate_cls`` — both map to our
# canonical ``rotate_cls``.
_PRETEXT_HEADS = ("overlap_spa", "overlap_tem", "pb_cls", "rotate_cls",
                  "rot_cls")
_HEAD_CANON = {"rot_cls": "rotate_cls"}


def _top_path(parts: List[str], family: str, mlp_heads: bool) -> List[str]:
    p = parts[0]
    if p in ("online_net", "target_net"):
        return [p] + _BACKBONE_PATHS[family](parts[1:])
    if p in ("predictor", "prodictor"):
        assert parts[1] == "net"
        return ["predictor", _MLP_IDX[parts[2]]] + parts[3:]
    if p in _PRETEXT_HEADS:
        p = _HEAD_CANON.get(p, p)
        if mlp_heads:  # Sequential directly on the attribute
            return [p, "mlp", _MLP_IDX[parts[1]]] + parts[2:]
        return [p, "fc"] + parts[1:]          # plain nn.Linear
    if p == "cls_bn":
        return ["cls_bn"] + parts[1:]
    if p == "classify":
        if len(parts) > 2 and parts[1].isdigit():  # S3DClassify MLP head
            return ["classify", _MLP_IDX[parts[1]]] + parts[2:]
        return ["classify"] + parts[1:]
    # bare-backbone checkpoints carry backbone modules at top level
    return _BACKBONE_PATHS[family](parts)


def _set(tree: Dict, path: List[str], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def convert_torch_state_dict(
    sd: Dict[str, Any], arch: str
) -> Dict[str, Dict]:
    """Translate a reference state_dict to ``{'params': ..., 'batch_stats':
    ...}`` nested numpy trees (laid over a port model by
    :func:`load_into`).

    ``arch`` is the reference model_name ('r21d_byol', 's3d_classify', ...)
    or a bare family name.
    """
    family = arch.split("_")[0]
    if family not in _BACKBONE_PATHS:
        raise ValueError(f"unknown model family {arch!r}")
    mlp_heads = family in ("r21d", "s3d")  # r21d_byol.py:276-291 vs Linear

    def to_np(v):
        if hasattr(v, "detach"):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    # group by module prefix; BN modules are those with running stats
    modules: Dict[str, Dict[str, Any]] = {}
    for key, val in sd.items():
        if key.startswith("module."):
            key = key[len("module."):]
        parts = key.split(".")
        leaf = parts[-1]
        if leaf == "num_batches_tracked":
            continue
        prefix = ".".join(parts[:-1])
        modules.setdefault(prefix, {})[leaf] = to_np(val)

    params: Dict = {}
    stats: Dict = {}
    for prefix, leaves in modules.items():
        parts = prefix.split(".")
        # coclr S3D registers blockN Sequential ALIASES of the named modules
        # (s3dg.py:181-230) — state_dict emits each tensor twice; keep the
        # canonical names only. Same for backbone-nested aliases.
        bi = 1 if parts[0] in ("online_net", "target_net") else 0
        if family == "s3d" and re.fullmatch(r"block[1-5]", parts[bi]):
            continue
        path = _top_path(parts, family, mlp_heads)
        is_bn = "running_mean" in leaves
        if is_bn:
            # our BatchNorm module wraps an inner module named 'bn'
            path = path + ["bn"]
            _set(params, path + ["scale"], leaves["weight"])
            _set(params, path + ["bias"], leaves["bias"])
            _set(stats, path + ["mean"], leaves["running_mean"])
            _set(stats, path + ["var"], leaves["running_var"])
            continue
        w = leaves.get("weight")
        if w is None:
            continue
        if w.ndim == 5:    # conv OIDHW -> DHWIO
            _set(params, path + ["kernel"], np.transpose(w, (2, 3, 4, 1, 0)))
        elif w.ndim == 2:  # linear (out,in) -> (in,out)
            _set(params, path + ["kernel"], w.T)
        else:
            _set(params, path + ["scale"], w)
        if "bias" in leaves:
            _set(params, path + ["bias"], leaves["bias"])
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path: str, arch: str) -> Tuple[Dict, Dict]:
    """A reference ``save_{E}.pth`` -> ``(converted tree, meta)``; meta
    holds the blob's ``epoch`` and ``arch``."""
    try:
        # weights_only=True unpickles tensors and plain containers only,
        # which is what a reference save_{E}.pth holds
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        import warnings

        warnings.warn(
            f"{path!r} is not loadable with weights_only=True; falling back "
            "to the full unpickler, which EXECUTES code embedded in the "
            "checkpoint — only proceed with checkpoints you trust.")
        blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    meta = {}
    if isinstance(blob, dict):
        meta = {k: blob[k] for k in ("epoch", "arch") if k in blob}
    return convert_torch_state_dict(sd, arch), meta


def port_state_dict(tree: Dict[str, Dict]) -> Dict[str, torch.Tensor]:
    """A converted tree -> ``{port tensor name: tensor}`` in the port's
    layouts (``models/bridge.py``); the BatchNorm modules are those with
    running statistics in ``tree['batch_stats']``."""
    owners = {".".join(p[:-2]) for p, _ in _flatten(tree["batch_stats"])}
    return {port_name(path, owners): torch.from_numpy(
                np.ascontiguousarray(to_port_layout(leaf)))
            for col in ("params", "batch_stats")
            for path, leaf in _flatten(tree[col])}


def load_into(model: torch.nn.Module, tree: Dict[str, Dict]) -> None:
    """Lay a converted tree over ``model`` by name, in place."""
    own = model.state_dict()
    model.load_state_dict(_merge_by_name(own, port_state_dict(tree)))


# ---------------------------------------------------------------------------
# Export: Flax tree -> reference torch state_dict (inverse of the maps above)
# ---------------------------------------------------------------------------

_MLP_IDX_INV = {v: k for k, v in _MLP_IDX.items()}  # fc1->0, bn->1, fc2->3


def _inv_r21d(parts: List[str]) -> List[str]:
    out: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        m = re.fullmatch(r"block(\d+)", p)
        if m and int(m.group(1)) >= 2:
            out += ["blocks", str(int(m.group(1)) - 2)]
        elif p == "project":
            out += ["project", "net", _MLP_IDX_INV[parts[i + 1]]]
            i += 2
            continue
        else:
            out.append(p)
        i += 1
    return out


def _inv_c3d(parts: List[str]) -> List[str]:
    if len(parts) >= 2 and parts[0].startswith("conv"):
        if parts[1] == "bn":
            return ["bn" + parts[0][4:]] + list(parts[2:])
        if parts[1] == "conv":
            return [parts[0]] + list(parts[2:])
    return list(parts)


def _inv_r3d(parts: List[str]) -> List[str]:
    out: List[str] = []
    for p in parts:
        m = re.fullmatch(r"layer(\d)_block(\d+)", p)
        if m:
            out += [f"layer{m.group(1)}", str(int(m.group(2)) - 1)]
        elif p == "downsample_conv":
            out += ["downsample", "0"]
        elif p == "downsample_bn":
            out += ["downsample", "1"]
        else:
            out.append(p)
    return out


def _inv_s3d(parts: List[str]) -> List[str]:
    out: List[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "branch0":
            out += ["branch0", "0"]
        elif p == "branch3_1":
            out += ["branch3", "1"]
        elif re.fullmatch(r"branch[12]_\d+", p):
            b, idx = p.split("_")
            out += [b, idx]
        elif p == "project":
            out += ["project", "net", _MLP_IDX_INV[parts[i + 1]]]
            i += 2
            continue
        else:
            out.append(p)
        i += 1
    return out


def _inv_i3d(parts: List[str]) -> List[str]:
    out: List[str] = []
    for p in parts:
        if p == "conv":
            out.append("conv3d")
        elif p == "bn":
            out.append("batch3d")
        elif p == "branch_3_1":
            out += ["branch_3", "1"]
        elif re.fullmatch(r"branch_[0-2]_\d+", p):
            b0, b1, idx = p.split("_")
            out += [f"{b0}_{b1}", idx]
        else:
            out.append(p)
    return out


_BACKBONE_INV = {
    "r21d": _inv_r21d,
    "c3d": _inv_c3d,
    "r3d": _inv_r3d,
    "s3d": _inv_s3d,
    "i3d": _inv_i3d,
}


def _inv_top_path(path: List[str], family: str, mlp_heads: bool) -> List[str]:
    inv = _BACKBONE_INV[family]
    p = path[0]
    if p in ("online_net", "target_net"):
        return [p] + inv(path[1:])
    if p == "predictor":
        return ["predictor", "net", _MLP_IDX_INV[path[1]]] + path[2:]
    if p in _PRETEXT_HEADS:
        # r3d/i3d name the rotation head ``rot_cls`` (r3d_byol.py:253)
        name = ("rot_cls" if p == "rotate_cls" and family in ("r3d", "i3d")
                else p)
        if mlp_heads:
            assert path[1] == "mlp", path
            return [name, _MLP_IDX_INV[path[2]]] + path[3:]
        assert path[1] == "fc", path
        return [name] + path[2:]
    if p == "cls_bn":
        return ["cls_bn"] + path[1:]
    if p == "classify":
        if len(path) > 1 and path[1] in _MLP_IDX_INV:  # S3DClassify MLP head
            return ["classify", _MLP_IDX_INV[path[1]]] + path[2:]
        return ["classify"] + path[1:]
    return inv(path)


def _walk_modules(params: Dict, stats: Dict):
    """Yield ``(module_path, kind, leaves)`` over a Flax tree.

    kind 'dense' = conv/linear (has ``kernel``), 'bn' = our BatchNorm wrapper
    (child ``bn`` holding scale/bias, running stats in the parallel
    ``batch_stats`` tree), 'scale' = bare scale/bias module.
    """
    def rec(pnode, snode, path):
        if not isinstance(pnode, dict):
            return
        if "kernel" in pnode and not isinstance(pnode["kernel"], dict):
            yield path, "dense", pnode
            return
        inner = pnode.get("bn")
        if isinstance(inner, dict) and "scale" in inner:
            sin = snode.get("bn", {}) if isinstance(snode, dict) else {}
            yield path, "bn", {
                "weight": inner["scale"], "bias": inner.get("bias"),
                "running_mean": sin.get("mean"), "running_var": sin.get("var"),
            }
            rest = {k: v for k, v in pnode.items() if k != "bn"}
            pnode = rest
        elif "scale" in pnode and not isinstance(pnode["scale"], dict):
            yield path, "scale", pnode
            return
        for k, v in pnode.items():
            yield from rec(
                v, snode.get(k) if isinstance(snode, dict) else {}, path + [k])
    yield from rec(params, stats, [])


def export_torch_state_dict(tree: Dict[str, Dict], arch: str,
                            ddp_prefix: bool = False) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_torch_state_dict`: a ``{'params',
    'batch_stats'}`` Flax tree -> a reference-named torch-layout state_dict
    (numpy values; conv DHWIO -> OIDHW, linear (in,out) -> (out,in)).

    BN modules also emit ``num_batches_tracked`` (0) so the dict satisfies
    strict ``load_state_dict`` in the reference models. ``ddp_prefix`` adds
    the DDP ``module.`` prefix the reference's own ``torch.save`` blobs carry
    (main_byol.py:134-140). The only reference keys never emitted are the
    coclr-S3D ``blockN`` Sequential ALIASES (s3dg.py:181-230) — they share
    storage with the canonical modules, so loading the canonical names loads
    them too (strict=False).
    """
    family = arch.split("_")[0]
    if family not in _BACKBONE_INV:
        raise ValueError(f"unknown model family {arch!r}")
    mlp_heads = family in ("r21d", "s3d")
    params = tree.get("params", {})
    stats = tree.get("batch_stats", {})

    sd: Dict[str, np.ndarray] = {}
    pre = "module." if ddp_prefix else ""
    for path, kind, leaves in _walk_modules(params, stats):
        prefix = pre + ".".join(_inv_top_path(path, family, mlp_heads))
        if kind == "bn":
            sd[f"{prefix}.weight"] = np.asarray(leaves["weight"])
            if leaves.get("bias") is not None:
                sd[f"{prefix}.bias"] = np.asarray(leaves["bias"])
            if leaves.get("running_mean") is not None:
                sd[f"{prefix}.running_mean"] = np.asarray(
                    leaves["running_mean"])
                sd[f"{prefix}.running_var"] = np.asarray(leaves["running_var"])
                sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)
            continue
        if kind == "scale":
            sd[f"{prefix}.weight"] = np.asarray(leaves["scale"])
            if "bias" in leaves:
                sd[f"{prefix}.bias"] = np.asarray(leaves["bias"])
            continue
        k = np.asarray(leaves["kernel"])
        if k.ndim == 5:    # DHWIO -> OIDHW
            sd[f"{prefix}.weight"] = np.transpose(k, (4, 3, 0, 1, 2))
        elif k.ndim == 2:  # (in,out) -> (out,in)
            sd[f"{prefix}.weight"] = k.T
        else:
            raise ValueError(f"unexpected kernel rank {k.ndim} at {prefix}")
        if "bias" in leaves:
            sd[f"{prefix}.bias"] = np.asarray(leaves["bias"])
    return sd


def save_torch_checkpoint(out_path: str, tree: Dict[str, Dict], arch: str,
                          epoch: int = 0, ddp_prefix: bool = True) -> int:
    """Write a reference-format ``save_{E}.pth`` blob (epoch/arch/state_dict,
    DDP-prefixed names — main_byol.py:134-140) from a Flax tree. Returns the
    tensor count."""
    import torch

    sd = export_torch_state_dict(tree, arch, ddp_prefix=ddp_prefix)
    blob = {
        "epoch": epoch,
        "arch": arch,
        "state_dict": {k: torch.as_tensor(np.ascontiguousarray(v))
                       for k, v in sd.items()},
    }
    torch.save(blob, out_path)
    return len(sd)


def main(argv=None):
    """Convert reference .pth <-> port checkpoint directories.

        # import: reference save_300.pth -> port checkpoint dir
        python -m cstp_tpu_torch.models.torch_import save_300.pth out_dir \
            --arch r21d_byol

        # export: port checkpoint dir -> reference-format .pth
        python -m cstp_tpu_torch.models.torch_import --export ckpt_dir \
            out.pth --arch r21d_byol
    """
    import argparse

    from cstp_tpu_torch.ckpt.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("src")
    ap.add_argument("out")
    ap.add_argument("--arch", default="r21d_byol")
    ap.add_argument("--export", action="store_true",
                    help="src is a port checkpoint dir; write a "
                         "reference-format .pth to out")
    ap.add_argument("--epoch", type=int, default=0)
    args = ap.parse_args(argv)
    if args.export:
        tree, meta = restore_checkpoint(args.src)
        epoch = args.epoch or int(meta.get("epoch", 0) or 0)
        n = save_torch_checkpoint(args.out, export_state_dict(tree["model"]),
                                  args.arch, epoch=epoch)
        print(f"exported {n} tensors -> {args.out}")
        return
    tree, meta = load_torch_checkpoint(args.src, args.arch)
    meta.setdefault("arch", args.arch)
    meta["source"] = args.src
    sd = port_state_dict(tree)
    save_checkpoint(args.out, {"model": sd}, meta)
    print(f"converted {len(sd)} tensors -> {args.out}")


if __name__ == "__main__":
    main()
