"""Checkpoint save/restore with the reference's naming, on ``torch.save``.

The port of ``cstp_tpu/ckpt/checkpoint.py``. A checkpoint is a directory:
``<path>/tree.pt`` (a nested dict of CPU tensors and Python scalars,
written by ``torch.save`` and read back with ``weights_only=True``) and
``<path>/meta.json`` (arch, epoch, scheduler state and other JSON-able
metadata). Names: ``save_{epoch}`` (pretrain), ``save_{epoch}_max`` (the
best finetune epoch; the test step finds exactly one). Restoring into a
target tree is by name (:func:`_merge_by_name`). A train state's tree is
:func:`state_tree`: ``{"model": state_dict, "opt_state": ..., "step":
...}``, with the whole tensors of a one-process run on any mesh (the
tensor-parallel and ZeRO slices gathered), so a checkpoint crosses
topologies both ways.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from cstp_tpu_torch.config import Config
from cstp_tpu_torch.parallel.mesh import full_state_dict


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def state_tree(state, tx=None) -> Dict[str, Any]:
    """The tree of a ``TrainState``: model parameters and BN statistics,
    the optimizer's state and the step count, as whole tensors: on a mesh
    that splits them (tensor-parallel heads; ``tx`` a
    ``train.optim.MeshUpdate``) every rank calls it, a collective, before
    rank 0 saves it."""
    opt = state.opt_state
    if hasattr(tx, "gather_state"):
        opt = tx.gather_state(opt)
    return {"model": full_state_dict(state.model), "opt_state": opt,
            "step": state.step}


def save_checkpoint(path: str, tree: Dict[str, Any],
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Save a tree of tensors and JSON metadata at ``path`` (a directory,
    replaced if it exists)."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    tree = {k: v for k, v in tree.items() if v is not None}
    torch.save(_to_cpu(tree), os.path.join(path, "tree.pt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta or {}, f)
    return path


def restore_checkpoint(path: str, target: Optional[Dict[str, Any]] = None
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(tree, meta)`` with CPU tensors. With ``target``, the tree is laid
    over the target by name (a partial load is allowed)."""
    path = os.path.abspath(path)
    restored = torch.load(os.path.join(path, "tree.pt"), map_location="cpu",
                          weights_only=True)
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if target is not None:
        restored = _merge_by_name(target, restored)
    return restored, meta


def _merge_by_name(target, restored):
    """Lay ``restored`` over ``target`` by dict key, recursively (the
    reference's ``neq_load_customized``): keys in both are loaded,
    target-only keys keep their value, restored-only keys are dropped.
    Sequences merge element-wise when their lengths agree."""
    if isinstance(target, dict) and isinstance(restored, dict):
        return {k: _merge_by_name(v, restored[k]) if k in restored else v
                for k, v in target.items()}
    if isinstance(target, (tuple, list)):
        if (not isinstance(restored, (tuple, list))
                or len(restored) != len(target)):
            return target
        return type(target)(_merge_by_name(t, r)
                            for t, r in zip(target, restored))
    if restored is None:
        return target
    return restored


def load_model_by_name(model, tree) -> None:
    """Load ``tree["model"]`` (a checkpoint's state dict) into ``model`` by
    name: names only the model has (a new head, an uncalibrated
    ``act_scale``) keep their values, names only the checkpoint has are
    dropped."""
    model.load_state_dict(_merge_by_name(model.state_dict(), tree["model"]))


def check_arch(path: str, meta: Dict[str, Any], config: Config) -> None:
    """Refuse a checkpoint whose arch tag and ``config.arch`` contain
    neither the other (the JAX package's check; a tagless one passes)."""
    arch = str(meta.get("arch", config.arch))
    if config.arch not in arch and arch not in config.arch:
        raise ValueError(f"checkpoint {path} holds arch {arch!r}, the config "
                         f"asks for {config.arch!r}")


def load_pretrained(state, path: str, config: Config):
    """Load a checkpoint's tensors into ``state.model`` by name: a pretrain
    checkpoint gives a finetune state its ``online_net.*`` parameters and BN
    statistics, and the head keeps its initial values. Refuses a checkpoint
    whose arch tag and ``config.arch`` contain neither the other (the JAX
    package's check). Returns ``state``."""
    tree, meta = restore_checkpoint(path)
    check_arch(path, meta, config)
    load_model_by_name(state.model, tree)
    return state


def ckpt_name(epoch: int, best: bool = False) -> str:
    return f"save_{epoch}_max" if best else f"save_{epoch}"


def epoch_from_name(path: str) -> int:
    """The epoch in a ``save_{epoch}[...]`` name."""
    m = re.search(r"save_(\d+)", os.path.basename(os.path.normpath(path)))
    if not m:
        raise ValueError(f"cannot parse epoch from {path!r}")
    return int(m.group(1))


def latest_checkpoint(result_dir: str) -> Optional[str]:
    cands = [c for c in glob.glob(os.path.join(result_dir, "save_*"))
             if os.path.isdir(c)]
    if not cands:
        return None
    return max(cands, key=epoch_from_name)


def find_best_checkpoint(result_dir: str) -> str:
    """The one ``*_max`` checkpoint under ``result_dir``."""
    cands = [c for c in glob.glob(os.path.join(result_dir, "*_max"))
             if os.path.isdir(c)]
    if len(cands) > 1:
        raise ValueError("Too many models in result path")
    if not cands:
        raise FileNotFoundError(f"no *_max checkpoint under {result_dir}")
    return cands[0]


def delete_checkpoint(path: str) -> None:
    if path and os.path.isdir(path):
        shutil.rmtree(path)
