"""Weight bridge between the JAX package's Flax variables and the port.

Port module names follow the Flax names, so the map is a path rename:

* ``a/b/kernel`` (conv, DHWIO) -> ``a.b.weight`` (OIDHW);
* ``a/b/kernel`` (dense, ``(in, out)``) -> ``a.b.weight`` (``(out, in)``);
* ``a/b/bias`` (dense) -> ``a.b.bias``;
* BatchNorm leaves ``a/bn/{scale, bias}`` (params) and ``a/bn/{mean, var}``
  (batch_stats) -> ``a.{scale, bias, mean, var}``: every Flax BatchNorm of
  the JAX package nests its body under an inner module named ``bn``.

Every leaf maps to exactly one port tensor; a leaf left unused or a port
tensor left unset raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from cstp_tpu_torch.models.layers import BatchNorm

_BN_PARAMS = ("scale", "bias")
_BN_STATS = ("mean", "var")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _bn_owners(module: nn.Module):
    return {name for name, m in module.named_modules()
            if isinstance(m, BatchNorm)}


def port_name(path: Tuple[str, ...], bn_owners) -> str:
    """Port tensor name of a Flax leaf path."""
    if (len(path) >= 2 and path[-2] == "bn"
            and ".".join(path[:-2]) in bn_owners):
        return ".".join(path[:-2] + path[-1:])
    if path[-1] == "kernel":
        return ".".join(path[:-1] + ("weight",))
    return ".".join(path)


def jax_path(name: str, bn_owners) -> Tuple[str, ...]:
    """Flax leaf path of a port tensor name (the inverse of
    :func:`port_name`)."""
    parts = tuple(name.split("."))
    owner = ".".join(parts[:-1])
    if owner in bn_owners and parts[-1] in _BN_PARAMS + _BN_STATS:
        return parts[:-1] + ("bn", parts[-1])
    if parts[-1] == "weight":
        return parts[:-1] + ("kernel",)
    return parts


def to_port_layout(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == 5:            # DHWIO -> OIDHW
        return a.transpose(4, 3, 0, 1, 2)
    if a.ndim == 2:            # (in, out) -> (out, in)
        return a.T
    return a


def to_jax_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 5:            # OIDHW -> DHWIO
        return a.transpose(2, 3, 4, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


def load_jax_variables(module: nn.Module, params: Mapping,
                       batch_stats: Mapping) -> None:
    """Copy Flax ``params`` / ``batch_stats`` (nested dicts of arrays) into
    ``module``'s parameters and BN buffers, in place."""
    owners = _bn_owners(module)
    targets: Dict[str, torch.Tensor] = dict(module.named_parameters())
    targets.update((n, b) for n, b in module.named_buffers())
    unset = set(targets)
    unused = []
    for collection in (params, batch_stats):
        for path, leaf in _flatten(collection):
            name = port_name(path, owners)
            t = targets.get(name)
            if t is None or name not in unset:
                unused.append("/".join(path))
                continue
            a = to_port_layout(leaf)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join(path)}: shape {a.shape} does not"
                                 f" fit {name} {tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
            unset.discard(name)
    if unused or unset:
        raise ValueError(f"weight bridge: Flax leaves without a port tensor: "
                         f"{sorted(unused)}; port tensors left unset: "
                         f"{sorted(unset)}")


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def export_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """A port ``state_dict`` as ``{'params', 'batch_stats'}``, Flax-layout
    nested dicts of numpy arrays. The BatchNorm modules are those holding
    both running statistics (``mean`` and ``var`` buffers), the port's only
    buffers."""
    def split(n):
        return tuple(n.rsplit(".", 1)) if "." in n else ("", n)

    owners = ({o for o, leaf in map(split, sd) if leaf == "mean"}
              & {o for o, leaf in map(split, sd) if leaf == "var"})
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for n, t in sd.items():
        owner, leaf = split(n)
        col = ("batch_stats" if owner in owners and leaf in _BN_STATS
               else "params")
        tree[col][jax_path(n, owners)] = to_jax_layout(
            t.detach().float().cpu().numpy())
    return {k: _nest(v) for k, v in tree.items()}


def export_jax_variables(module: nn.Module):
    """``(params, batch_stats)`` of ``module`` as Flax-layout nested dicts
    of numpy arrays."""
    tree = export_state_dict(module.state_dict())
    return tree["params"], tree["batch_stats"]


def export_named(module: nn.Module, tensors: Mapping[str, torch.Tensor]):
    """Nest a ``{port parameter name: tensor}`` map (e.g. the optimizer's
    momentum trace) in Flax layout."""
    owners = _bn_owners(module)
    return _nest({jax_path(n, owners): to_jax_layout(
        t.detach().float().cpu().numpy()) for n, t in tensors.items()})
