"""The optimizers' update rules and the learning-rate schedules
(pretrain: cosine with warmup and restarts; finetune: reduce on plateau).

The port of ``make_optimizer`` (``cstp_tpu/train/optim.py``), in its
chain order:

1. global-norm clip over the trainable parameters only (skipped with
   ``clip_grad_norm=None``, as the finetune step runs);
2. ``sgd``: ``g + weight_decay * p``, then the momentum trace ``buf = g +
   momentum * buf`` (torch ``optim.SGD``; the first step seeds ``buf =
   g``); with ``dampening`` ``buf = momentum * buf + (1 - dampening) * g``
   after an undamped first step; with ``nesterov`` the update is ``g +
   momentum * buf``;
3. ``adam``: L2 decay into the gradient, then bias-corrected Adam moments
   (betas 0.9 / 0.999, eps 1e-8); ``adamw``: Adam (betas 0.9 / 0.99) first,
   then ``+ weight_decay * p`` (decoupled).

The learning rate is applied outside, ``p -= lr * update``, by
:func:`apply_lr`, optionally scaled per parameter
(:func:`bias_double_lr_multipliers`, ``--double_bias_lr``). Frozen
parameters (the target tower in pretraining, the frozen prefixes of a
finetune run: the JAX package's ``param_labels`` with
``optax.set_to_zero``) have ``requires_grad`` off (:func:`freeze`) and are
not handed to the optimizer (:func:`trainable`): they get no gradient, no
update, no weight decay and no optimizer state, and stay out of the norm.

State layouts: plain SGD ``{"trace"}``, dampened SGD ``{"trace",
"count"}``, Adam ``{"mu", "nu", "count"}``; each a ``{name: tensor}`` map
over the trainable parameters, ``count`` a Python int (the updates taken).

On a mesh (``parallel/mesh.py``) :class:`MeshUpdate` wraps the rule: the
clip's global norm counts the tensor-parallel slices' squares over
'model', and under ``--shard_opt_state`` (ZeRO-1, JAX's ``_zero_spec``)
each 'data' rank keeps the state of one slice of each parameter only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, List, Optional, Protocol,
                    Sequence, Tuple)

import numpy as np
import torch
from torch import nn

Tensors = Dict[str, torch.Tensor]


def is_frozen(name: str, frozen_prefixes: Sequence[str]) -> bool:
    """Whether the parameter ``name`` (dotted port name) lies under one of
    the module paths ``frozen_prefixes``, matched by whole path parts."""
    parts = name.split(".")
    return any(parts[:len(p.split("."))] == p.split(".")
               for p in frozen_prefixes)


def freeze(model: nn.Module, frozen_prefixes: Sequence[str]) -> None:
    """``requires_grad`` off for the parameters under ``frozen_prefixes``
    and on for the others."""
    for n, p in model.named_parameters():
        p.requires_grad_(not is_frozen(n, frozen_prefixes))


def trainable(model: nn.Module) -> Tensors:
    """The parameters the optimizer updates: those ``freeze`` left on."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


class Optimizer(Protocol):
    """An lr-less update rule over ``{name: tensor}`` maps."""

    def init(self, params: Tensors) -> Dict: ...

    def update(self, grads: Tensors, state: Dict,
               params: Tensors) -> Tuple[Tensors, Dict]: ...


def _clipped(grads: Tensors, max_norm: Optional[float],
             norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """optax ``clip_by_global_norm``: scale every gradient by ``max_norm /
    norm`` when the global norm (by default the norm of ``grads``) reaches
    ``max_norm``."""
    g = list(grads.values())
    if not max_norm:
        return g
    if norm is None:
        norm = torch.sqrt(sum(x.float().square().sum() for x in g))
    clip = norm >= max_norm
    return [torch.where(clip, (x / norm) * max_norm, x) for x in g]


def _decayed(g: List[torch.Tensor], params: Tensors, names: List[str],
             weight_decay: float) -> List[torch.Tensor]:
    """optax ``add_decayed_weights``: ``g + weight_decay * p``."""
    if not weight_decay:
        return g
    return [x + weight_decay * params[n] for x, n in zip(g, names)]


class SGD:
    """torch ``optim.SGD`` without its learning rate: weight decay,
    momentum, dampening (``trace_with_dampening``) and nesterov."""

    def __init__(self, momentum: float = 0.9, weight_decay: float = 1e-4,
                 clip_grad_norm: Optional[float] = 18.0,
                 dampening: float = 0.0, nesterov: bool = False):
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_grad_norm = clip_grad_norm
        self.dampening = dampening
        self.nesterov = nesterov

    def init(self, params: Tensors) -> Dict:
        state = {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}
        if self.dampening:
            state["count"] = 0
        return state

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict,
               params: Tensors) -> Tuple[Tensors, Dict]:
        names = list(grads)
        g = _decayed(_clipped(grads, self.clip_grad_norm), params, names,
                     self.weight_decay)
        m, old = self.momentum, state["trace"]
        if self.dampening:
            # the first step seeds the trace undamped, as torch does
            keep = 1.0 - (self.dampening if state["count"] > 0 else 0.0)
            trace = {n: m * old[n] + keep * x for x, n in zip(g, names)}
            new_state = {"trace": trace, "count": state["count"] + 1}
        else:
            trace = {n: x + m * old[n] for x, n in zip(g, names)}
            new_state = {"trace": trace}
        if self.nesterov:
            return ({n: x + m * trace[n] for x, n in zip(g, names)},
                    new_state)
        return trace, new_state


def _bias_correction(decay: float, count: int) -> torch.Tensor:
    """``1 - decay ** count`` in float32 with the power rounded once, as
    optax's jitted ``decay ** count`` gives it (``torch.pow`` multiplies
    out an integer power, and ``1 - b2 ** count`` magnifies its extra
    rounding a thousandfold). A 0-d CPU tensor combines with tensors on any
    device."""
    power = np.float32(float(np.float32(decay)) ** count)
    return torch.tensor(np.float32(1.0) - power)


class Adam:
    """optax ``scale_by_adam`` (bias-corrected, eps 1e-8, eps_root 0) with
    float32 moments. ``decoupled=False`` (``adam``) adds the L2 decay to the
    gradient before the moments; ``decoupled=True`` (``adamw``) adds
    ``weight_decay * p`` to the Adam step."""

    def __init__(self, b1: float, b2: float, weight_decay: float = 0.0,
                 decoupled: bool = False,
                 clip_grad_norm: Optional[float] = 18.0, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decoupled = decoupled
        self.clip_grad_norm = clip_grad_norm

    def init(self, params: Tensors) -> Dict:
        def zeros():
            return {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()}
        return {"mu": zeros(), "nu": zeros(), "count": 0}

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict,
               params: Tensors) -> Tuple[Tensors, Dict]:
        names = list(grads)
        g = _clipped(grads, self.clip_grad_norm)
        if not self.decoupled:
            g = _decayed(g, params, names, self.weight_decay)
        b1, b2 = self.b1, self.b2
        mu = {n: (1.0 - b1) * x + b1 * state["mu"][n]
              for x, n in zip(g, names)}
        nu = {n: (1.0 - b2) * x.square() + b2 * state["nu"][n]
              for x, n in zip(g, names)}
        count = state["count"] + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        out = [(mu[n] / c1) / (torch.sqrt(nu[n] / c2) + self.eps)
               for n in names]
        if self.decoupled:
            out = _decayed(out, params, names, self.weight_decay)
        return dict(zip(names, out)), {"mu": mu, "nu": nu, "count": count}


def zero_dim(shape, data_size: int) -> Optional[int]:
    """JAX's ``_zero_spec``: the dimension of an optimizer-state tensor of
    ``shape`` split over 'data' (ZeRO-1), its largest one that the 'data'
    size divides (the first of equal ones); None keeps it whole."""
    if data_size > 1:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % data_size == 0 and shape[i] >= data_size:
                return i
    return None


class MeshUpdate:
    """An update rule (built without its clip) on the ``('data',
    'model')`` mesh, for gradients already reduced over the mesh
    (``train/pretrain.py all_reduce_step``).

    * The global-norm clip is over the whole gradient: the squares of the
      tensor-parallel slices (``tp_dims``, ``{name: dim}``) are summed over
      'model' before the square root.
    * ``zero`` (``--shard_opt_state``): each parameter outside ``tp_dims``
      with a dimension that the 'data' size divides (:func:`zero_dim`)
      keeps the state of this rank's slice along it alone. The rule runs
      on the slices of the clipped gradient and of the parameter (weight
      decay included), and the slices of the update are gathered over
      'data'. Every step of the rules is elementwise, so the update is
      bitwise the one without ``zero``.

    ``gather_state`` / ``cut_state`` turn the state into the whole tensors
    of a one-process state and back (checkpoints).
    """

    def __init__(self, inner: Optimizer, clip_grad_norm: Optional[float],
                 tp_dims: Dict[str, int], zero: bool):
        from cstp_tpu_torch.parallel import mesh

        self.inner = inner
        self.clip_grad_norm = clip_grad_norm
        self.tp_dims = dict(tp_dims)
        self.zero = bool(zero)
        self.data = mesh.mesh_axis("data")
        self.dims: Dict[str, Optional[int]] = {}

    def _norm(self, grads: Tensors) -> Optional[torch.Tensor]:
        """The whole gradient's norm where 'model' splits some of it; None
        (``_clipped``'s own norm) where it splits none."""
        from cstp_tpu_torch.parallel import mesh

        split = [n for n in grads if n in self.tp_dims]
        if not split:
            return None
        whole = sum(grads[n].float().square().sum() for n in grads
                    if n not in self.tp_dims)
        parts = mesh.all_reduce_sum(
            sum(grads[n].float().square().sum() for n in split), "model")
        return torch.sqrt(whole + parts)

    def _cut(self, tensors: Tensors) -> Tensors:
        from cstp_tpu_torch.parallel.mesh import cut_slice

        return {n: t if self.dims.get(n) is None else cut_slice(
            t, self.dims[n], self.data.index, self.data.size)
            for n, t in tensors.items()}

    def _gather(self, tensors: Tensors) -> Tensors:
        """The whole tensors of ``tensors``' slices, in one all-gather over
        'data' per dtype."""
        from cstp_tpu_torch.parallel import mesh

        out = dict(tensors)
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for n, t in tensors.items():
            if self.dims.get(n) is not None:
                by_dtype.setdefault(t.dtype, []).append(n)
        for names in by_dtype.values():
            fronts = [tensors[n].movedim(self.dims[n], 0) for n in names]
            flat = torch.cat([f.reshape(-1) for f in fronts])
            parts = mesh.gather_slices(flat, 0, "data").chunk(self.data.size)
            sizes = [f.numel() for f in fronts]
            pieces = [p.split(sizes) for p in parts]
            for i, (n, f) in enumerate(zip(names, fronts)):
                whole = torch.cat([p[i].view(f.shape) for p in pieces])
                out[n] = whole.movedim(0, self.dims[n])
        return out

    def init(self, params: Tensors) -> Dict:
        self.dims = {n: zero_dim(p.shape, self.data.size)
                     if self.zero and n not in self.tp_dims else None
                     for n, p in params.items()}
        return self.inner.init(self._cut(params))

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict,
               params: Tensors) -> Tuple[Tensors, Dict]:
        g = dict(zip(grads, _clipped(grads, self.clip_grad_norm,
                                     self._norm(grads))))
        updates, state = self.inner.update(self._cut(g), state,
                                           self._cut(params))
        return self._gather(updates), state

    def gather_state(self, state: Dict) -> Dict:
        """The state with whole tensors (a collective): the ZeRO slices
        gathered over 'data', the tensor-parallel ones over 'model'."""
        from cstp_tpu_torch.parallel.mesh import gather_slices

        out = {}
        for k, v in state.items():
            if isinstance(v, dict):
                v = self._gather(v)
                v = {n: gather_slices(t, self.tp_dims[n], "model")
                     if n in self.tp_dims else t for n, t in v.items()}
            out[k] = v
        return out

    def cut_state(self, state: Dict) -> Dict:
        """This rank's slices of a state with whole tensors."""
        from cstp_tpu_torch.parallel import mesh

        model = mesh.mesh_axis("model")
        out = {}
        for k, v in state.items():
            if isinstance(v, dict):
                v = {n: mesh.cut_slice(t, self.tp_dims[n], model.index,
                                       model.size)
                     if n in self.tp_dims else t for n, t in v.items()}
                v = {n: t.contiguous() for n, t in self._cut(v).items()}
            out[k] = v
        return out


def mesh_update(tx: Optimizer, model: nn.Module,
                shard_opt_state: bool) -> Optimizer:
    """``tx`` for the installed mesh: itself where no 'model' axis splits
    a head and ``--shard_opt_state`` is off; else :class:`MeshUpdate`
    around it (which takes over its clip)."""
    from cstp_tpu_torch.parallel.mesh import tensor_parallel_dims

    tp = {n: d for n, d in tensor_parallel_dims(model).items()
          if n in dict(model.named_parameters())}
    if not tp and not shard_opt_state:
        return tx
    clip = tx.clip_grad_norm
    tx.clip_grad_norm = None
    return MeshUpdate(tx, clip, tp, shard_opt_state)


def make_optimizer(name: str, *, momentum: float = 0.9,
                   weight_decay: float = 1e-4, dampening: float = 0.0,
                   nesterov: bool = False,
                   clip_grad_norm: Optional[float] = 18.0) -> Optimizer:
    """The lr-less update rule ``name`` ("sgd", "adam" or "adamw"); the
    train step applies ``-lr``."""
    if name == "sgd":
        return SGD(momentum, weight_decay, clip_grad_norm, dampening,
                   nesterov)
    if name == "adam":
        # torch-default betas (the reference passes none)
        return Adam(0.9, 0.999, weight_decay, False, clip_grad_norm)
    if name == "adamw":
        # the reference's explicit betas (0.9, 0.99)
        return Adam(0.9, 0.99, weight_decay, True, clip_grad_norm)
    raise ValueError(f"unknown optimizer {name!r}")


def bias_double_lr_multipliers(params: Tensors) -> Dict[str, float]:
    """``--double_bias_lr``: 2x the learning rate for every parameter whose
    last name part is ``bias`` (BatchNorm biases included), 1x for the
    others (the reference's ``get_1x_lr_params`` / ``get_2x_lr_params``)."""
    return {n: 2.0 if n.rsplit(".", 1)[-1] == "bias" else 1.0
            for n in params}


@torch.no_grad()
def apply_lr(params: Tensors, updates: Tensors, lr,
             lr_mult: Optional[Dict[str, float]] = None) -> None:
    """``p -= lr * u`` in place (torch's ``p -= lr * buf``), with
    ``lr * lr_mult[name]`` where ``lr_mult`` is given."""
    for n, u in updates.items():
        params[n].sub_((lr if lr_mult is None else lr * lr_mult[n]) * u)


def cosine_warmup_restarts(max_lr: float, first_cycle_steps: int,
                           warmup_steps: float, min_lr: float = 1e-5,
                           gamma: float = 0.5, cycle_mult: float = 1.0
                           ) -> Callable[[int], float]:
    """The reference's ``CosineAnnealingWarmupRestarts`` with
    ``cycle_mult=1`` as a pure function of the 0-based epoch index (epoch
    e, 1-based, trains at ``lr(e - 1)``): linear warmup from ``min_lr``
    over ``warmup_steps`` epochs, cosine decay to ``min_lr``, and restarts
    whose peak decays by ``gamma`` per cycle. Being pure, it needs no state
    in a checkpoint beyond the epoch."""
    if cycle_mult != 1.0:
        raise ValueError("only cycle_mult=1 is supported (the reference's "
                         "only setting)")
    if not warmup_steps < first_cycle_steps:
        raise ValueError(f"warmup_steps {warmup_steps} must be below "
                         f"first_cycle_steps {first_cycle_steps}")

    def lr_fn(step: int) -> float:
        cycle = step // first_cycle_steps
        s = step % first_cycle_steps
        cur_max = max_lr * (gamma ** cycle)
        if s < warmup_steps:
            return (cur_max - min_lr) * s / warmup_steps + min_lr
        return min_lr + (cur_max - min_lr) * (
            1.0 + math.cos(math.pi * (s - warmup_steps)
                           / (first_cycle_steps - warmup_steps))) / 2.0

    return lr_fn


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch ReduceLROnPlateau (mode='min', defaults) as checkpointable
    state: the finetune schedule."""

    lr: float
    patience: int = 10
    factor: float = 0.1
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = math.inf
    num_bad: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_state_dict(cls, d: Dict[str, Any]) -> "ReduceLROnPlateau":
        return cls(**d)
