"""Data parallelism over ``torch.distributed``: the rendezvous, the mesh
resolved against the world size, the batch shard of a rank, and the few
collectives the steps use.

The port of ``cstp_tpu/parallel/mesh.py``. The JAX package runs one
process over N devices on a ``('data', 'model')`` mesh and lets XLA insert
the collectives; the port runs N processes with one device each, the
reference's own design (``main_byol.py:171-174``): NCCL between CUDA
devices, gloo on the CPU. A run at world size N computes what the JAX step
computes on a ``data=N`` mesh for the same global batch, rank r holding
rows ``[r B/N, (r+1) B/N)`` of each view:

* the gradients are averaged once per optimizer step (after every
  microbatch of ``--grad_accum``), in one flat buffer, and so are the
  metrics (:func:`all_reduce_mean_`);
* under ``--sync_bn 1`` each BatchNorm group's first and second moments are
  averaged over the ranks (:func:`global_moments`), so the statistics are
  the global batch's and their gradient the global one;
* under ``--sync_bn 0`` normalisation stays local (JAX's groups r and N + r
  of a ``data=N`` mesh are rank r's rows) and the BN running statistics,
  which move linearly in the group means, are averaged after the step
  (:func:`average_buffers_`);
* the s8 storage chain (``--quant int8_store``, ``ops/quant.py``) takes
  its absmax observations as maxima over the ranks (:func:`all_reduce_max`;
  JAX's are over the whole batch), and under ``--sync_bn 1`` its BN
  moments from its int64 sums, all-reduced exactly.

The collectives are ``all_reduce``, ``all_gather`` and ``broadcast`` only,
which gloo also carries for CUDA tensors. Without a process group every
helper here is the identity, so one process runs as before. The 'model'
axis (``--shard_opt_state``, ``--shard_spatial``, tensor-parallel MLPs) is
not ported: ROADMAP item 17c.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

# seconds a collective or the rendezvous may wait before it raises
TIMEOUT_S = 600

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_CSTP = ("CSTP_COORDINATOR", "CSTP_NUM_PROCESSES", "CSTP_PROCESS_ID")


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main() -> bool:
    """True on rank 0, which writes logs, CSV, TensorBoard and
    checkpoints."""
    return rank() == 0


def _rendezvous_env() -> Optional[Tuple[str, int, int, int]]:
    """``(init_method, world, rank, local_rank)`` from torchrun's variables
    or the JAX package's ``CSTP_*`` ones; None when neither is set. A
    partial or inconsistent set raises ``ValueError``."""
    env = os.environ
    torchrun = [k for k in _TORCHRUN if env.get(k)]
    cstp = [k for k in _CSTP if env.get(k)]
    if not torchrun and not cstp:
        return None
    if torchrun and cstp:
        raise ValueError(f"both torchrun's {torchrun} and the CSTP_* "
                         f"rendezvous {cstp} are set; set one of them")
    names = _TORCHRUN if torchrun else _CSTP
    missing = [k for k in names if not env.get(k)]
    # torchrun's address may come from the caller's init_method alone
    if torchrun:
        missing = [k for k in missing if k not in ("MASTER_ADDR",
                                                   "MASTER_PORT")]
    if missing:
        raise ValueError(f"distributed rendezvous variables {missing} are "
                         f"missing (set: {torchrun or cstp})")
    try:
        if torchrun:
            world, r = int(env["WORLD_SIZE"]), int(env["RANK"])
            addr = ("env://" if env.get("MASTER_ADDR")
                    and env.get("MASTER_PORT") else "")
        else:
            world = int(env["CSTP_NUM_PROCESSES"])
            r = int(env["CSTP_PROCESS_ID"])
            addr = f"tcp://{env['CSTP_COORDINATOR']}"
        local = int(env.get("LOCAL_RANK", r))
    except ValueError as e:
        raise ValueError(f"distributed rendezvous variables: {e}") from e
    if world < 1 or not 0 <= r < world or local < 0:
        raise ValueError(f"rank {r} / world size {world} / local rank "
                         f"{local}: need 0 <= rank < world size")
    return addr, world, r, local


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 device=None,
                                 backend: Optional[str] = None) -> bool:
    """Join the process group when a rendezvous is configured: torchrun's
    ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``,
    or the JAX package's ``CSTP_COORDINATOR`` (``host:port``) /
    ``CSTP_NUM_PROCESSES`` / ``CSTP_PROCESS_ID``. ``init_method`` (such as
    a ``file://`` store) replaces the address. Returns True if it joined;
    False with no rendezvous or when already joined.

    The backend is NCCL for a CUDA device (``cuda:LOCAL_RANK`` unless
    ``device`` names one, made the current device) and gloo for the CPU;
    ``backend`` overrides it. A configured rendezvous that fails raises:
    the process never carries on alone. ``CSTP_AUTO_DISTRIBUTED=1`` (the
    JAX package's TPU-pod detection) raises ``NotImplementedError``.

    Launch, one process per card::

        torchrun --nproc_per_node 4 -m cstp_tpu_torch.cli.main_byol ...
        CSTP_COORDINATOR=host0:1234 CSTP_NUM_PROCESSES=2 CSTP_PROCESS_ID=$i \\
            python -m cstp_tpu_torch.cli.main_byol ...
    """
    if os.environ.get("CSTP_AUTO_DISTRIBUTED") == "1":
        raise NotImplementedError(
            "CSTP_AUTO_DISTRIBUTED=1 (TPU-pod auto-detection) has no "
            "counterpart in cstp_tpu_torch: launch with torchrun or the "
            "CSTP_COORDINATOR/CSTP_NUM_PROCESSES/CSTP_PROCESS_ID variables")
    if is_distributed():
        return False
    found = _rendezvous_env()
    if found is None:
        return False
    addr, world, r, local = found
    method = init_method or addr
    if not method:
        raise ValueError("torchrun's MASTER_ADDR/MASTER_PORT are missing "
                         "and no init_method was given")
    if device is not None:
        dev = torch.device(device)
    elif torch.cuda.is_available():
        dev = torch.device("cuda", local)
    else:
        dev = torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    try:
        dist.init_process_group(
            backend, init_method=method, world_size=world, rank=r,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    except Exception as e:
        raise RuntimeError(
            f"rank {r} of {world} could not join the process group at "
            f"{method} ({backend}): {e}") from e
    return True


def shutdown() -> None:
    """Leave the process group, if any."""
    if is_distributed():
        dist.destroy_process_group()


@contextlib.contextmanager
def distributed_run(device=None):
    """A CLI's run: :func:`maybe_initialize_distributed` first, as the JAX
    package's CLIs do, and the group left at the end if this joined it."""
    joined = maybe_initialize_distributed(device=device)
    try:
        yield
    finally:
        if joined:
            shutdown()


# ------------------------------------------------------------------ mesh

@dataclass(frozen=True)
class Mesh:
    data: int
    model: int = 1


def create_mesh(shape: Sequence[int] = (-1, 1),
                axes: Sequence[str] = ("data", "model"),
                world: Optional[int] = None) -> Mesh:
    """``--mesh_shape`` resolved against the world size (one ``-1`` takes
    what is left). The 'data' size must be the world size; a 'model' size
    above 1 is ROADMAP item 17c."""
    world = world_size() if world is None else world
    given, shape = tuple(shape), list(shape)
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = world // known if world % known == 0 else 0
    sizes = dict(zip(axes, shape))
    model = sizes.get("model", 1)
    if model > 1:
        raise NotImplementedError(
            f"--mesh_shape {given}: a 'model' axis above 1 "
            "(tensor-parallel MLPs, --shard_spatial) is ROADMAP item 17c, "
            "not ported yet")
    data = sizes.get("data", 1)
    if data != world:
        raise ValueError(f"--mesh_shape {given}: 'data' size {data} is not "
                         f"the world size {world} (one process per device)")
    return Mesh(data=data, model=model)


def shard_rows(x, r: Optional[int] = None, world: Optional[int] = None):
    """Rows ``[r B/N, (r+1) B/N)`` of a ``(B, ...)`` tensor or array."""
    r = rank() if r is None else r
    world = world_size() if world is None else world
    b = x.shape[0]
    if b % world:
        raise ValueError(f"batch {b} not divisible by world size {world}")
    n = b // world
    return x[r * n:(r + 1) * n]


def shard_batch(batch: Dict, r: Optional[int] = None,
                world: Optional[int] = None) -> Dict:
    """This rank's rows of every entry of a global batch."""
    return {k: shard_rows(v, r, world) for k, v in batch.items()}


# ------------------------------------------------------------ collectives

class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the gradient of a sum over ranks is the sum of the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class _AllGatherRows(torch.autograd.Function):
    """Concatenate the ranks' rows; the gradient reaching this rank's rows
    is the sum over ranks of the gradients of those rows."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        r = dist.get_rank()
        return g[r * ctx.rows:(r + 1) * ctx.rows]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Autograd-aware sum over ranks (the identity without a group)."""
    return _AllReduceSum.apply(x) if is_distributed() else x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Autograd-aware gather of every rank's ``(b, ...)`` rows into
    ``(N b, ...)``, in rank order (the identity without a group)."""
    return _AllGatherRows.apply(x) if is_distributed() else x


def global_moments(*moments: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Means over ranks of same-shaped per-rank means (each rank holds the
    same number of rows), in one all-reduce; differentiable."""
    if not is_distributed():
        return moments
    total = all_reduce_sum(torch.stack(moments)) / world_size()
    return tuple(total.unbind(0))


@torch.no_grad()
def all_reduce_max(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Maxima over ranks of same-shaped tensors, in one all-reduce (the
    identity without a group)."""
    if not is_distributed():
        return xs
    t = torch.stack(xs)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return tuple(t.unbind(0))


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Replace each tensor by its mean over ranks, in place, with one
    all-reduce of one flat buffer per dtype and device."""
    if not is_distributed():
        return
    groups: Dict[Tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    n = world_size()
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        flat /= n
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def mean_metrics(metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """0-d metric tensors averaged over ranks: each rank's mean is over
    the same number of rows, so this is the global batch's mean."""
    if not is_distributed():
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    all_reduce_mean_([flat])
    return dict(zip(keys, flat.unbind(0)))


def average_buffers_(module: nn.Module) -> None:
    """The module's floating-point buffers (BN running statistics) averaged
    over ranks, in place (``--sync_bn 0``: JAX's mean over the groups of
    every rank). The storage chain's ``act_scale_*`` are left out: they
    move by maxima over the ranks and are equal on every rank already."""
    all_reduce_mean_([b for n, b in module.named_buffers()
                      if b.is_floating_point()
                      and not n.rsplit(".", 1)[-1].startswith("act_scale_")])


@torch.no_grad()
def replicate(module: nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, once, at the start."""
    if not is_distributed():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0)


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (pickled; the identity without
    a group)."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def set_cross_rank_bn(model: nn.Module, enabled: bool) -> nn.Module:
    """Mark every BatchNorm of ``model`` (fused (2+1)D sites included) to
    take global-batch statistics when a process group runs
    (``--sync_bn 1``)."""
    from cstp_tpu_torch.models.layers import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.cross_rank = bool(enabled)
    return model
