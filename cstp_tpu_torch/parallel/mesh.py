"""The ``('data', 'model')`` mesh over ``torch.distributed``: the
rendezvous, the mesh resolved against the world size, the batch shard of a
rank, the collectives the steps use, and the 'model' axis's two
mechanisms, the H halo of ``--shard_spatial`` and the tensor-parallel
4096-wide MLPs.

The port of ``cstp_tpu/parallel/mesh.py``. The JAX package runs one
process over N devices on a ``('data', 'model')`` mesh and lets XLA insert
the collectives; the port runs N processes with one device each, the
reference's own design (``main_byol.py:171-174``): NCCL between CUDA
devices, gloo on the CPU. ``--mesh_shape D M`` lays the ranks out as
JAX's device grid, row-major: rank ``r`` is ``(d, m) = divmod(r, M)``
(:func:`use_mesh`), with one process group per data row (its M 'model'
ranks) and one per model column (its D 'data' ranks). Every collective
names the axis it reduces over (:func:`mesh_axis`). The ranks of one model
column hold rows ``[d B/D, (d+1) B/D)`` of each view (:func:`shard_rows`),
the same rows on every rank of a data row:

* the gradients are averaged over 'data' once per optimizer step (after
  every microbatch of ``--grad_accum``), in one flat buffer, and so are
  the metrics (:func:`all_reduce_mean_`);
* under ``--sync_bn 1`` each BatchNorm group's first and second moments are
  averaged over the 'data' ranks (:func:`global_moments`), so the
  statistics are the global batch's and their gradient the global one;
* under ``--sync_bn 0`` normalisation stays local (JAX's groups d and D + d
  of a ``data=D`` mesh are data row d's rows) and the BN running
  statistics, which move linearly in the group means, are averaged after
  the step (:func:`average_buffers_`);
* the s8 storage chain (``--quant int8_store``, ``ops/quant.py``) takes
  its absmax observations as maxima over the ranks (:func:`all_reduce_max`;
  JAX's are over the whole batch), and under ``--sync_bn 1`` its BN
  moments from its int64 sums, all-reduced exactly.

With a 'model' axis above 1 (JAX's ``_model_spec``): every 4096-wide MLP
is tensor-parallel, each rank holding ``4096 / M`` hidden units
(``models/layers.py MLPHead``), between Megatron's pair of collectives
(:func:`copy_to_parallel`, :func:`reduce_to_replicated`); and under
``--shard_spatial`` (JAX's ``spatial_constraint_fn``) the R(2+1)D, C3D,
3D-ResNet, S3D-G and I3D towers split H over 'model'
(:class:`SpatialShard`, ``models/sharded.py``): each conv and max pool
that spans H fetches its neighbours' rows (:func:`halo_rows`; a TF-SAME
``(lo, hi)`` pad too), the BatchNorm moments are sums over the ranks
weighted by their positions, and the global pool and S3D-G's gates are
sums over 'model'. ``--shard_opt_state`` (ZeRO-1) lives in
``train/optim.py``.

The collectives are ``all_reduce``, ``all_gather`` and ``broadcast`` only
(and their pickled-object forms), which gloo also carries for CUDA
tensors. Without a process group every
helper here is the identity, so one process runs as before.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
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
    """Leave the process group, if any, and forget the installed mesh."""
    _AXES.clear()
    _GROUPS.clear()
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
    what is left); 'data' times 'model' must be the world size (one process
    per device)."""
    world = world_size() if world is None else world
    given, shape = tuple(shape), list(shape)
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = world // known if world % known == 0 else 0
    sizes = dict(zip(axes, shape))
    data, model = sizes.get("data", 1), sizes.get("model", 1)
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"--mesh_shape {given}: 'data' {data} x 'model' "
                         f"{model} is not the world size {world} (one "
                         "process per device)")
    return Mesh(data=data, model=model)


@dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index
    along it, and the process group of the ranks that differ from this one
    along it alone (None: the default group)."""
    size: int
    index: int
    group: Optional[object] = None

    @property
    def kw(self) -> Dict:
        return {} if self.group is None else {"group": self.group}

    def global_rank(self, index: int) -> int:
        """The world rank of this axis's ``index``-th member."""
        if self.group is None:
            return index
        return dist.get_global_rank(self.group, index)


# the installed mesh's axes ('data', 'model', 'world'), and the process
# groups made for each (data, model) shape (made once: new_group is a
# collective every rank calls in the same order)
_AXES: Dict[str, Axis] = {}
_GROUPS: Dict[Tuple[int, int], Tuple[list, list]] = {}


def use_mesh(shape: Sequence[int] = (-1, 1),
             axes: Sequence[str] = ("data", "model")) -> Mesh:
    """Resolve ``--mesh_shape`` (:func:`create_mesh`) and install it: rank
    ``r`` is ``(d, m) = divmod(r, model)``, JAX's row-major device grid.
    Every rank calls it with the same shape."""
    mesh = create_mesh(shape, axes)
    r, world = rank(), world_size()
    d, m = divmod(r, mesh.model)
    data_g = model_g = None
    if mesh.data > 1 and mesh.model > 1:
        key = (mesh.data, mesh.model)
        if key not in _GROUPS:
            cols = [dist.new_group([dd * mesh.model + mm
                                    for dd in range(mesh.data)])
                    for mm in range(mesh.model)]
            rows = [dist.new_group([dd * mesh.model + mm
                                    for mm in range(mesh.model)])
                    for dd in range(mesh.data)]
            _GROUPS[key] = (cols, rows)
        cols, rows = _GROUPS[key]
        data_g, model_g = cols[m], rows[d]
    _AXES.update(data=Axis(mesh.data, d, data_g),
                 model=Axis(mesh.model, m, model_g),
                 world=Axis(world, r, None))
    return mesh


def mesh_axis(name: str) -> Axis:
    """The installed mesh's axis ``name`` ('data', 'model' or 'world');
    without an installed mesh 'data' is the world and 'model' has size 1."""
    if _AXES and _AXES["world"].size == world_size():
        return _AXES[name]
    r, world = rank(), world_size()
    return {"data": Axis(world, r), "model": Axis(1, 0),
            "world": Axis(world, r)}[name]


def shard_rows(x, r: Optional[int] = None, world: Optional[int] = None):
    """Rows ``[d B/D, (d+1) B/D)`` of a ``(B, ...)`` tensor or array, ``d``
    this rank's index on 'data' (or ``r``) and ``D`` its size (or
    ``world``)."""
    ax = mesh_axis("data")
    r = ax.index if r is None else r
    world = ax.size if world is None else world
    b = x.shape[0]
    if b % world:
        raise ValueError(f"batch {b} not divisible by {world} data shards")
    n = b // world
    return x[r * n:(r + 1) * n]


def shard_batch(batch: Dict, r: Optional[int] = None,
                world: Optional[int] = None) -> Dict:
    """This rank's rows of every entry of a global batch."""
    return {k: shard_rows(v, r, world) for k, v in batch.items()}


# ------------------------------------------------------------ collectives

class _AllReduceSum(torch.autograd.Function):
    """Sum over an axis; the gradient of a sum over ranks is the sum of the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        y = x.clone()
        dist.all_reduce(y, **ax.kw)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, **ctx.ax.kw)
        return g, None


class _ReduceToReplicated(torch.autograd.Function):
    """Sum over an axis whose result every rank then uses alike (Megatron's
    g): each rank's cotangent is already the whole one, so the backward is
    the identity."""

    @staticmethod
    def forward(ctx, x, ax):
        y = x.clone()
        dist.all_reduce(y, **ax.kw)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToParallel(torch.autograd.Function):
    """The identity into per-rank computations (Megatron's f): each rank's
    cotangent is its part's, so the backward sums them."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, **ctx.ax.kw)
        return g, None


class _AllGatherRows(torch.autograd.Function):
    """Concatenate the ranks' rows; the gradient reaching this rank's rows
    is the sum over ranks of the gradients of those rows."""

    @staticmethod
    def forward(ctx, x, ax):
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        dist.all_gather(parts, x.contiguous(), **ax.kw)
        ctx.ax, ctx.rows = ax, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, **ctx.ax.kw)
        i = ctx.ax.index
        return g[i * ctx.rows:(i + 1) * ctx.rows], None


def all_reduce_sum(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Autograd-aware sum over ``axis`` (the identity on an axis of one)."""
    ax = mesh_axis(axis)
    return _AllReduceSum.apply(x, ax) if ax.size > 1 else x


def reduce_to_replicated(x: torch.Tensor,
                         axis: str = "model") -> torch.Tensor:
    """Sum over ``axis`` of per-rank parts whose sum every rank uses alike
    (a row-parallel product, the pooled feature of an H-sharded tower):
    forward all-reduce, backward identity."""
    ax = mesh_axis(axis)
    return _ReduceToReplicated.apply(x, ax) if ax.size > 1 else x


def copy_to_parallel(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """A tensor every rank of ``axis`` holds alike, entering per-rank
    computations (a column-parallel product): forward identity, backward
    all-reduce."""
    ax = mesh_axis(axis)
    return _CopyToParallel.apply(x, ax) if ax.size > 1 else x


def all_gather_rows(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Autograd-aware gather of every ``axis`` rank's ``(b, ...)`` rows
    into ``(N b, ...)``, in rank order (the identity on an axis of one)."""
    ax = mesh_axis(axis)
    return _AllGatherRows.apply(x, ax) if ax.size > 1 else x


def global_moments(*moments: torch.Tensor, axis: str = "data",
                   count: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
    """Means over ``axis`` of same-shaped per-rank means, in one
    all-reduce; differentiable. Without ``count`` each rank holds as many
    positions; with it, each rank's means are over ``count`` positions and
    weigh by them (the H shards of ``--shard_spatial``, uneven where H
    does not split evenly)."""
    ax = mesh_axis(axis)
    if ax.size == 1:
        return moments
    stacked = torch.stack(moments)
    if count is None:
        total = all_reduce_sum(stacked, axis) / ax.size
        return tuple(total.unbind(0))
    n = stacked.new_full((1,), float(count))
    flat = all_reduce_sum(torch.cat([(stacked * count).flatten(), n]), axis)
    total = (flat[:-1] / flat[-1]).view_as(stacked)
    return tuple(total.unbind(0))


def stats_axis(cross_rank: bool, spatial: bool) -> Optional[str]:
    """The axis BatchNorm moments are taken over: 'data' with global-batch
    statistics (``--sync_bn 1``), 'model' on the H shards of
    ``--shard_spatial``, 'world' with both, None with neither."""
    if spatial:
        return "world" if cross_rank else "model"
    return "data" if cross_rank else None


# True inside ``whole_batches()``
_WHOLE_BATCHES = [False]


@contextlib.contextmanager
def whole_batches():
    """Inside the block each data row's forwards take batches of their own
    (``train/loops.py _per_video``: one video per row, the rows running
    unequal counts of forwards), not rows of one global batch, so
    :func:`scale_axis` leaves 'data' out."""
    before = _WHOLE_BATCHES[0]
    _WHOLE_BATCHES[0] = True
    try:
        yield
    finally:
        _WHOLE_BATCHES[0] = before


def scale_axis(spatial: bool) -> Optional[str]:
    """The axis a dynamic or observed int8 activation scale (an absmax) is
    a maximum over: the ranks that hold parts of the tensor, as the JAX
    package's ``max(|x|)`` is over the whole sharded array. 'data' where a
    step's batch is split over it (not inside :func:`whole_batches`),
    'model' on the H shards of ``--shard_spatial``, 'world' with both;
    None with neither, so one process runs no collective."""
    data = not _WHOLE_BATCHES[0] and mesh_axis("data").size > 1
    model = spatial and mesh_axis("model").size > 1
    if data and model:
        return "world"
    return "data" if data else ("model" if model else None)


@torch.no_grad()
def all_reduce_max(*xs: torch.Tensor, axis: str = "data"
                   ) -> Tuple[torch.Tensor, ...]:
    """Maxima over ``axis`` of same-shaped tensors, in one all-reduce (the
    identity on an axis of one)."""
    ax = mesh_axis(axis)
    if ax.size == 1:
        return xs
    t = torch.stack(xs)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, **ax.kw)
    return tuple(t.unbind(0))


@torch.no_grad()
def _all_reduce_flat_(tensors: Iterable[torch.Tensor], axis: str,
                      mean: bool) -> None:
    ax = mesh_axis(axis)
    if ax.size == 1:
        return
    groups: Dict[Tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, **ax.kw)
        if mean:
            flat /= ax.size
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def all_reduce_mean_(tensors: Iterable[torch.Tensor],
                     axis: str = "data") -> None:
    """Replace each tensor by its mean over ``axis``, in place, with one
    all-reduce of one flat buffer per dtype and device."""
    _all_reduce_flat_(tensors, axis, mean=True)


def all_reduce_sum_(tensors: Iterable[torch.Tensor],
                    axis: str = "model") -> None:
    """Replace each tensor by its sum over ``axis``, in place (the
    parameter gradients of an H-sharded tower, partial on each shard)."""
    _all_reduce_flat_(tensors, axis, mean=False)


def mean_metrics(metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """0-d metric tensors averaged over 'data': each rank's mean is over
    the same number of rows, so this is the global batch's mean (the
    'model' ranks of a data row hold the same metrics)."""
    if mesh_axis("data").size == 1:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in keys])
    all_reduce_mean_([flat])
    return dict(zip(keys, flat.unbind(0)))


def average_buffers_(module: nn.Module) -> None:
    """The module's floating-point buffers (BN running statistics) averaged
    over 'data', in place (``--sync_bn 0``: JAX's mean over the groups of
    every data row). The storage chain's ``act_scale_*`` are left out:
    they move by maxima over the ranks and are equal on every rank
    already."""
    all_reduce_mean_([b for n, b in module.named_buffers()
                      if b.is_floating_point()
                      and not n.rsplit(".", 1)[-1].startswith("act_scale_")])


@torch.no_grad()
def replicate(module: nn.Module) -> None:
    """The first data row's parameters and buffers on every data row, and
    the first model column's tensors that 'model' does not split on every
    rank of a data row, once, at the start."""
    if not is_distributed():
        return
    data, model = mesh_axis("data"), mesh_axis("model")
    split = {id(t) for t in tensor_parallel_tensors(module)}
    for t in list(module.parameters()) + list(module.buffers()):
        if data.size > 1:
            dist.broadcast(t.data, data.global_rank(0), **data.kw)
        if model.size > 1 and id(t) not in split:
            dist.broadcast(t.data, model.global_rank(0), **model.kw)


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (pickled; the identity without
    a group)."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def all_gather_object(obj) -> list:
    """Every rank's ``obj`` (pickled), in rank order, on every rank: a list
    of one without a group."""
    if not is_distributed():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def set_cross_rank_bn(model: nn.Module, enabled: bool) -> nn.Module:
    """Mark every BatchNorm of ``model`` (fused (2+1)D sites included) to
    take global-batch statistics when a process group runs
    (``--sync_bn 1``)."""
    from cstp_tpu_torch.models.layers import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.cross_rank = bool(enabled)
    return model


# ------------------------------------------------ tensor-parallel MLPs

# the width of the BYOL projector/predictor hidden layers: a tensor that
# carries it is split over 'model' (JAX's ``MLP_WIDE_DIM``, ``_model_spec``)
MLP_WIDE_DIM = 4096


def tensor_parallel_tensors(module: nn.Module):
    """The parameters and buffers of ``module``'s tensor-parallel MLP heads
    (``MLPHead.tp`` set), each a slice of its 4096-wide dimension."""
    from cstp_tpu_torch.models.layers import MLPHead

    for m in module.modules():
        if isinstance(m, MLPHead) and m.tp is not None:
            yield from (t for _, t, _ in m.split_tensors())


def tensor_parallel_dims(module: nn.Module) -> Dict[str, int]:
    """``{name: dim}`` of every tensor-parallel slice in ``module``'s
    state dict: the dimension that holds ``4096 / M`` of the 4096."""
    from cstp_tpu_torch.models.layers import MLPHead

    dims = {}
    for prefix, m in module.named_modules():
        if isinstance(m, MLPHead) and m.tp is not None:
            for name, _, dim in m.split_tensors():
                dims[f"{prefix}.{name}" if prefix else name] = dim
    return dims


def shard_mlps(module: nn.Module) -> nn.Module:
    """Under a 'model' axis above 1, make every 4096-wide MLP head of
    ``module`` tensor-parallel (``MLPHead.shard``: this rank's slice of
    fc1's columns and bias, the hidden BatchNorm and fc2's rows); other
    widths stay whole, as JAX's ``_model_spec`` leaves them."""
    from cstp_tpu_torch.models.layers import MLPHead

    ax = mesh_axis("model")
    if ax.size > 1:
        for m in module.modules():
            if isinstance(m, MLPHead) and m.hidden == MLP_WIDE_DIM:
                m.shard(ax.index, ax.size)
    return module


@torch.no_grad()
def gather_slices(t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The whole tensor of which every ``axis`` rank holds an equal slice
    along ``dim``, in rank order (a collective)."""
    ax = mesh_axis(axis)
    if ax.size == 1:
        return t
    t = t.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(t) for _ in range(ax.size)]
    dist.all_gather(parts, t, **ax.kw)
    return torch.cat(parts).movedim(0, dim)


def cut_slice(t: torch.Tensor, dim: int, index: int,
              size: int) -> torch.Tensor:
    """Slice ``index`` of ``size`` equal slices of ``t`` along ``dim``."""
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state dict with every tensor-parallel slice gathered
    into its whole tensor (a collective on every rank where a head is
    split): the names and shapes of a one-process state dict."""
    sd = module.state_dict()
    for name, dim in tensor_parallel_dims(module).items():
        sd[name] = gather_slices(sd[name], dim, "model")
    return sd


# ------------------------------------------------------- --shard_spatial

@dataclass(frozen=True)
class SpatialShard:
    """The H split of ``--shard_spatial`` for input frames of ``height``
    rows: 'model' rank ``i`` holds rows ``[a_i, b_i)``, contiguous chunks
    of ``ceil(height / size)`` (the last one short where H does not split
    evenly, as GSPMD splits it). Every conv and pool keeps one rule for
    every stride: output row ``j`` belongs to the rank that holds input
    row ``j * s``; so at a total stride ``S`` rank ``i`` holds rows
    ``[ceil(a_i / S), ceil(b_i / S))``, clipped to that stage's global
    rows. ``heights`` gives the stages' global rows as ``(stride, rows)``
    pairs (``models/sharded.py`` derives them from a tower's sites: a
    VALID pool's ``floor(h / 2)``, C3D's 7 rows pool to 3); a stage it
    does not list has ``ceil(height / S)``."""
    height: int
    index: int
    size: int
    heights: Tuple[Tuple[int, int], ...] = ()

    def bounds(self, stride: int = 1):
        """Every rank's ``(lo, hi)`` rows at total stride ``stride``."""
        c, h = -(-self.height // self.size), self.height_at(stride)
        return [(min(-(-min(i * c, self.height) // stride), h),
                 min(-(-min((i + 1) * c, self.height) // stride), h))
                for i in range(self.size)]

    def rows(self, stride: int = 1) -> Tuple[int, int]:
        return self.bounds(stride)[self.index]

    def height_at(self, stride: int = 1) -> int:
        """The global rows at total stride ``stride``."""
        return dict(self.heights).get(stride, -(-self.height // stride))

    def check(self, strides: Iterable[int]) -> None:
        """Every rank holds a row at each of ``strides``; else ValueError
        (a frame too small for the 'model' axis)."""
        for s in strides:
            empty = [i for i, (lo, hi) in enumerate(self.bounds(s))
                     if hi <= lo]
            if empty:
                raise ValueError(
                    f"--shard_spatial: {self.height} rows over {self.size} "
                    f"'model' ranks leave ranks {empty} no row at stride "
                    f"{s} ({self.height_at(s)} rows); use a larger "
                    "--sample_size or a smaller 'model' axis")


def pad_pair(p) -> Tuple[int, int]:
    """An H padding as its ``(lo, hi)`` pair: an int pads both sides
    alike, a pair is TF SAME's (S3D-G's and I3D's bottom-heavy pads)."""
    return (p, p) if isinstance(p, int) else (int(p[0]), int(p[1]))


def halo_plan(shard: SpatialShard, stride: int, k: int, s: int, p):
    """The rows an H conv of kernel ``k``, stride ``s`` and padding ``p``
    (an int, or a ``(lo, hi)`` pair) reads, on input rows held at total
    stride ``stride``: ``(lo, hi, border)``, this rank's input rows ``[lo,
    hi)`` for its output rows (rows outside the frame are the conv's
    padding: the last rank's ``hi`` pad rows below the frame), and
    ``border``, the most rows any rank fetches from one side: ``lo``
    above, ``k - 1 - lo`` below."""
    i0, i1 = shard.rows(stride * s)
    if i1 <= i0:
        raise ValueError(f"--shard_spatial: 'model' rank {shard.index} "
                         f"holds no output row at stride {stride * s}")
    p = pad_pair(p)[0]
    return i0 * s - p, (i1 - 1) * s - p + k, max(p, k - 1 - p)


class _Halo(torch.autograd.Function):
    """This rank's rows extended by its neighbours' (:func:`halo_rows`).
    Forward: each rank's first and last ``border`` rows are gathered over
    'model' and the rows this rank lacks taken from their owners. Backward:
    the gradients of the fetched rows are gathered back and added to their
    owners' rows."""

    @staticmethod
    def forward(ctx, x, shard, stride, k, s, p, fill):
        bounds = shard.bounds(stride)
        a, b = bounds[shard.index]
        if x.shape[2] != b - a:
            raise ValueError(f"--shard_spatial: {x.shape[2]} rows, expected "
                             f"{b - a} (rows {a}..{b} at stride {stride})")
        lo, hi, n = halo_plan(shard, stride, k, s, p)
        height = shard.height_at(stride)
        ctx.meta = (shard, bounds, lo, hi, n, x.shape)
        borders = None
        if n and shard.size > 1:    # every rank takes part
            xp = F.pad(x, (0, 0, 0, 0, n, n))
            rows = x.shape[2]
            mine = torch.cat([xp[:, :, n:2 * n], xp[:, :, rows:rows + n]], 2)
            borders = [t.to(x.dtype) for t in _gather_model(mine.float())]
        pieces = []

        def outside(count):
            if count > 0:
                shape = list(x.shape)
                shape[2] = count
                pieces.append(x.new_full(shape, fill))

        outside(min(0, hi) - lo)
        for r in range(shard.index):            # rows above, their bottom
            ra, rb = bounds[r]
            j0, j1 = max(lo, ra, 0), min(a, rb)
            if j1 > j0:
                pieces.append(borders[r][:, :, n + j0 - (rb - n):
                                         n + j1 - (rb - n)])
        j0, j1 = max(lo, a), min(hi, b)
        if j1 > j0:
            pieces.append(x[:, :, j0 - a:j1 - a])
        for r in range(shard.index + 1, shard.size):   # rows below, top
            ra, rb = bounds[r]
            j0, j1 = max(b, ra), min(hi, rb, height)
            if j1 > j0:
                pieces.append(borders[r][:, :, j0 - ra:j1 - ra])
        outside(hi - max(height, lo))
        return torch.cat(pieces, 2) if len(pieces) > 1 else pieces[0]

    @staticmethod
    def backward(ctx, g):
        shard, bounds, lo, hi, n, shape = ctx.meta
        a, b = bounds[shard.index]
        dx = g.new_zeros(shape)
        j0, j1 = max(lo, a), min(hi, b)
        if j1 > j0:
            dx[:, :, j0 - a:j1 - a] += g[:, :, j0 - lo:j1 - lo]
        if not n or shard.size == 1:
            return dx, None, None, None, None, None, None
        # this rank's message: the gradients of rows [a - n, a) and
        # [b, b + n) it fetched, zero where it fetched none
        msg_shape = list(shape)
        msg_shape[2] = 2 * n
        msg = g.new_zeros(msg_shape)
        for j in range(max(lo, a - n, 0), min(a, hi)):
            msg[:, :, j - (a - n)] = g[:, :, j - lo]
        for j in range(max(b, lo), min(b + n, hi)):
            msg[:, :, n + j - b] = g[:, :, j - lo]
        msgs = _gather_model(msg.float())
        for r, (ra, rb) in enumerate(bounds):
            if r == shard.index:
                continue
            got = msgs[r].to(g.dtype)
            for j in range(max(a, ra - n), min(b, ra)):  # r's rows above
                dx[:, :, j - a] += got[:, :, j - (ra - n)]
            for j in range(max(a, rb), min(b, rb + n)):  # r's rows below
                dx[:, :, j - a] += got[:, :, n + j - rb]
        return dx, None, None, None, None, None, None


def _gather_model(t: torch.Tensor):
    ax = mesh_axis("model")
    parts = [torch.empty_like(t) for _ in range(ax.size)]
    dist.all_gather(parts, t.contiguous(), **ax.kw)
    return parts


def halo_rows(x: torch.Tensor, shard: SpatialShard, stride: int, k: int,
              s: int = 1, p=0, fill: float = 0.0) -> torch.Tensor:
    """The input rows that an H conv or pool of kernel ``k``, stride ``s``
    and padding ``p`` (an int or a TF-SAME ``(lo, hi)`` pair) reads for
    this rank's output rows, from ``x`` (N, T,
    h, W, C), this rank's rows at total stride ``stride``: rows ``[lo,
    hi)`` of :func:`halo_plan`, its own and (over 'model', an all-gather
    each way) its neighbours', ``fill`` outside the frame (a conv's zero
    padding; ``-inf`` for a max pool's). The op then runs on them with no
    H padding and gives exactly this rank's output rows."""
    return _Halo.apply(x, shard, stride, k, s, p, fill)
