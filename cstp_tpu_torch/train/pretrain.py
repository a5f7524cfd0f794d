"""Pretraining engine of the port: state creation and the pretrain step.

The port of ``cstp_tpu/train/pretrain.py``. One step is two programs, as in
the JAX package:

* **augment**: uint8 frames -> pair boxes, spa label, augmented views
  (``pallas_augment="on"``: the fused augment kernel; "off"/"auto": the ops
  path, as the JAX package resolves "auto");
* **train**: EMA of the target tower (parameters only, before the forward
  pass), online and target forwards, the 7-term loss, backward, global-norm
  clip 18 and the optimizer's update (SGD, Adam or AdamW; with
  ``--double_bias_lr`` biases at twice the learning rate). With
  ``grad_accum > 1`` the batch is split into contiguous microbatches,
  each run forward and backward in turn (only one microbatch's activations
  live at a time, each normalised by its own batch statistics, the BN
  running statistics advancing once per microbatch, in order); the
  gradients are summed, divided by the count, and take one update.

With ``--ntxent_weight w`` the loss gains ``w`` times the NT-Xent of the
two views' online projections, over the global batch (per microbatch under
``--grad_accum``).

PyTorch state is mutable: a step updates ``state`` (parameters, BN running
statistics, optimizer state) in place and returns it with the metrics.

Data parallelism (``parallel/mesh.py``): on a ``--mesh_shape D M`` grid of
ranks, each data row holding its rows of the global batch, the augment
draws the global batch's parameters and keeps the row's rows, the
gradients are averaged over 'data' once per optimizer step after the
accumulation (the JAX step's accumulate-then-update order), and the
metrics too; ``--sync_bn 1`` BatchNorms take global-batch statistics, and
under ``--sync_bn 0`` the BN running statistics are averaged after the
step. EMA, clip and update then see the same tensors on every rank of a
model column. With a 'model' axis above 1 the 4096-wide MLPs are
tensor-parallel; ``--shard_spatial`` splits the R(2+1)D, C3D,
3D-ResNet, S3D-G and I3D towers' H over 'model' (their parameter
gradients, partial on each shard, are summed over 'model' first); ``--shard_opt_state`` keeps
each 'data' rank's slice of the optimizer state (``train/optim.py
MeshUpdate``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from cstp_tpu_torch import resolve_device
from cstp_tpu_torch.augment.pipeline import (
    pretrain_augment_batch,
    pretrain_augment_batch_fused,
)
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.models.layers import store_calibration
from cstp_tpu_torch.models.sharded import (
    shard_spatially,
    spatially_partial_names,
)
from cstp_tpu_torch.parallel import mesh
from cstp_tpu_torch.ssl.byol import CSTPPretrain, cross_entropy, ema_update
from cstp_tpu_torch.ssl.ntxent import cross_replica_ntxent
from cstp_tpu_torch.train import optim
from cstp_tpu_torch.train.accum import accumulated_grads, microbatches

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class TrainState:
    step: int
    model: CSTPPretrain        # parameters and BN running statistics
    opt_state: Dict            # the optimizer's state (train/optim.py)


def compute_dtype(config: Config) -> torch.dtype:
    return _DTYPES[config.compute_dtype]


def data_shard_count(config: Config) -> int:
    """Size of the mesh 'data' axis: the world size of the process group
    (1 without one) over the 'model' size of ``--mesh_shape``, whose
    product must be the world size (``parallel.create_mesh``)."""
    return mesh.create_mesh(config.mesh_shape, config.mesh_axes).data


def place_on_mesh(model, config: Config):
    """Install ``--mesh_shape`` (``parallel.use_mesh``), then lay ``model``
    out on it: global-batch BatchNorms under ``--sync_bn 1``, the towers
    split over H under ``--shard_spatial`` (``models/sharded.py``), the
    4096-wide MLPs tensor-parallel under a 'model' axis above 1. Returns
    ``model``."""
    mesh.use_mesh(config.mesh_shape, config.mesh_axes)
    mesh.set_cross_rank_bn(model, bool(config.sync_bn))
    if config.shard_spatial:
        shard_spatially(model)
    return mesh.shard_mlps(model)


def bn_groups_from_config(config: Config) -> int:
    """BN groups of the global batch (per view): --sync_bn 1 -> one group
    (global-batch statistics); --sync_bn 0 -> one group per data shard."""
    return 1 if config.sync_bn else data_shard_count(config)


def local_bn_groups(config: Config) -> int:
    """BN groups of one rank's rows (per view): always one. Under --sync_bn
    0 JAX's group r of a ``data=N`` mesh is rank r's rows; under --sync_bn
    1 the one global group spans every rank's rows, its moments averaged
    over the ranks (``BatchNorm.cross_rank``)."""
    return max(1, bn_groups_from_config(config) // data_shard_count(config))


def effective_byol_momentum(config: Config) -> float:
    """BYOL target-EMA momentum, batch-scaled to ``m ** (B / R)`` with
    ``--ema_ref_batch R``."""
    m = config.byol_momentum
    if config.ema_ref_batch > 0:
        m = float(m ** (config.batch_size / config.ema_ref_batch))
    return m


def create_pretrain_model(config: Config, seed: int = 0,
                          device=None) -> CSTPPretrain:
    """The model with its initial weights drawn on the CPU from ``seed``
    (so a seed gives the same weights on every device), moved to
    ``device`` (CUDA unless ``device="cpu"`` is asked for)."""
    config.check_ported()
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = CSTPPretrain(config.model_name, config.model_depth,
                         compute_dtype(config), local_bn_groups(config),
                         int(config.fused_conv), gen,
                         concat_views=bool(config.concat_views),
                         remat=config.remat,
                         remat_policy=config.remat_policy,
                         shortcut=config.resnet_shortcut, alpha=config.alpha,
                         quant=config.quant, quant_scope=config.quant_scope,
                         s2d_stem=config.s2d_stem,
                         mid_round=config.mid_round,
                         t_fold=bool(config.t_fold))
    return place_on_mesh(model, config).to(dev)


def create_pretrain_state(config: Config, seed: int = 0, device=None
                          ) -> Tuple[CSTPPretrain, TrainState,
                                     optim.Optimizer]:
    """The model, its state and the configured optimizer, which trains
    every parameter but the target tower's (requires_grad=False in the
    reference; frozen in the JAX optimizer)."""
    model = create_pretrain_model(config, seed, device)
    optim.freeze(model, ("target_net",))
    tx = optim.make_optimizer(
        config.optimizer, momentum=config.momentum,
        weight_decay=config.weight_decay, dampening=config.dampening,
        nesterov=config.nesterov,
        clip_grad_norm=(config.clip_grad_value if config.clip_grad_norm
                        else None))
    tx = optim.mesh_update(tx, model, bool(config.shard_opt_state))
    state = TrainState(0, model, tx.init(optim.trainable(model)))
    return model, state, tx


def double_bias_lr(config: Config):
    """``params -> lr multipliers`` (``--double_bias_lr``) or ``None``."""
    if config.double_bias_lr:
        return optim.bias_double_lr_multipliers
    return lambda params: None


def _loss_and_metrics(model: CSTPPretrain, views_labels, w,
                      ntxent_weight: float = 0.0, temperature: float = 0.5):
    v1, v2, spa, tem, pb, rot1, rot2 = views_labels
    if ntxent_weight:
        byol, logits, (emb1, emb2) = model(v1, v2, train=True,
                                           with_proj=True)
    else:
        byol, logits = model(v1, v2, train=True)
    p_spa, p_tem, p_pb1, p_pb2, p_rot1, p_rot2 = logits
    l_spa = cross_entropy(p_spa, spa)
    l_tem = cross_entropy(p_tem, tem)
    l_pb1, l_pb2 = cross_entropy(p_pb1, pb), cross_entropy(p_pb2, pb)
    l_rot1, l_rot2 = cross_entropy(p_rot1, rot1), cross_entropy(p_rot2, rot2)
    total = (w[0] * byol + w[1] * l_spa + w[2] * l_tem
             + w[3] * (l_pb1 + l_pb2) + w[4] * (l_rot1 + l_rot2))
    if ntxent_weight:
        total = total + ntxent_weight * cross_replica_ntxent(
            emb1, emb2, temperature)
    with torch.no_grad():
        hits = [(p.argmax(-1) == y.long()).float()
                for p, y in ((p_spa, spa), (p_tem, tem), (p_pb1, pb),
                             (p_pb2, pb), (p_rot1, rot1), (p_rot2, rot2))]

        def acc(*hs):
            return torch.stack(hs).mean()

        metrics = {
            "loss": total.detach(),
            "loss_byol": byol.detach(),
            "loss_pred_spa": l_spa.detach(),
            "loss_pred_tem": l_tem.detach(),
            "loss_pred_pb": 0.5 * (l_pb1 + l_pb2).detach(),
            "loss_pred_rot": 0.5 * (l_rot1 + l_rot2).detach(),
            "acc_pretext": acc(*hits),
            "acc_spa": acc(hits[0]),
            "acc_tem": acc(hits[1]),
            "acc_pb": acc(hits[2], hits[3]),
            "acc_rot": acc(hits[4], hits[5]),
        }
    return total, metrics


def check_trainable_quant(config: Config, context: str) -> None:
    """Refuse the eval-only ``--quant`` modes on a training step (the JAX
    package's ``_check_trainable_quant``): ``int8_static`` would quantize
    with the zero-initialised ``act_scale`` and ``int8_calib`` observes
    scales instead of quantizing. Training takes '' / int8 / int8_fixed,
    and on the r21d family int8_store / int8_store_fz. ``Config.finalize``
    refuses the others already; this guards a config that skipped it."""
    if config.quant in ("int8_static", "int8_calib"):
        raise ValueError(
            f"--quant {config.quant} is an eval/serve/calibration mode and "
            f"cannot drive the {context} TRAINING step (see "
            "serve/quantize.py). Use --quant '' (float), int8, or "
            "int8_fixed for training.")
    if (config.quant in ("int8_store", "int8_store_fz")
            and not config.model_name.startswith("r21d")):
        raise ValueError(
            f"--quant {config.quant} is implemented for the r21d factorized "
            f"chain only; got model '{config.model_name}'. Use --quant int8/"
            "int8_fixed for other families.")


def _build_pretrain_programs(model: CSTPPretrain, tx: optim.Optimizer,
                             config: Config):
    check_trainable_quant(config, "pretrain")
    config.check_ported()
    w = (config.loss_weight if config.task != "r_byol"
         else (1.0, 0.0, 0.0, 0.0, 0.0))
    momentum = effective_byol_momentum(config)
    dtype = compute_dtype(config)
    use_fused = config.pallas_augment == "on"

    def augment(gen, frames1, frames2, rot1, rot2):
        data = mesh.mesh_axis("data")
        shard = (data.index, data.size)
        if use_fused:
            return pretrain_augment_batch_fused(
                gen, frames1, frames2, rot1, rot2,
                sample_size=config.sample_size,
                norm_method=config.norm_method, out_dtype=dtype, shard=shard)
        v1, v2, spa = pretrain_augment_batch(
            gen, frames1, frames2, rot1, rot2, sample_size=config.sample_size,
            norm_method=config.norm_method, shard=shard)
        return v1.to(dtype), v2.to(dtype), spa

    accum = config.grad_accum
    lr_mult = double_bias_lr(config)

    def train(state: TrainState, views_labels, lr):
        m = state.model
        ema_update(m.target_net, m.online_net, momentum)
        params = optim.trainable(m)
        grads, metrics = accumulated_grads(
            lambda mb: _loss_and_metrics(m, mb, w, config.ntxent_weight,
                                         config.temperature),
            microbatches(views_labels, accum), params)
        grads, metrics = all_reduce_step(m, grads, metrics, config)
        updates, state.opt_state = tx.update(grads, state.opt_state, params)
        optim.apply_lr(params, updates, lr, lr_mult(params))
        state.step += 1
        return state, metrics

    return augment, train


def all_reduce_step(model, grads: Dict[str, torch.Tensor], metrics,
                    config: Config):
    """Under a process group: the gradients and metrics averaged over
    'data' (one flat all-reduce each), the H-sharded towers' parameter
    gradients summed over 'model' first, and under --sync_bn 0 the BN
    running statistics averaged over 'data' too. ``(grads, metrics)``; the
    identity without a group."""
    if not mesh.is_distributed():
        return grads, metrics
    partial = spatially_partial_names(model)
    mesh.all_reduce_sum_([g for n, g in grads.items() if n in partial],
                         "model")
    mesh.all_reduce_mean_(grads.values())
    if not config.sync_bn:
        mesh.average_buffers_(model)
    return grads, mesh.mean_metrics(metrics)


def split_pretrain_step(model: CSTPPretrain, tx: optim.Optimizer,
                        config: Config):
    """The two programs behind :func:`make_pretrain_step`:
    ``(augment, train)``."""
    return _build_pretrain_programs(model, tx, config)


@torch.no_grad()
def bootstrap_store_scales(model: CSTPPretrain, v1: torch.Tensor,
                           v2: torch.Tensor) -> int:
    """The ``--quant int8_store`` bootstrap: one train-mode forward of the
    model on the views, without gradients, with its storage-chain sites
    switched to ``int8_store_calib`` (float chain; the delayed
    ``act_scale_*`` rise to the batch's exact observations and every BN
    running statistic moves once, as in the JAX package's bootstrap
    apply). Returns the number of sites."""
    with store_calibration(model) as n:
        model(v1, v2, train=True)
    return n


def make_pretrain_step(model: CSTPPretrain, tx: optim.Optimizer,
                       config: Config):
    """Returns ``step(state, generator, batch, lr) -> (state, metrics)``.

    ``batch``: ``frames1``/``frames2`` ``(B, T, H0, W0, 3)`` uint8,
    ``rot1``/``rot2``/``tem``/``pb`` ``(B,)`` integer labels, on the model's
    device; ``generator`` is a ``torch.Generator`` on that device and draws
    the augmentation. Metrics are 0-d tensors on the device.

    With ``--quant int8_store`` / ``int8_store_fz`` the step function's
    first call runs :func:`bootstrap_store_scales` on its views between the
    augment and the train program (before the target's EMA), so step 0
    never quantizes at the zero-initialised scales; a resumed run, a new
    step function, bootstraps again, as the JAX package's does.
    """
    augment, train = _build_pretrain_programs(model, tx, config)
    pending = [config.quant in ("int8_store", "int8_store_fz")]

    def step(state: TrainState, generator: torch.Generator,
             batch: Dict[str, torch.Tensor], lr):
        v1, v2, spa = augment(generator, batch["frames1"], batch["frames2"],
                              batch["rot1"], batch["rot2"])
        if pending[0]:
            bootstrap_store_scales(state.model, v1, v2)
            pending[0] = False
        return train(state, (v1, v2, spa, batch["tem"], batch["pb"],
                             batch["rot1"], batch["rot2"]), lr)

    return step


def make_preaugmented_step(model: CSTPPretrain, tx: optim.Optimizer,
                           config: Config):
    """Step on already-augmented views: ``step(state, batch, lr)`` with
    ``batch`` keys ``view1``, ``view2``, ``spa``, ``tem``, ``pb``, ``rot1``,
    ``rot2``."""
    _, train = _build_pretrain_programs(model, tx, config)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], lr):
        return train(state, tuple(batch[k] for k in (
            "view1", "view2", "spa", "tem", "pb", "rot1", "rot2")), lr)

    return step
