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

PyTorch state is mutable: a step updates ``state`` (parameters, BN running
statistics, optimizer state) in place and returns it with the metrics. The
port runs as one process on one device; data-parallel meshes are not
ported.
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
from cstp_tpu_torch.ssl.byol import CSTPPretrain, cross_entropy, ema_update
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
    """Size of the mesh 'data' axis, resolved against the port's single
    device."""
    shape = [1 if s == -1 else s for s in config.mesh_shape]
    n = shape[list(config.mesh_axes).index("data")]
    if n != 1:
        raise NotImplementedError(
            f"--mesh_shape {config.mesh_shape}: cstp_tpu_torch runs on one "
            "device; data-parallel meshes are not ported")
    return n


def bn_groups_from_config(config: Config) -> int:
    """--sync_bn 1 -> one group (global-batch statistics); --sync_bn 0 ->
    one group per data shard."""
    return 1 if config.sync_bn else data_shard_count(config)


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
                         compute_dtype(config), bn_groups_from_config(config),
                         int(config.fused_conv), gen,
                         concat_views=bool(config.concat_views),
                         remat=config.remat,
                         remat_policy=config.remat_policy,
                         shortcut=config.resnet_shortcut, alpha=config.alpha)
    return model.to(dev)


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
    state = TrainState(0, model, tx.init(optim.trainable(model)))
    return model, state, tx


def double_bias_lr(config: Config):
    """``params -> lr multipliers`` (``--double_bias_lr``) or ``None``."""
    if config.double_bias_lr:
        return optim.bias_double_lr_multipliers
    return lambda params: None


def _loss_and_metrics(model: CSTPPretrain, views_labels, w):
    v1, v2, spa, tem, pb, rot1, rot2 = views_labels
    byol, logits = model(v1, v2, train=True)
    p_spa, p_tem, p_pb1, p_pb2, p_rot1, p_rot2 = logits
    l_spa = cross_entropy(p_spa, spa)
    l_tem = cross_entropy(p_tem, tem)
    l_pb1, l_pb2 = cross_entropy(p_pb1, pb), cross_entropy(p_pb2, pb)
    l_rot1, l_rot2 = cross_entropy(p_rot1, rot1), cross_entropy(p_rot2, rot2)
    total = (w[0] * byol + w[1] * l_spa + w[2] * l_tem
             + w[3] * (l_pb1 + l_pb2) + w[4] * (l_rot1 + l_rot2))
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


def _build_pretrain_programs(model: CSTPPretrain, tx: optim.Optimizer,
                             config: Config):
    config.check_ported()
    w = (config.loss_weight if config.task != "r_byol"
         else (1.0, 0.0, 0.0, 0.0, 0.0))
    momentum = effective_byol_momentum(config)
    dtype = compute_dtype(config)
    use_fused = config.pallas_augment == "on"

    def augment(gen, frames1, frames2, rot1, rot2):
        if use_fused:
            return pretrain_augment_batch_fused(
                gen, frames1, frames2, rot1, rot2,
                sample_size=config.sample_size,
                norm_method=config.norm_method, out_dtype=dtype)
        v1, v2, spa = pretrain_augment_batch(
            gen, frames1, frames2, rot1, rot2, sample_size=config.sample_size,
            norm_method=config.norm_method)
        return v1.to(dtype), v2.to(dtype), spa

    accum = config.grad_accum
    lr_mult = double_bias_lr(config)

    def train(state: TrainState, views_labels, lr):
        m = state.model
        ema_update(m.target_net, m.online_net, momentum)
        params = optim.trainable(m)
        grads, metrics = accumulated_grads(
            lambda mb: _loss_and_metrics(m, mb, w),
            microbatches(views_labels, accum), params)
        updates, state.opt_state = tx.update(grads, state.opt_state, params)
        optim.apply_lr(params, updates, lr, lr_mult(params))
        state.step += 1
        return state, metrics

    return augment, train


def split_pretrain_step(model: CSTPPretrain, tx: optim.Optimizer,
                        config: Config):
    """The two programs behind :func:`make_pretrain_step`:
    ``(augment, train)``."""
    return _build_pretrain_programs(model, tx, config)


def make_pretrain_step(model: CSTPPretrain, tx: optim.Optimizer,
                       config: Config):
    """Returns ``step(state, generator, batch, lr) -> (state, metrics)``.

    ``batch``: ``frames1``/``frames2`` ``(B, T, H0, W0, 3)`` uint8,
    ``rot1``/``rot2``/``tem``/``pb`` ``(B,)`` integer labels, on the model's
    device; ``generator`` is a ``torch.Generator`` on that device and draws
    the augmentation. Metrics are 0-d tensors on the device.
    """
    augment, train = _build_pretrain_programs(model, tx, config)

    def step(state: TrainState, generator: torch.Generator,
             batch: Dict[str, torch.Tensor], lr):
        v1, v2, spa = augment(generator, batch["frames1"], batch["frames2"],
                              batch["rot1"], batch["rot2"])
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
