"""Finetune, validation and video-level test steps of the port.

The port of ``cstp_tpu/train/finetune.py``: model and state creation with
the frozen backbone prefixes of ``ft_fc`` / ``ft_begin_index``, the
finetune step (augment inside, ``grad_accum`` microbatches, the
configured optimizer without a clip), the eval step (mask-weighted sums),
the window logits and feature steps of the sliding-window test and
retrieval, and their host helpers.

As in ``train/pretrain.py``, a training step updates ``state`` (parameters,
BN running statistics, optimizer state) in place. Frozen parameters are
handed neither to autograd nor to the optimizer: they keep their values
bitwise, as the JAX package's ``set_to_zero`` partition does, and their BN
running statistics still move in train mode.

Under a process group (``parallel/mesh.py``) the finetune step averages
its gradients and metrics over 'data' once per optimizer step, with the
BatchNorm semantics of ``--sync_bn`` and the 'model' axis
(``--shard_spatial``, tensor-parallel MLP heads) as in
``train/pretrain.py``, and the eval step sums ``loss_sum``, ``correct`` and
``count`` over 'data'.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from cstp_tpu_torch import resolve_device
from cstp_tpu_torch.augment.pipeline import (
    eval_augment_batch,
    finetune_train_augment_batch,
)
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.parallel import mesh
from cstp_tpu_torch.pretext.sampling import (
    strided_frame_indices,
    wraparound_frame_indices,
)
from cstp_tpu_torch.ssl.byol import CSTPClassify, cross_entropy
from cstp_tpu_torch.train import optim
from cstp_tpu_torch.train.accum import accumulated_grads, microbatches
from cstp_tpu_torch.train.pretrain import (
    TrainState,
    all_reduce_step,
    check_trainable_quant,
    compute_dtype,
    double_bias_lr,
    local_bn_groups,
    place_on_mesh,
)


def create_classify_model(config: Config, num_classes: int, seed: int = 0,
                          device=None) -> CSTPClassify:
    """``CSTPClassify`` with its initial weights drawn on the CPU from
    ``seed``, moved to ``device`` (CUDA unless ``device="cpu"``).
    ``model_name`` ``*_classify`` selects the 'mlp' head, any other the
    'linear' head; ``--i3d_conv_head`` on an ``i3d*`` model the 'i3d_conv'
    head (224^2 only); ``--legacy_pace`` on bare ``r21d`` (that name only)
    the 'pace_project' head, whose 512 outputs take at most 512 classes."""
    config.check_ported()
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    head = "mlp" if config.model_name.endswith("_classify") else "linear"
    if config.i3d_conv_head and config.model_name.startswith("i3d"):
        head = "i3d_conv"
    if config.legacy_pace and config.model_name == "r21d":
        if num_classes > 512:
            raise ValueError(f"--legacy_pace head is fixed at 512 outputs, "
                             f"not {num_classes} classes")
        head = "pace_project"
    model = CSTPClassify(config.model_name, config.model_depth, num_classes,
                         use_cls_bn=config.cls_bn, head_style=head,
                         dtype=compute_dtype(config),
                         bn_groups=local_bn_groups(config),
                         fused_conv=bool(config.fused_conv), gen=gen,
                         shortcut=config.resnet_shortcut, alpha=config.alpha,
                         quant=config.quant, s2d_stem=config.s2d_stem,
                         mid_round=config.mid_round,
                         t_fold=bool(config.t_fold))
    return place_on_mesh(model, config).to(dev)


def finetune_frozen_prefixes(config: Config) -> Tuple[str, ...]:
    """The module paths a finetune run freezes (the JAX package's prefixes
    in the port's names): ``ft_all`` (index 0) trains everything; ``ft_fc``
    (5) only the classifier; index 1..4 freezes the stem, ``cls_bn``'s
    affine parameters and the stages ``conv2 .. conv{idx}``. Under
    ``--i3d_conv_head`` (an ``i3d*`` model) index 5 freezes I3D's stages
    and trains its internal classifier. Index 1..4 names modules that
    exist on no s3d, i3d or slowfast backbone (the prefixes match whole
    path parts: ``online_net.conv1`` is not ``online_net.slow_conv1``), so
    there it freezes ``cls_bn`` alone, as in the JAX package."""
    idx = config.ft_begin_index
    if config.task == "ft_fc":
        idx = 5
    elif config.task == "ft_all":
        idx = 0
    if idx == 0:
        return ()
    if idx >= 5:
        if config.i3d_conv_head and config.model_name.startswith("i3d"):
            from cstp_tpu_torch.models.i3d import MIXED, STEM

            stages = (*STEM, *(name for name, _ in MIXED))
            return tuple(f"online_net.{s}" for s in stages)
        return ("online_net", "cls_bn")
    frozen = ["online_net.conv1", "online_net.bn1", "cls_bn"]
    for i in range(1, idx):
        frozen.append(f"online_net.conv{i + 1}")
    return tuple(frozen)


def finetune_optimizer(config: Config, model: CSTPClassify
                       ) -> optim.Optimizer:
    """The finetune optimizer (no gradient clip); freezes the parameters
    under ``finetune_frozen_prefixes(config)`` in ``model`` and unfreezes
    the others."""
    optim.freeze(model, finetune_frozen_prefixes(config))
    tx = optim.make_optimizer(
        config.optimizer, momentum=config.momentum,
        weight_decay=config.weight_decay, dampening=config.dampening,
        nesterov=config.nesterov, clip_grad_norm=None)
    return optim.mesh_update(tx, model, bool(config.shard_opt_state))


def create_finetune_state(config: Config, num_classes: int, seed: int = 0,
                          device=None
                          ) -> Tuple[CSTPClassify, TrainState,
                                     optim.Optimizer]:
    model = create_classify_model(config, num_classes, seed, device)
    tx = finetune_optimizer(config, model)
    return model, TrainState(0, model, tx.init(optim.trainable(model))), tx


def _build_finetune_train(model: CSTPClassify, tx: optim.Optimizer,
                          config: Config):
    check_trainable_quant(config, "finetune")
    config.check_ported()
    accum = config.grad_accum
    lr_mult = double_bias_lr(config)

    def loss_fn(m, mb):
        x, y = mb
        logits = m(x, train=True)
        loss = cross_entropy(logits, y)
        with torch.no_grad():
            acc = (logits.argmax(-1) == y.long()).float().mean()
        return loss, {"loss": loss.detach(), "acc": acc}

    def train(state: TrainState, x, labels, lr):
        m = state.model
        params = optim.trainable(m)
        grads, metrics = accumulated_grads(
            lambda mb: loss_fn(m, mb), microbatches((x, labels), accum),
            params)
        grads, metrics = all_reduce_step(m, grads, metrics, config)
        updates, state.opt_state = tx.update(grads, state.opt_state, params)
        optim.apply_lr(params, updates, lr, lr_mult(params))
        state.step += 1
        return state, metrics

    return train


def make_finetune_step(model: CSTPClassify, tx: optim.Optimizer,
                       config: Config):
    """Returns ``step(state, generator, batch, lr) -> (state, metrics)``:
    the finetune augment (``batch["frames"]`` ``(B, T, H0, W0, 3)`` uint8,
    drawn from ``generator``), then the train program on
    ``batch["labels"]``. Metrics ``loss``/``acc`` are 0-d tensors."""
    train = _build_finetune_train(model, tx, config)
    dtype = compute_dtype(config)
    data = mesh.mesh_axis("data")

    def step(state: TrainState, generator: torch.Generator,
             batch: Dict[str, torch.Tensor], lr):
        x = finetune_train_augment_batch(
            generator, batch["frames"], sample_size=config.sample_size,
            norm_method=config.norm_method,
            shard=(data.index, data.size)).to(dtype)
        return train(state, x, batch["labels"], lr)

    return step


def make_preaugmented_finetune_step(model: CSTPClassify,
                                    tx: optim.Optimizer, config: Config):
    """Step on already-augmented clips: ``step(state, batch, lr)`` with
    ``batch`` keys ``clips`` (``(B, T, S, S, 3)``) and ``labels``."""
    train = _build_finetune_train(model, tx, config)
    dtype = compute_dtype(config)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], lr):
        return train(state, batch["clips"].to(dtype), batch["labels"], lr)

    return step


def _eval_clips(frames, config: Config):
    return eval_augment_batch(frames, sample_size=config.sample_size,
                              norm_method=config.norm_method
                              ).to(compute_dtype(config))


def make_eval_step(model: CSTPClassify, config: Config):
    """``step(state, batch) -> dict``: deterministic scale + centre crop,
    the eval-mode forward (running statistics), and mask-weighted sums
    ``loss_sum``/``correct``/``count`` (rows of ``batch["mask"]`` 0 pad a
    tail batch; without a mask every row counts), their means ``loss`` and
    ``acc``, and the ``logits`` (this rank's). Under a process group the
    sums are over every data row's rows."""

    @torch.no_grad()
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        logits = state.model(_eval_clips(batch["frames"], config),
                             train=False)
        labels = batch["labels"].long()
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(logits.shape[0], device=logits.device)
        mask = mask.float()
        per_loss = cross_entropy(logits, labels, reduce=False)
        hits = (logits.argmax(-1) == labels).float()
        sums = torch.stack([(per_loss * mask).sum(), (hits * mask).sum(),
                            mask.sum()])
        loss_sum, correct, count = mesh.all_reduce_sum(sums).unbind(0)
        return {"loss_sum": loss_sum, "correct": correct, "count": count,
                "loss": loss_sum / torch.clamp(count, min=1.0),
                "acc": correct / torch.clamp(count, min=1.0),
                "logits": logits}

    return step


def make_logits_step(model: CSTPClassify, config: Config):
    """``step(state, windows) -> (N, C) logits`` for the ``(N, T, H0, W0,
    3)`` uint8 test windows of one video (eval augment, eval mode)."""

    @torch.no_grad()
    def step(state: TrainState, windows: torch.Tensor):
        return state.model(_eval_clips(windows, config), train=False)

    return step


def make_features_step(model: CSTPClassify, config: Config):
    """``step(state, windows) -> (N, D)`` L2-normalised backbone features
    (``feat / (|feat| + 1e-12)``) of one video's windows, for retrieval."""

    @torch.no_grad()
    def step(state: TrainState, windows: torch.Tensor):
        feat = state.model.features(_eval_clips(windows, config),
                                    train=False)
        return feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
                       + 1e-12)

    return step


RETRIEVAL_TOPK = (1, 5, 10, 20, 50)


def retrieval_recalls(query_feats: np.ndarray, query_labels: np.ndarray,
                      gallery_feats: np.ndarray, gallery_labels: np.ndarray,
                      topk: Tuple[int, ...] = RETRIEVAL_TOPK,
                      chunk: int = 512, return_per_query: bool = False,
                      device=None):
    """Nearest-neighbour video retrieval R@k: cosine similarity of
    L2-normalised features (query = test split, gallery = train split); a
    query counts at k if any of its k nearest gallery videos shares its
    class. Similarity and top-k run on ``device`` (CUDA unless asked
    otherwise) in query chunks. ``return_per_query`` also returns the
    per-query R@1 hit vector."""
    dev = resolve_device(device)
    ks = tuple(int(k) for k in topk)
    max_k = min(max(ks), gallery_feats.shape[0])
    gallery = torch.as_tensor(np.asarray(gallery_feats), device=dev)
    hits = {k: 0 for k in ks}
    n = query_feats.shape[0]
    hit1 = np.zeros(n, bool)
    for s in range(0, n, chunk):
        q = torch.as_tensor(np.asarray(query_feats[s:s + chunk]), device=dev)
        idx = torch.topk(q @ gallery.T, max_k, dim=1).indices.cpu().numpy()
        match = gallery_labels[idx] == query_labels[s:s + idx.shape[0], None]
        hit1[s:s + idx.shape[0]] = match[:, :1].any(axis=1)
        for k in ks:
            hits[k] += int(match[:, :min(k, max_k)].any(axis=1).sum())
    recalls = {f"R@{k}": hits[k] / max(n, 1) for k in ks}
    return (recalls, hit1) if return_per_query else recalls


WINDOW_BUCKETS = (4, 8, 16, 32, 64)


def pad_windows_to_bucket(windows: np.ndarray,
                          buckets: Tuple[int, ...] = WINDOW_BUCKETS):
    """Pad a ``(N, ...)`` window batch to the smallest bucket >= N (a
    multiple of the largest past it) by repeating the last window; returns
    ``(padded, N)``, the padding to be sliced off the logits.

    The JAX package pads so that one compiled program serves every video
    length. Eager PyTorch compiles nothing, so here the padding only adds
    work; it pays only under ``torch.compile`` or CUDA graphs, which the
    port's test steps do not use yet."""
    n = windows.shape[0]
    b = next((b for b in buckets if b >= n), None)
    if b is None:
        step = buckets[-1]
        b = -(-n // step) * step
    if b == n:
        return windows, n
    pad = np.repeat(windows[-1:], b - n, axis=0)
    return np.concatenate([windows, pad], axis=0), n


def sliding_window_indices(nframes: int, sample_duration: int, pb_rate: int,
                           max_windows: int = 0) -> np.ndarray:
    """Non-overlapping test windows of span ``(L - 1) * pb_rate + 1`` from
    frame 0, plus one tail window anchored at the video's end; a video
    shorter than a span gives one wrap-around window. Returns ``(N, L)``
    0-based frame indices."""
    span = (sample_duration - 1) * pb_rate + 1
    if nframes < span:
        return np.stack([wraparound_frame_indices(nframes, sample_duration,
                                                  pb_rate)])
    out = []
    start = 0
    while start + span <= nframes:
        out.append(strided_frame_indices(start, sample_duration, pb_rate))
        start += span
    if start < nframes:
        out.append(strided_frame_indices(nframes - span, sample_duration,
                                         pb_rate))
    if max_windows:
        out = out[:max_windows]
    return np.stack(out)
