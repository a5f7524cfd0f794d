"""Host-side epoch loops: pretrain, finetune, video-level test and
retrieval. The port of the JAX package's ``train/loops.py``, on the steps
of ``train/pretrain.py`` and ``train/finetune.py``.

The device runs ahead of the host: per-step metrics stay on the device as
0-d tensors and are stacked and copied to the host once per epoch; only
``--log_every`` fetches a step's metrics (and so waits for it). Each loop
runs on CUDA unless the caller passes ``device="cpu"``.

Each ``run_*`` returns what the JAX loop returns, plus ``timing``: per
epoch, the host wall time of each step and of each wait for data
(``StepTimer``) and the epoch's wall time up to its metrics on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from cstp_tpu_torch import resolve_device
from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
from cstp_tpu_torch.config import Config
from cstp_tpu_torch.data.labels import read_class_names
from cstp_tpu_torch.data.loader import (
    FinetuneLoader,
    PretrainLoader,
    prefetch_to_device,
)
from cstp_tpu_torch.models import torch_import
from cstp_tpu_torch.models.i3d_tf_import import load_tf_i3d
from cstp_tpu_torch.train import optim
from cstp_tpu_torch.train.finetune import (
    RETRIEVAL_TOPK,
    create_finetune_state,
    make_eval_step,
    make_features_step,
    make_finetune_step,
    make_logits_step,
    pad_windows_to_bucket,
    retrieval_recalls,
    sliding_window_indices,
)
from cstp_tpu_torch.train.meters import AverageMeter, Logger, StepTimer
from cstp_tpu_torch.train.pretrain import (
    create_pretrain_state,
    data_shard_count,
    make_pretrain_step,
)
from cstp_tpu_torch.utils import profiling
from cstp_tpu_torch.utils.preemption import PreemptionGuard
from cstp_tpu_torch.utils.tb import maybe_tb_writer

# Reference dataset class names -> (data_backend, dataset family), so the
# reference's invocations (``--dataset Kin400RepreLMDB``) run unchanged.
REFERENCE_DATASET_ALIASES = {
    "UcfBYOLOnline": ("framedir", "UCF101"),
    "UcfBYOLOnlineSelfTrans": ("framedir", "UCF101"),
    "UcfRepre": ("framedir", "UCF101"),
    "UcfRepreBYOL": ("framedir", "UCF101"),
    "UcfRepreBYOLSpPre": ("framedir", "UCF101"),
    "UcfFineTune": ("framedir", "UCF101"),
    "UcfTempTrans": ("framedir", "UCF101"),
    "UCFFTOnline": ("framedir", "UCF101"),
    "UCF101RepreLMDB": ("lmdb", "UCF101"),
    "UcfFineTuneLMDB": ("lmdb", "UCF101"),
    "Kin400RepreLMDB": ("lmdb", "Kin400"),
    "Kin400FTOfflineLMDB": ("lmdb", "Kin400"),
    "KINFTOffline": ("framedir", "Kin400"),
    "KINFTOnlineDecord": ("video", "Kin400"),
    "KINFTOnline": ("video", "Kin400"),
}


def resolve_dataset_alias(config: Config) -> Config:
    """If ``--dataset`` is a reference dataset class name, derive the backend
    and dataset family from it (overriding ``--data_backend``)."""
    alias = REFERENCE_DATASET_ALIASES.get(config.dataset)
    if alias is None:
        return config
    backend, family = alias
    return dataclasses.replace(config, data_backend=backend, dataset=family)


def build_dataset(config: Config, data_type: str):
    """The reader of ``config.data_backend`` for the ``data_type`` split
    ("train", "val" or "test")."""
    config = resolve_dataset_alias(config)
    if config.data_backend == "synthetic":
        from cstp_tpu_torch.data.synthetic import SyntheticVideoDataset

        return SyntheticVideoDataset(
            n_videos=config.synthetic_len, n_classes=config.n_classes,
            ingest_hw=(128, 171),
            learnable=bool(config.synthetic_learnable))
    if config.data_backend == "framedir":
        from cstp_tpu_torch.data.framedir import FrameDirDataset

        return FrameDirDataset(config.frame_dir, config.annotation_path,
                               config.split, data_type=data_type)
    if config.data_backend == "lmdb":
        from cstp_tpu_torch.data.lmdb_dataset import LMDBVideoDataset

        return LMDBVideoDataset(
            config.lmdb_path, config.annotation_path, dataset=config.dataset,
            data_type=data_type, split=config.split)
    if config.data_backend == "video":
        from cstp_tpu_torch.data.video import VideoDataset

        return VideoDataset(
            config.frame_dir, config.annotation_path, dataset=config.dataset,
            data_type=data_type, split=config.split)
    if config.data_backend == "packed":
        # the Python reader: the JAX package's own path where its C++
        # reader is not built
        from cstp_tpu_torch.data.packed import PackedDataset

        path = config.lmdb_path
        if data_type != "train":
            alt = path.replace("train", "val" if data_type == "val"
                               else "test")
            if os.path.exists(alt):
                path = alt
        return PackedDataset(path)
    raise ValueError(f"unknown data_backend {config.data_backend!r}")


def _log_dir(config: Config) -> str:
    # result_path/dataset/task; a resume keeps writing where the original
    # run did, the checkpoint's parent directory
    if config.task == "resume" and config.resume_md_path:
        return os.path.dirname(os.path.abspath(config.resume_md_path))
    d = os.path.join(config.result_path, config.dataset, config.task)
    os.makedirs(d, exist_ok=True)
    _dump_config(config, d)
    return d


def _dump_config(config: Config, log_dir: str) -> None:
    """The run's resolved flags as ``config.json`` in the run directory."""
    try:
        with open(os.path.join(log_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=1,
                      sort_keys=True, default=str)
    except OSError:
        pass  # read-only result dir: the record is best-effort


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree


def _restore_state(state, tree, dev) -> None:
    """A train state's tree (``ckpt.state_tree``) back into ``state``."""
    state.model.load_state_dict(tree["model"])
    state.opt_state = _to_device(tree["opt_state"], dev)
    state.step = int(tree["step"])


def _load_model_by_name(state, tree) -> None:
    own = state.model.state_dict()
    state.model.load_state_dict(ckpt_lib._merge_by_name(own, tree["model"]))


def _load_reference_pth(state, config: Config, check_arch: bool) -> None:
    """A reference ``save_{E}.pth`` in ``--pretrained_path``, translated and
    laid over ``state.model`` by name. ``check_arch``: hold the blob's arch
    tag to ``config.arch`` (the JAX package's finetune check; its retrieval
    makes none)."""
    tree, meta = torch_import.load_torch_checkpoint(config.pretrained_path,
                                                    config.model_name)
    if check_arch:
        ckpt_lib.check_arch(config.pretrained_path, meta, config)
    torch_import.load_into(state.model, tree)


def _fetch(metrics):
    """A list of per-step metric dicts (0-d device tensors) -> one host
    float32 array per key: one copy per key, at the epoch's end."""
    if not metrics:
        return {}
    return {k: torch.stack([m[k] for m in metrics]).float().cpu().numpy()
            for k in metrics[0]}


class _EpochClock:
    """Per-step host wall times of one epoch (``StepTimer``'s values) and
    the epoch's wall time up to its metrics on the host."""

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.timer = StepTimer()
        self.t0 = time.perf_counter()
        self.step_s, self.wait_s = [], []

    def data_tick(self) -> None:
        self.timer.data_tick()
        self.wait_s.append(self.timer.data_time.val)

    def batch_tick(self) -> None:
        self.timer.batch_tick()
        self.step_s.append(self.timer.batch_time.val)

    def record(self) -> Dict:
        return {"epoch": self.epoch, "steps": len(self.step_s),
                "step_s": self.step_s, "wait_s": self.wait_s,
                "epoch_s": time.perf_counter() - self.t0}


def run_pretrain(config: Config, max_steps_per_epoch: int = 0,
                 device=None) -> Dict:
    """The pretrain loop (the reference's ``main_byol.py`` train loop)."""
    if config.task not in ("loss_com", "r_byol", "resume"):
        raise ValueError(f"run_pretrain: task {config.task!r}")
    dev = resolve_device(device)
    data_shard_count(config)
    if config.steps_per_epoch and not max_steps_per_epoch:
        max_steps_per_epoch = config.steps_per_epoch
    dataset = build_dataset(config, "train")
    loader = PretrainLoader(
        dataset, config.batch_size, config.sample_duration,
        seed=config.manual_seed, num_workers=config.n_workers,
        echo=config.data_echo)
    model, state, tx = create_pretrain_state(config, seed=config.manual_seed,
                                             device=dev)
    if config.tf_i3d_ckpt:
        # a kinetics-i3d checkpoint seeds both towers (the reference loads
        # it into the I3D base that online and target start from)
        for tower in (model.online_net, model.target_net):
            load_tf_i3d(tower, config.tf_i3d_ckpt)
    step_fn = make_pretrain_step(model, tx, config)

    log_dir = _log_dir(config)
    begin_epoch = 1
    resume_from = None
    if config.task == "resume":
        resume_from = config.resume_md_path
    elif config.auto_resume:
        resume_from = ckpt_lib.latest_checkpoint(log_dir)
    if resume_from:
        begin_epoch = ckpt_lib.epoch_from_name(resume_from)
        tree, meta = ckpt_lib.restore_checkpoint(resume_from)
        if meta.get("arch") != config.arch:
            raise ValueError(f"checkpoint {resume_from} holds arch "
                             f"{meta.get('arch')!r}, the config asks for "
                             f"{config.arch!r}")
        _restore_state(state, tree, dev)

    logger = Logger(
        os.path.join(log_dir,
                     f"{config.dataset}_train_clip{config.sample_duration}"
                     f"model{config.model_name}{config.model_depth}.log"),
        ["epoch", "loss", "loss_byol", "loss_pred_spa", "loss_pred_tem",
         "loss_pred_pb", "loss_pred_rot", "acc", "lr"],
        overlay=resume_from is None)
    lr_fn = optim.cosine_warmup_restarts(
        config.learning_rate, config.n_epochs, 0.5 * config.n_epochs,
        min_lr=1e-5, gamma=0.5)
    tb = maybe_tb_writer(config.tb_dir, "pretrain")
    gen = torch.Generator(device=dev).manual_seed(config.manual_seed + 17)
    history, timing = [], []
    n_batches = len(loader)
    # holds the profiler capture of --profile_dir while it is open
    tracing = contextlib.ExitStack()
    # SIGTERM -> finish the current step, save save_{epoch}, stop; a resume
    # redoes the interrupted epoch
    guard = PreemptionGuard(enabled=bool(config.graceful_preempt))
    global_step = 0
    preempted = False
    for epoch in range(begin_epoch, config.n_epochs + 1):
        lr = lr_fn(epoch - 1)
        clock = _EpochClock(epoch)
        step_meters = {
            k: AverageMeter()
            for k in ("loss", "loss_byol", "loss_pred_spa", "loss_pred_tem",
                      "loss_pred_pb", "loss_pred_rot")}
        epoch_metrics = []
        with contextlib.closing(prefetch_to_device(
                loader.epoch(epoch), dev,
                depth=config.prefetch_depth)) as it:
            for i, batch in enumerate(it):
                clock.data_tick()
                if config.profile_dir and epoch == begin_epoch and i == 2:
                    tracing.enter_context(profiling.trace(
                        config.profile_dir, cuda=dev.type == "cuda"))
                state, metrics = step_fn(state, gen, batch, lr)
                epoch_metrics.append(metrics)
                clock.batch_tick()
                if i + 1 >= 2 + config.profile_steps:
                    tracing.close()
                if config.log_every and (i + 1) % config.log_every == 0:
                    # fetching a step's metrics waits for it
                    m = {k: float(v) for k, v in metrics.items()}
                    for k, meter in step_meters.items():
                        meter.update(m[k])
                    if tb:
                        tb.add_scalars({k: m[k] for k in step_meters},
                                       (epoch - 1) * n_batches + i + 1,
                                       prefix="step/")
                    t, lt = clock.timer, step_meters["loss"]
                    lb = step_meters["loss_byol"]
                    print(
                        f"Epoch: [{epoch}][{i + 1}/{n_batches}]\t"
                        f"Time {t.batch_time.val:.3f} ({t.batch_time.avg:.3f})\t"
                        f"Data {t.data_time.val:.3f} ({t.data_time.avg:.3f})\t"
                        f"Loss_byol {lb.val:.4f} ({lb.avg:.4f})\t"
                        f"Loss_pred_spa {step_meters['loss_pred_spa'].val:.4f}\t"
                        f"Loss_pred_tem {step_meters['loss_pred_tem'].val:.4f}\t"
                        f"Loss_pred_pb {step_meters['loss_pred_pb'].val:.4f}\t"
                        f"Loss_pred_rot {step_meters['loss_pred_rot'].val:.4f}\t"
                        f"Loss_total {lt.val:.4f} ({lt.avg:.4f})\t"
                        f"Lr {float(lr):.4}",
                        flush=True)
                global_step += 1
                if guard.requested(global_step):
                    preempted = True
                    break
                if max_steps_per_epoch and i + 1 >= max_steps_per_epoch:
                    break
        tracing.close()  # a short epoch: close the trace cleanly
        fetched = _fetch(epoch_metrics)
        timing.append(clock.record())
        avg = {k: float(np.mean(v)) for k, v in fetched.items()}
        row = {
            "epoch": epoch,
            "loss": avg.get("loss"),
            "loss_byol": avg.get("loss_byol"),
            "loss_pred_spa": avg.get("loss_pred_spa"),
            "loss_pred_tem": avg.get("loss_pred_tem"),
            "loss_pred_pb": avg.get("loss_pred_pb"),
            "loss_pred_rot": avg.get("loss_pred_rot"),
            "acc": avg.get("acc_pretext"),
            "lr": float(f"{float(lr):.5f}"),
        }
        # a preempted epoch's means cover only its completed steps: the row
        # stays in the returned history but not in the CSV or TensorBoard,
        # since the resume redoes the epoch and logs its full row
        if not preempted:
            logger.log(row)
            if tb:
                tb.add_scalars({k: v for k, v in row.items()
                                if k != "epoch"}, epoch, prefix="epoch/")
                tb.flush()
        history.append(row)
        if preempted:
            ckpt_lib.save_checkpoint(
                os.path.join(log_dir, ckpt_lib.ckpt_name(epoch)),
                ckpt_lib.state_tree(state),
                meta={"arch": config.arch, "epoch": epoch,
                      "preempted": True})
            print(f"Preempted at epoch {epoch} step {global_step}: "
                  f"checkpoint saved; relaunch with --auto_resume "
                  f"(or --task resume) to continue", flush=True)
            break
        if epoch % config.ckpt_every_epochs == 0:
            ckpt_lib.save_checkpoint(
                os.path.join(log_dir, ckpt_lib.ckpt_name(epoch)),
                ckpt_lib.state_tree(state),
                meta={"arch": config.arch, "epoch": epoch + 1})
    guard.close()
    if tb:
        tb.close()
    logger.close()
    return {"history": history, "state": state, "model": model,
            "preempted": preempted, "timing": timing}


def run_finetune(config: Config, max_steps_per_epoch: int = 0,
                 device=None) -> Dict:
    """The finetune loop (the reference's ``main_ft_mp.py``): per-epoch train
    and validation, ``ReduceLROnPlateau`` on the validation loss, and only
    the best validation epoch's checkpoint kept (``save_{E}_max``)."""
    if config.task not in ("ft_fc", "ft_all", "scratch", "resume"):
        raise ValueError(f"run_finetune: task {config.task!r}")
    dev = resolve_device(device)
    data_shard_count(config)
    if config.steps_per_epoch and not max_steps_per_epoch:
        max_steps_per_epoch = config.steps_per_epoch
    train_ds = build_dataset(config, "train")
    val_ds = build_dataset(config, "val")
    train_loader = FinetuneLoader(
        train_ds, config.batch_size, config.sample_duration,
        config.clip_stride, train=True, seed=config.manual_seed,
        num_workers=config.n_workers)
    # drop_last=False and a padded, masked tail batch: every val video
    # counts once
    val_loader = FinetuneLoader(
        val_ds, config.batch_size, config.sample_duration,
        config.clip_stride, train=False, seed=config.manual_seed,
        num_workers=config.n_workers, drop_last=False)
    num_classes = config.n_finetune_classes or config.n_classes
    model, state, tx = create_finetune_state(
        config, num_classes, seed=config.manual_seed, device=dev)
    if config.tf_i3d_ckpt:
        load_tf_i3d(model.online_net, config.tf_i3d_ckpt)

    # pretrained backbone, loaded by name (the head keeps its init); a
    # file is a reference torch save_{E}.pth (models/torch_import.py)
    if config.task in ("ft_fc", "ft_all") and config.pretrained_path:
        if os.path.isfile(config.pretrained_path):
            _load_reference_pth(state, config, check_arch=True)
        else:
            ckpt_lib.load_pretrained(state, config.pretrained_path, config)

    plateau = optim.ReduceLROnPlateau(lr=config.learning_rate,
                                      patience=config.lr_patience)
    best = {"acc": -1.0, "path": None, "epoch": 0}
    begin_epoch = 1
    if config.task == "resume":
        # parameters, optimizer, plateau and best accuracy from
        # save_{E}_max (or a preempted save_{E}); the caller passes the
        # original run's --ft_begin_index
        if not config.resume_md_path:
            raise ValueError("finetune resume needs --resume_md_path")
        tree, meta = ckpt_lib.restore_checkpoint(config.resume_md_path)
        if config.arch not in str(meta.get("arch", config.arch)):
            raise ValueError(f"checkpoint {config.resume_md_path} holds arch "
                             f"{meta.get('arch')!r}, the config asks for "
                             f"{config.arch!r}")
        _restore_state(state, tree, dev)
        if "plateau" in meta:
            plateau = optim.ReduceLROnPlateau.from_state_dict(meta["plateau"])
        ep = ckpt_lib.epoch_from_name(config.resume_md_path)
        best = {"acc": float(meta.get("best_acc", -1.0)),
                "path": config.resume_md_path, "epoch": ep}
        begin_epoch = int(meta.get("epoch", ep + 1))

    step_fn = make_finetune_step(model, tx, config)
    eval_fn = make_eval_step(model, config)
    log_dir = _log_dir(config)
    stem = (f"{config.dataset}_clip{config.sample_duration}"
            f"model{config.model_name}{config.model_depth}.log")
    overlay = config.task != "resume"
    train_logger = Logger(os.path.join(log_dir, "train_" + stem),
                          ["epoch", "loss", "acc", "lr"], overlay=overlay)
    val_logger = Logger(os.path.join(log_dir, "val_" + stem),
                        ["epoch", "loss", "acc"], overlay=overlay)
    tb = maybe_tb_writer(config.tb_dir, "finetune")
    gen = torch.Generator(device=dev).manual_seed(config.manual_seed + 23)
    history, timing = [], []
    n_batches = len(train_loader)
    guard = PreemptionGuard(enabled=bool(config.graceful_preempt))
    global_step = 0
    preempted = False
    for epoch in range(begin_epoch, config.n_epochs + 1):
        lr = plateau.lr
        train_ms = []
        clock = _EpochClock(epoch)
        loss_m, acc_m = AverageMeter(), AverageMeter()
        with contextlib.closing(prefetch_to_device(
                train_loader.epoch(epoch), dev,
                depth=config.prefetch_depth)) as it:
            for i, batch in enumerate(it):
                clock.data_tick()
                state, metrics = step_fn(state, gen, batch, lr)
                train_ms.append(metrics)
                clock.batch_tick()
                if config.log_every and (i + 1) % config.log_every == 0:
                    loss_m.update(float(metrics["loss"]))
                    acc_m.update(float(metrics["acc"]))
                    t = clock.timer
                    left_d = (t.batch_time.avg
                              * ((config.n_epochs - epoch) * n_batches
                                 + n_batches - i - 1)) / 3600 / 24
                    print(
                        f"Epoch: [{epoch}][{i + 1}/{n_batches}]\t"
                        f"Time {t.batch_time.val:.3f} ({t.batch_time.avg:.3f})\t"
                        f"Data {t.data_time.val:.3f} ({t.data_time.avg:.3f})\t"
                        f"Loss {loss_m.val:.4f} ({loss_m.avg:.4f})\t"
                        f"Acc {acc_m.val:.3f} ({acc_m.avg:.3f})\t"
                        f"Lr {plateau.lr:.6f}\t"
                        f"Left {left_d:.1f}d",
                        flush=True)
                global_step += 1
                if guard.requested(global_step):
                    preempted = True
                    break
                if max_steps_per_epoch and i + 1 >= max_steps_per_epoch:
                    break
        val_ms = []
        if not preempted:
            with contextlib.closing(prefetch_to_device(
                    val_loader.epoch(epoch), dev,
                    depth=config.prefetch_depth)) as it:
                for i, batch in enumerate(it):
                    out = eval_fn(state, batch)
                    val_ms.append({k: out[k] for k in
                                   ("loss_sum", "correct", "count")})
                    global_step += 1
                    if guard.requested(global_step):
                        preempted = True
                        break
                    if max_steps_per_epoch and i + 1 >= max_steps_per_epoch:
                        break
        train_f, val_f = _fetch(train_ms), _fetch(val_ms)
        timing.append(clock.record())
        t_loss = float(np.mean(train_f["loss"])) if train_ms else 0.0
        t_acc = float(np.mean(train_f["acc"])) if train_ms else 0.0
        # sums: padded rows (mask 0) add nothing, each video counts once
        v_count = float(np.sum(val_f["count"])) if val_ms else 0.0
        v_loss = (float(np.sum(val_f["loss_sum"])) / v_count
                  if v_count else 0.0)
        v_acc = (float(np.sum(val_f["correct"])) / v_count
                 if v_count else 0.0)
        if preempted:
            # a resumable (not best) checkpoint; meta epoch = this epoch, so
            # --task resume redoes it. Partial val numbers are dropped.
            ckpt_lib.save_checkpoint(
                os.path.join(log_dir, ckpt_lib.ckpt_name(epoch)),
                ckpt_lib.state_tree(state),
                meta={"arch": config.arch, "epoch": epoch,
                      "plateau": plateau.state_dict(),
                      "best_acc": best["acc"], "preempted": True})
            print(f"Preempted at epoch {epoch} step {global_step}: "
                  f"checkpoint saved; relaunch with --task resume "
                  f"--resume_md_path .../{ckpt_lib.ckpt_name(epoch)} to "
                  f"continue", flush=True)
            break
        plateau.step(v_loss)
        train_logger.log({"epoch": epoch, "loss": t_loss, "acc": t_acc,
                          "lr": float(f"{plateau.lr:.5f}")})
        val_logger.log({"epoch": epoch, "loss": v_loss, "acc": v_acc})
        if tb:
            tb.add_scalars({"loss": t_loss, "acc": t_acc, "lr": plateau.lr},
                           epoch, prefix="train/")
            tb.add_scalars({"loss": v_loss, "acc": v_acc}, epoch,
                           prefix="val/")
            tb.flush()
        if v_acc > best["acc"]:  # keep only the best epoch's checkpoint
            if best["path"]:
                ckpt_lib.delete_checkpoint(best["path"])
            path = os.path.join(log_dir, ckpt_lib.ckpt_name(epoch, best=True))
            ckpt_lib.save_checkpoint(
                path, ckpt_lib.state_tree(state),
                meta={"arch": config.arch, "epoch": epoch + 1,
                      "plateau": plateau.state_dict(), "best_acc": v_acc})
            best = {"acc": v_acc, "path": path, "epoch": epoch}
        history.append({"epoch": epoch, "train_loss": t_loss,
                        "train_acc": t_acc, "val_loss": v_loss,
                        "val_acc": v_acc, "lr": plateau.lr})
    guard.close()
    if tb:
        tb.close()
    train_logger.close()
    val_logger.close()
    return {"history": history, "state": state, "model": model, "best": best,
            "preempted": preempted, "timing": timing}


def _window_batch(dataset, i: int, config: Config, dev, max_windows: int = 0):
    """One video's sliding windows as a device batch, padded to a window
    bucket; returns ``(windows, n_real, label)``."""
    nframes, label = dataset.video_meta(i)
    windows = sliding_window_indices(nframes, config.sample_duration,
                                     config.clip_stride,
                                     max_windows=max_windows)
    frames = np.stack([dataset.read_frames(i, w) for w in windows])
    padded, n_real = pad_windows_to_bucket(frames)
    return torch.from_numpy(padded).to(dev), n_real, label


def run_test(config: Config, max_videos: int = 0, device=None) -> Dict:
    """Video-level sliding-window test (the reference's ``test.py``): per
    video, the mean of its windows' logits -> top-1 / top-5."""
    dev = resolve_device(device)
    data_shard_count(config)
    dataset = build_dataset(config, "test")
    num_classes = config.n_finetune_classes or config.n_classes
    model, state, _ = create_finetune_state(
        config, num_classes, seed=config.manual_seed, device=dev)

    md_path = config.test_md_path
    if not md_path:
        md_path = ckpt_lib.find_best_checkpoint(
            os.path.join(config.result_path, config.dataset,
                         config.t_ft_task))
    tree, meta = ckpt_lib.restore_checkpoint(md_path)
    if config.arch != str(meta.get("arch", config.arch)):
        raise ValueError(f"checkpoint {md_path} holds arch "
                         f"{meta.get('arch')!r}, the config asks for "
                         f"{config.arch!r}")
    _load_model_by_name(state, tree)
    logits_fn = make_logits_step(model, config)

    result_dir = os.path.join(config.result_path, config.dataset)
    os.makedirs(result_dir, exist_ok=True)
    report = os.path.join(
        result_dir,
        f"test_{config.model_name}{config.model_depth}_{config.dataset}_"
        f"{config.split}_{config.modality}_{config.sample_duration}"
        "_plusone.txt")
    n = dataset.num_videos()
    if max_videos:
        n = min(n, max_videos)
    # class names when annotation_path ships classInd.txt
    names = read_class_names(config.annotation_path)

    def nm(c):
        return f" ({names[c]})" if names and 0 <= c < len(names) else ""

    correct = 0
    lines = []
    for i in range(n):
        windows, n_real, label = _window_batch(dataset, i, config, dev)
        logits = logits_fn(state, windows).float().cpu().numpy()[:n_real]
        mean_logits = logits.mean(axis=0)
        pred5 = np.argsort(-mean_logits)[:5]
        correct += int(pred5[0] == label)
        acc = correct / (i + 1)
        lines.append(
            f"Video[{i}]:\ttop5 = {pred5}\ttop1 = {pred5[0]}{nm(pred5[0])}"
            f"\tgt = {label}{nm(label)}\tacc = {acc}")
    acc = correct / max(n, 1)
    with open(report, "w+") as f:
        f.write(str(config.to_json()) + "\n")
        f.write("\n".join(lines) + "\n")
        f.write("Video accuracy = " + str(acc) + "\n")
    return {"accuracy": acc, "report": report, "n_videos": n}


def _extract_video_features(dataset, config: Config, state, feats_fn, dev,
                            max_videos: int = 0):
    """Per-video retrieval descriptor: the mean of L2-normalised window
    features (at most ``config.retrieval_clips`` windows), normalised."""
    n = dataset.num_videos()
    if max_videos:
        n = min(n, max_videos)
    feats, labels = [], np.zeros(n, np.int64)
    for i in range(n):
        windows, n_real, label = _window_batch(
            dataset, i, config, dev, max_windows=config.retrieval_clips)
        f = feats_fn(state, windows).float().cpu().numpy()[:n_real]
        v = f.mean(axis=0)
        feats.append(v / (np.linalg.norm(v) + 1e-12))
        labels[i] = label
    return np.stack(feats).astype(np.float32), labels


def run_retrieval(config: Config, max_videos: int = 0, device=None) -> Dict:
    """Nearest-neighbour video retrieval (task ``retrieval``): test-split
    videos query the train-split gallery by cosine similarity of backbone
    features; R@{1,5,10,20,50}.

    Weights: ``--pretrained_path`` (a pretrain checkpoint or a reference
    ``.pth`` file, loaded by name), else ``--test_md_path``, else the one ``*_max`` finetune checkpoint of
    ``--t_ft_task`` (default ft_all)."""
    dev = resolve_device(device)
    data_shard_count(config)
    num_classes = config.n_finetune_classes or config.n_classes
    model, state, _ = create_finetune_state(
        config, num_classes, seed=config.manual_seed, device=dev)

    if config.pretrained_path and os.path.isfile(config.pretrained_path):
        _load_reference_pth(state, config, check_arch=False)
    elif config.pretrained_path:
        tree, _ = ckpt_lib.restore_checkpoint(config.pretrained_path)
        _load_model_by_name(state, tree)
    else:
        md_path = config.test_md_path or ckpt_lib.find_best_checkpoint(
            os.path.join(config.result_path, config.dataset,
                         config.t_ft_task or "ft_all"))
        tree, meta = ckpt_lib.restore_checkpoint(md_path)
        if config.arch != str(meta.get("arch", config.arch)):
            raise ValueError(f"checkpoint {md_path} holds arch "
                             f"{meta.get('arch')!r}, the config asks for "
                             f"{config.arch!r}")
        _load_model_by_name(state, tree)

    feats_fn = make_features_step(model, config)
    gallery_ds = build_dataset(config, "train")
    query_ds = build_dataset(config, "test")
    g_feats, g_labels = _extract_video_features(gallery_ds, config, state,
                                                feats_fn, dev, max_videos)
    q_feats, q_labels = _extract_video_features(query_ds, config, state,
                                                feats_fn, dev, max_videos)
    recalls, hit1 = retrieval_recalls(q_feats, q_labels, g_feats, g_labels,
                                      RETRIEVAL_TOPK, return_per_query=True,
                                      device=dev)

    result_dir = os.path.join(config.result_path, config.dataset)
    os.makedirs(result_dir, exist_ok=True)
    report = os.path.join(
        result_dir,
        f"retrieval_{config.model_name}{config.model_depth}_{config.dataset}_"
        f"{config.split}_{config.sample_duration}.txt")
    with open(report, "w+") as f:
        f.write(str(config.to_json()) + "\n")
        f.write(f"gallery = {len(g_labels)} train videos, "
                f"queries = {len(q_labels)} test videos\n")
        for k, v in recalls.items():
            f.write(f"{k} = {v}\n")
        names = read_class_names(config.annotation_path)
        if names:
            for c in sorted(set(int(x) for x in q_labels)):
                mask = q_labels == c
                nm = names[c] if 0 <= c < len(names) else "?"
                f.write(f"R@1[{c} {nm}] = {hit1[mask].mean():.4f} "
                        f"(n={int(mask.sum())})\n")
    return {**recalls, "report": report,
            "n_gallery": len(g_labels), "n_queries": len(q_labels)}
