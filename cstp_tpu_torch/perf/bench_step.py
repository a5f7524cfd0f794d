"""Step benchmark of the port: the counterpart of the JAX benchmark
``bench.py`` for its modes ``pretrain``, ``ft``, ``eval`` and ``serve``, at
its default shape.

    python -m cstp_tpu_torch.perf.bench_step [--mode pretrain|ft|eval|serve]
        [--per-chip-bs 64] [--steps 10] [--warmup 3] [--model r21d]
        [--depth 1] [--quant ''|int8_static|int8_store|int8_store_fz]
        [--fused-conv 0|1|2] [--pallas-augment auto|on|off]
        [--grad-accum 1] [--remat] [--remat-policy ''|bnrelu]
        [--concat-views 1|0] [--artifact PATH] [--device cuda|cpu]

Defaults are ``bench.py``'s: per-chip batch 64 (per view in ``pretrain``),
``--model`` r21d (the backbone family: r21d, c3d, r3d, s3d, i3d or
slowfast; an unknown one raises ``ValueError``) at ``--depth`` 1 (r3d and
slowfast build depth 18 there; 50 is SlowFast-R50), 16 frames of 112² (I3D
too: its reference recipe's 224² is not bench.py's shape; SlowFast's slow
pathway takes every 4th of them, ``--alpha`` 4),
uint8 source frames of 128×171, bf16, 10 timed steps after 3 warm-up steps,
``fused_conv`` 0 and ``pallas_augment`` "auto" (off), no remat,
``concat_views`` 1. ``--remat``,
``--remat-policy`` and ``--concat-views`` are bench.py's flags of the same
names and reach the pretrain model (the finetune model takes no remat, as
in the JAX package). The modes:

* ``pretrain``: ``train/pretrain.py make_pretrain_step`` (augment + BYOL
  towers + heads + SGD), ``task="loss_com"``;
* ``ft``: ``train/finetune.py make_finetune_step`` (finetune augment +
  ``CSTPClassify`` + SGD), ``task="ft_all"``, 101 classes;
* ``eval``: ``train/finetune.py make_eval_step`` (eval augment + eval-mode
  forward), ``task="test"``;
* ``serve``: the same model exported (``serve/export.py``: eval augment +
  eval-mode forward + weights in one ``torch.export`` program), loaded in
  process and called on the staged windows (``ServingModel.call``), as
  ``bench.py``'s serve mode times its artifact; ``--artifact PATH`` loads
  an artifact that ``serve/export.py`` wrote (its model, depth, ``--quant``
  and clip and frame shapes those of the flags, its classes its own)
  instead of exporting one.

``--quant int8_static`` (``eval`` and ``serve``) builds the model with
static int8 convs (K6) and fills every ``act_scale`` with 0.05, as
``bench.py``'s ``_fill_act_scales`` does: the bench has no calibrated
checkpoint, and the time does not depend on the scale's value.
``--quant int8_store`` and ``int8_store_fz`` (``pretrain``, R(2+1)D) run
the s8 storage chain (K6 with its storage epilogue, K7, K6), its scales
bootstrapped in the first warm-up step, as bench.py's ``--quant`` does.

Batches are drawn on the device from a seeded generator, three of them used
in turn. The step time is the host clock around the timed steps, which end
in ``torch.cuda.synchronize()``. One JSON line is printed (and returned by
``main``): step ms, clips/s (clip pairs/s for ``pretrain``), the peak of
``torch.cuda.max_memory_allocated`` over warm-up and timed steps, each
kernel's launches per timed step, the last loss, and the card's name and
power limit. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from cstp_tpu_torch import resolve_device
from cstp_tpu_torch.ops import launch_counts, reset_launch_counts
from cstp_tpu_torch.perf.bench_conv21d import device_line
from cstp_tpu_torch.ssl.byol import cross_entropy

T, S = 16, 112          # bench.py's clips
H0, W0 = 128, 171       # bench.py's synthetic source frames
N_BATCHES = 3
LR = 0.03               # bench.py's learning rate
FILL_SCALE = 0.05       # bench.py's _fill_act_scales value


def _config(args):
    from cstp_tpu_torch.config import Config

    task = {"pretrain": "loss_com", "ft": "ft_all"}.get(args.mode, "test")
    return Config(model_name=args.model, model_depth=args.depth,
                  sample_duration=T, sample_size=S,
                  batch_size=args.per_chip_bs, compute_dtype="bfloat16",
                  task=task, fused_conv=args.fused_conv,
                  pallas_augment=args.pallas_augment,
                  grad_accum=args.grad_accum, remat=args.remat,
                  remat_policy=args.remat_policy,
                  concat_views=args.concat_views, quant=args.quant
                  ).finalize()


def _batches(mode, b, t, n_classes, dev, seed: int = 0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def frames():
        return torch.randint(0, 256, (b, t, H0, W0, 3), generator=gen,
                             device=dev, dtype=torch.uint8)

    def labels(k):
        return torch.randint(0, k, (b,), generator=gen, device=dev)

    if mode == "pretrain":
        return [dict(frames1=frames(), frames2=frames(), rot1=labels(4),
                     rot2=labels(4), tem=labels(5), pb=labels(4))
                for _ in range(N_BATCHES)]
    return [dict(frames=frames(), labels=labels(n_classes))
            for _ in range(N_BATCHES)]


def fill_act_scales(model, value: float = FILL_SCALE) -> int:
    """Every ``act_scale`` buffer of ``model`` set to ``value``; returns
    how many there are."""
    n = 0
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("act_scale"):
                b.fill_(value)
                n += 1
    return n


def _serving_fn(model, cfg, dev, extra):
    """``model`` exported (``serve/export.py``) and loaded in process:
    ``fn(frames) -> logits``; the artifact's size and the export and load
    seconds go into ``extra``."""
    from cstp_tpu_torch.serve.export import (
        ServingModel,
        export_serving_artifact,
    )

    t0 = time.perf_counter()
    art = export_serving_artifact(
        model, num_classes=cfg.n_finetune_classes,
        sample_size=cfg.sample_size, sample_duration=cfg.sample_duration,
        input_hw=(H0, W0), norm_method=cfg.norm_method)
    t1 = time.perf_counter()
    served = ServingModel.load(art, device=dev)
    extra.update(artifact_mb=len(art) / 1e6, export_s=t1 - t0,
                 load_s=time.perf_counter() - t1)
    return served.call


def _written_artifact(path, cfg, dev, extra):
    """The artifact file ``path``, once its meta shows the benchmark's
    model and shapes, loaded in process: ``(fn(frames) -> logits, its
    classes)``; its size and load seconds go into ``extra``."""
    import zipfile

    from cstp_tpu_torch.models import base_model_name
    from cstp_tpu_torch.serve.export import _META_NAME, ServingModel

    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read(_META_NAME))
    want = dict(model_name=base_model_name(cfg.model_name),
                model_depth=cfg.model_depth, quant=cfg.quant,
                sample_size=S, sample_duration=T, input_hw=[H0, W0])
    got = dict({k: meta[k] for k in want},
               model_name=base_model_name(meta["model_name"]))
    if got != want:
        raise ValueError(f"{path}: artifact {got}, the benchmark {want}")
    t0 = time.perf_counter()
    served = ServingModel.load(path, device=dev)
    extra.update(artifact_mb=os.path.getsize(path) / 1e6, export_s=None,
                 load_s=time.perf_counter() - t0)
    return served.call, meta["num_classes"]


def _step_fn(mode, cfg, dev, extra, artifact=None):
    """``run(i) -> loss tensor`` for step ``i``, state kept inside."""
    gen = torch.Generator(device=dev).manual_seed(1)
    if mode == "pretrain":
        from cstp_tpu_torch.train.pretrain import (
            create_pretrain_state,
            make_pretrain_step,
        )

        model, state, tx = create_pretrain_state(cfg, seed=0, device=dev)
        step = make_pretrain_step(model, tx, cfg)
        n_classes = 0
    elif artifact:
        serve, n_classes = _written_artifact(artifact, cfg, dev, extra)
        state = None
    else:
        from cstp_tpu_torch.train import finetune as ft

        n_classes = cfg.n_finetune_classes
        model, state, tx = ft.create_finetune_state(cfg, n_classes, seed=0,
                                                    device=dev)
        if cfg.quant:
            extra["act_scales"] = fill_act_scales(model)
        if mode == "serve":
            serve = _serving_fn(model, cfg, dev, extra)
        step = (ft.make_finetune_step(model, tx, cfg) if mode == "ft"
                else ft.make_eval_step(model, cfg))
    batches = _batches(mode, cfg.batch_size, cfg.sample_duration, n_classes,
                       dev)
    box = [state]

    def run(i):
        batch = batches[i % N_BATCHES]
        if mode == "serve":
            return cross_entropy(serve(batch["frames"]), batch["labels"])
        if mode == "eval":
            return step(box[0], batch)["loss"]
        box[0], metrics = step(box[0], gen, batch, LR)
        return metrics["loss"]

    return run


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="pretrain",
                    choices=["pretrain", "ft", "eval", "serve"])
    ap.add_argument("--per-chip-bs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--model", default="r21d",
                    help="backbone family (r21d|c3d|r3d|s3d|i3d|slowfast)")
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--fused-conv", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--pallas-augment", default="auto",
                    choices=["auto", "on", "off"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", action="store_true",
                    help="remat residual stages (fits larger --per-chip-bs)")
    ap.add_argument("--remat-policy", default="", choices=["", "bnrelu"],
                    help="selective remat: recompute only BN/ReLU in bwd")
    ap.add_argument("--concat-views", type=int, default=1, choices=[0, 1])
    ap.add_argument("--quant", default="",
                    choices=["", "int8_static", "int8_store",
                             "int8_store_fz"],
                    help="eval and serve: int8_static, static int8 convs "
                    "(K6), every act_scale filled with 0.05; pretrain: "
                    "int8_store / int8_store_fz, the s8 storage chain")
    ap.add_argument("--artifact", default=None,
                    help="serve: time this serve/export.py artifact instead "
                    "of exporting the model")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.artifact and args.mode != "serve":
        ap.error("--artifact takes --mode serve")
    if args.quant == "int8_static" and args.mode not in ("eval", "serve"):
        ap.error("--quant int8_static takes --mode eval or serve")
    if args.quant.startswith("int8_store") and args.mode != "pretrain":
        ap.error(f"--quant {args.quant} takes --mode pretrain")
    dev = resolve_device(args.device)
    cfg = _config(args)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    extra = {}
    run = _step_fn(args.mode, cfg, dev, extra, args.artifact)
    for i in range(args.warmup):
        run(i)
    _sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = run(args.warmup + i)
    loss = float(loss)
    _sync(dev)
    dt = (time.perf_counter() - t0) / args.steps
    counts = {k: v / args.steps for k, v in launch_counts().items()}
    rate = "pairs_per_s" if args.mode == "pretrain" else "clips_per_s"
    out = {
        "mode": args.mode, "per_chip_bs": args.per_chip_bs,
        "grad_accum": args.grad_accum, "remat": args.remat,
        "remat_policy": args.remat_policy,
        "concat_views": args.concat_views, "model": args.model,
        "depth": args.depth, "quant": args.quant,
        "clip": [T, S, S], "frames": [H0, W0],
        "dtype": cfg.compute_dtype, "fused_conv": args.fused_conv,
        "pallas_augment": args.pallas_augment, "steps": args.steps,
        "warmup": args.warmup, "step_ms": dt * 1e3,
        rate: args.per_chip_bs / dt,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None),
        "launches_per_step": counts, "loss": loss,
        "device": device_line(dev), **extra,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
