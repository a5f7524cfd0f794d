"""Serving export: the eval forward as a self-contained artifact.

The port of ``cstp_tpu/serve/export.py``. The whole inference computation,
the deterministic eval augment (scale the short side, centre crop,
normalise; ``augment/pipeline.py eval_augment_batch``) fused with the
eval-mode ``CSTPClassify`` forward, is traced with ``torch.export`` into one
program, with a dynamic batch dimension (``torch.export.Dim``) and the
trained weights carried inside it, and saved with ``torch.export.save``.

The artifact, one ``.cstps`` zip:

* ``meta.json``: the JAX package's keys (version, model, classes, input
  geometry, normalisation), with ``device`` (where the program was
  exported: ``cuda`` or ``cpu``) in place of ``platforms``, the ``quant``
  mode and what loading needs (``requires``);
* ``forward.pt2``: the exported program.

A float artifact needs only ``torch`` to run. An ``int8_static`` artifact
calls the custom op ``cstp::int8_conv3d``, which importing
``cstp_tpu_torch.ops.quant`` registers (K6 on the card, its plain version
on the CPU); ``ServingModel.load`` makes that import. No module is
pickled. The artifact is not byte-compatible with the JAX package's
StableHLO artifact.

``ServingModel`` is the runtime: ``load``, ``predict`` on a batch of
windows, ``predict_video`` with the reference ``test.py`` semantics
(sliding windows -> mean logits -> top-k). It runs on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import io
import json
import zipfile
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from cstp_tpu_torch import resolve_device
from cstp_tpu_torch.augment.pipeline import eval_augment_batch

ARTIFACT_VERSION = 1
_PROGRAM_NAME = "forward.pt2"
_META_NAME = "meta.json"
MAX_BATCH = 4096            # the exported batch dimension's upper bound
_INT8_REQUIRES = ("torch", "cstp_tpu_torch.ops.quant (registers the op "
                  "cstp::int8_conv3d)")


class _ServingForward(nn.Module):
    """``(b, T, H0, W0, 3)`` uint8 -> ``(b, C)`` float32 logits: the eval
    augment, then the eval-mode forward in the model's compute dtype."""

    def __init__(self, model: nn.Module, sample_size: int, norm_method: str):
        super().__init__()
        self.model = model
        self.sample_size = sample_size
        self.norm_method = norm_method

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = eval_augment_batch(frames, sample_size=self.sample_size,
                               norm_method=self.norm_method)
        logits = self.model(x.to(self.model.online_net.dtype), train=False)
        return logits.float()


def _export_forward(model: nn.Module, *, sample_size: int,
                    sample_duration: int, input_hw: Tuple[int, int],
                    norm_method: str):
    """``torch.export`` of the fused augment + forward, with a dynamic batch
    dimension, on the model's device."""
    dev = next(model.parameters()).device
    h0, w0 = input_hw
    example = torch.zeros((2, sample_duration, h0, w0, 3), dtype=torch.uint8,
                          device=dev)
    batch = torch.export.Dim("b", min=1, max=MAX_BATCH)
    with torch.no_grad():
        return torch.export.export(
            _ServingForward(model, sample_size, norm_method), (example,),
            dynamic_shapes=({0: batch},))


def export_serving_artifact(model: nn.Module, *, num_classes: int,
                            sample_size: int, sample_duration: int,
                            input_hw: Tuple[int, int] = (128, 171),
                            norm_method: str = "tf",
                            extra_meta: Optional[Dict] = None) -> bytes:
    """Serialize (eval augment + eval forward + weights) to artifact bytes.

    ``model`` is a built ``CSTPClassify`` with its trained weights (and,
    for ``--quant int8_static``, calibrated ``act_scale`` buffers), on the
    device the program is for. ``input_hw`` is the stored frame geometry
    the server will receive (the eval transform rescales from it, so it is
    fixed per artifact)."""
    program = _export_forward(model, sample_size=sample_size,
                              sample_duration=sample_duration,
                              input_hw=tuple(input_hw),
                              norm_method=norm_method)
    quant = model.quant
    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "model_name": model.backbone,
        "model_depth": model.depth,
        "num_classes": num_classes,
        "sample_size": sample_size,
        "sample_duration": sample_duration,
        "input_hw": list(input_hw),
        "norm_method": norm_method,
        "device": next(model.parameters()).device.type,
        "quant": quant,
        "requires": list(_INT8_REQUIRES if quant else ("torch",)),
    }
    if extra_meta:
        meta.update(extra_meta)
    prog = io.BytesIO()
    torch.export.save(program, prog)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(_META_NAME, json.dumps(meta, indent=2))
        z.writestr(_PROGRAM_NAME, prog.getvalue())
    return buf.getvalue()


def save_serving_artifact(path: str, artifact: bytes) -> None:
    with open(path, "wb") as f:
        f.write(artifact)


@dataclass
class ServingModel:
    """A loaded artifact: ``predict`` on window batches, no model code."""

    meta: Dict
    program: nn.Module        # the exported program's module
    device: torch.device

    @classmethod
    def load(cls, path_or_bytes, device=None) -> "ServingModel":
        """Load an artifact (a path or its bytes) onto ``device`` (CUDA
        unless ``device="cpu"``), moving the program there if it was
        exported on another device."""
        # registers cstp::int8_conv3d, which int8_static programs call
        import cstp_tpu_torch.ops.quant  # noqa: F401

        dev = resolve_device(device)
        if isinstance(path_or_bytes, (bytes, bytearray)):
            raw = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                raw = f.read()
        with zipfile.ZipFile(io.BytesIO(raw)) as z:
            meta = json.loads(z.read(_META_NAME))
            prog = z.read(_PROGRAM_NAME)
        if meta.get("artifact_version") != ARTIFACT_VERSION:
            raise ValueError(
                f"artifact version {meta.get('artifact_version')} "
                f"!= supported {ARTIFACT_VERSION}")
        program = torch.export.load(io.BytesIO(prog))
        if meta["device"] != dev.type:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, dev)
        return cls(meta=meta, program=program.module(), device=dev)

    def call(self, frames: torch.Tensor) -> torch.Tensor:
        """The program on a ``(N, T, H0, W0, 3)`` uint8 tensor on the
        model's device -> ``(N, C)`` float32 logits there (no host copy,
        no synchronisation)."""
        with torch.no_grad():
            return self.program(frames)

    def predict(self, frames: np.ndarray) -> np.ndarray:
        """(N, T, H0, W0, 3) uint8 windows -> (N, num_classes) f32 logits."""
        t = self.meta["sample_duration"]
        h0, w0 = self.meta["input_hw"]
        want = (t, h0, w0, 3)
        if frames.ndim != 5 or frames.shape[1:] != want:
            raise ValueError(
                f"expected (N, {t}, {h0}, {w0}, 3) uint8 windows, got "
                f"{frames.shape}")
        x = torch.from_numpy(np.ascontiguousarray(frames, np.uint8))
        return self.call(x.to(self.device)).cpu().numpy()

    def predict_video(self, frames: np.ndarray, *, pb_rate: int = 1,
                      topk: int = 5) -> Dict:
        """Reference ``test.py`` video-level semantics on one decoded video:
        non-overlapping sliding windows and a tail, the mean of the
        per-window logits, top-k."""
        from cstp_tpu_torch.train.finetune import sliding_window_indices

        t = self.meta["sample_duration"]
        idx = sliding_window_indices(frames.shape[0], t, pb_rate)
        windows = frames[idx]  # (N, T, H0, W0, 3)
        logits = self.predict(windows)
        mean_logits = logits.mean(axis=0)
        order = np.argsort(-mean_logits)[:topk]
        return {
            "mean_logits": mean_logits,
            "topk": order,
            "top1": int(order[0]),
            "n_windows": int(windows.shape[0]),
        }


def export_from_checkpoint(config, ckpt_path: str, num_classes: int,
                           input_hw: Tuple[int, int] = (128, 171),
                           device=None) -> bytes:
    """Build the classify model from ``config`` on ``device`` (CUDA unless
    ``device="cpu"``), restore a checkpoint by name (the path ``run_test``
    takes) and export it. An ``int8_static`` model whose checkpoint leaves
    a site uncalibrated is refused."""
    from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
    from cstp_tpu_torch.train.finetune import create_classify_model

    model = create_classify_model(config, num_classes,
                                  seed=config.manual_seed,
                                  device=resolve_device(device))
    tree, meta = ckpt_lib.restore_checkpoint(ckpt_path)
    ckpt_lib.load_model_by_name(model, tree)
    if config.quant == "int8_static":
        from cstp_tpu_torch.ops.quant import check_int8_calibrated

        check_int8_calibrated(model.state_dict(), "serve export")
    return export_serving_artifact(
        model, num_classes=num_classes, sample_size=config.sample_size,
        sample_duration=config.sample_duration, input_hw=input_hw,
        norm_method=config.norm_method,
        extra_meta={"arch": config.arch, "ckpt_epoch": meta.get("epoch")})


def main(argv=None, device=None) -> None:
    from cstp_tpu_torch.config import Config

    ap = argparse.ArgumentParser(
        description="Export a finetuned checkpoint as a serving artifact")
    ap.add_argument("--ckpt", required=True, help="finetune checkpoint path")
    ap.add_argument("--out", required=True, help="output .cstps path")
    ap.add_argument("--model_name", default="r21d")
    ap.add_argument("--model_depth", type=int, default=1)
    ap.add_argument("--num_classes", type=int, required=True)
    ap.add_argument("--sample_size", type=int, default=112)
    ap.add_argument("--sample_duration", type=int, default=16)
    ap.add_argument("--input_hw", type=int, nargs=2, default=(128, 171),
                    metavar=("H", "W"),
                    help="stored frame geometry the server receives")
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--quant", default="", choices=["", "int8_static"],
                    help="int8_static: a calibrated checkpoint "
                    "(serve/quantize.py)")
    args = ap.parse_args(argv)

    cfg = Config(model_name=args.model_name, model_depth=args.model_depth,
                 sample_size=args.sample_size,
                 sample_duration=args.sample_duration,
                 compute_dtype=args.compute_dtype, quant=args.quant,
                 task="test").finalize()
    artifact = export_from_checkpoint(
        cfg, args.ckpt, args.num_classes, input_hw=tuple(args.input_hw),
        device=device)
    save_serving_artifact(args.out, artifact)
    print(f"wrote {args.out} ({len(artifact)/1e6:.1f} MB, device "
          f"{resolve_device(device).type})")


if __name__ == "__main__":
    main()
