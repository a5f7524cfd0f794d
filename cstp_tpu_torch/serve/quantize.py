"""Post-training int8 calibration for the eval and serving paths.

The port of ``cstp_tpu/serve/quantize.py``. Static per-site activation
scales for ``--quant int8_static``:

  1. ``calibrate_checkpoint``: load a float checkpoint into the classify
     model in ``int8_calib`` mode. Every quantized conv site raises its
     ``act_scale`` buffer to ``absmax(x) / 127 + 1e-12`` of its input (the
     maximum over the calibration batches; the convs run in float, so the
     statistics carry no quantization noise). Save a new checkpoint that
     carries the scales.
  2. Test or serve with ``--quant int8_static``: each site quantizes with
     its calibrated scale, no reduction.

The scales are buffers of the model, so every surface that restores a
model by name (the eval step, the video-level test, retrieval, export)
takes them unchanged. A float checkpoint restored into an ``int8_static``
model leaves them at 0, and the test, retrieval and export paths refuse
such a run (``ops/quant.py check_int8_calibrated``), so step 1 cannot be
skipped silently.

CLI (the shared flags pick the model and the data; calibration draws its
batches from ``--data_type``'s split):

  python -m cstp_tpu_torch.serve.quantize --test_md_path CKPT \\
      --out_path CKPT_int8 --model_name r21d --model_depth 1 \\
      --data_backend packed --lmdb_path train.cstp ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

from cstp_tpu_torch import resolve_device
from cstp_tpu_torch.augment.pipeline import eval_augment_batch
from cstp_tpu_torch.ckpt import checkpoint as ckpt_lib
from cstp_tpu_torch.ops.quant import iter_scales
from cstp_tpu_torch.parallel import mesh
from cstp_tpu_torch.pretext.sampling import wraparound_frame_indices
from cstp_tpu_torch.train.finetune import create_classify_model
from cstp_tpu_torch.train.loops import build_dataset
from cstp_tpu_torch.train.pretrain import compute_dtype


def calibrate_checkpoint(config, md_path: str, out_path: str,
                         n_batches: int = 8, batch_size: int = 8,
                         data_type: str = "train",
                         max_videos: Optional[int] = None,
                         device=None) -> dict:
    """Observe every conv site's int8 activation scale on eval inputs (the
    centre window of ``batch_size`` videos drawn per batch from
    ``config.manual_seed``, eval augment) and write ``out_path``: the input
    checkpoint's model tensors with the calibrated ``act_scale`` buffers,
    and its meta with ``int8_calibration``. Under a process group every
    rank runs the batches (the scales are maxima over the ranks), rank 0
    writes ``out_path`` and the others wait for it. Runs on CUDA unless
    ``device`` says otherwise. Returns the written tree, the site count,
    the scale range and the clips seen."""
    dev = resolve_device(device)
    num_classes = config.n_finetune_classes or config.n_classes
    # task 'test': calibration is an eval-mode forward whatever task the
    # config carries (finalize() refuses int8_calib on training tasks)
    cfg = dataclasses.replace(config, quant="int8_calib",
                              task="test").finalize()
    model = create_classify_model(cfg, num_classes, device=dev)
    tree, meta = ckpt_lib.restore_checkpoint(md_path)
    ckpt_lib.load_model_by_name(model, tree)
    t = cfg.sample_duration
    ds = build_dataset(cfg, data_type)
    n = ds.num_videos() if max_videos is None else min(max_videos,
                                                       ds.num_videos())
    rng = np.random.default_rng(cfg.manual_seed)
    seen = 0
    with torch.no_grad():
        for _ in range(n_batches):
            idx = rng.integers(0, n, (batch_size,))
            frames = np.stack([
                ds.read_frames(int(i), _center_indices(ds, int(i), t))
                for i in idx])
            x = eval_augment_batch(torch.from_numpy(frames).to(dev),
                                   sample_size=cfg.sample_size,
                                   norm_method=cfg.norm_method)
            model(x.to(compute_dtype(cfg)), train=False)
            seen += batch_size
    sd = model.state_dict()
    scales = [float(v) for _, v in iter_scales(sd)]
    if not scales:
        raise ValueError(
            f"int8 calibration observed 0 conv sites for model "
            f"'{config.model_name}' — this backbone has no quantized conv "
            "path; int8_static serving is not supported for it.")
    out_tree = {"model": sd}
    meta = dict(meta)
    meta["int8_calibration"] = {"batches": n_batches,
                                "batch_size": batch_size,
                                "data_type": data_type}
    if mesh.is_main():
        ckpt_lib.save_checkpoint(out_path, out_tree, meta=meta)
    if mesh.is_distributed():
        torch.distributed.barrier()
    return {"tree": out_tree, "n_sites": len(scales),
            "scale_min": min(scales), "scale_max": max(scales),
            "clips_seen": seen}


def _center_indices(ds, i: int, t: int):
    """The ``t`` frames at the centre of video ``i`` (wrapping around a
    shorter video)."""
    nframes, _ = ds.video_meta(i)
    if nframes < t:
        return wraparound_frame_indices(nframes, t, 1)
    start = (nframes - t) // 2
    return list(range(start, start + t))


def main(argv=None, device=None) -> int:
    from cstp_tpu_torch.config import parse_opts
    mesh.maybe_initialize_distributed()
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out_path", required=True)
    ap.add_argument("--calib_batches", type=int, default=8)
    ap.add_argument("--calib_batch_size", type=int, default=8)
    ap.add_argument("--data_type", default="train")
    own, rest = ap.parse_known_args(argv)
    cfg = parse_opts(rest)
    md_path = cfg.test_md_path or cfg.pretrained_path
    if not md_path:
        print("error: pass the float checkpoint via --test_md_path "
              "(or --pretrained_path)", file=sys.stderr)
        return 2
    out = calibrate_checkpoint(cfg, md_path, own.out_path,
                               n_batches=own.calib_batches,
                               batch_size=own.calib_batch_size,
                               data_type=own.data_type, device=device)
    if not mesh.is_main():
        return 0
    print(f"calibrated {out['n_sites']} conv sites over "
          f"{out['clips_seen']} clips: act_scale in "
          f"[{out['scale_min']:.3e}, {out['scale_max']:.3e}] -> "
          f"{os.path.abspath(own.out_path)}")
    print("serve/test with: --quant int8_static --test_md_path "
          + own.out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
