"""Pretrain entry point, flag-compatible with the JAX package's
``cstp_tpu.cli.main_byol`` (the reference's ``main_byol.py``):

    python -m cstp_tpu_torch.cli.main_byol --dataset UCF101 --task loss_com \
        --model_name r21d --model_depth 1 --batch_size 60 \
        --learning_rate 0.03 --weight_decay 5e-4 --n_epochs 300 \
        --frame_dir ... --annotation_path ... --result_path ...

One process on one CUDA device; ``main([...], device="cpu")`` runs it on
the CPU.
"""

from cstp_tpu_torch.config import parse_opts
from cstp_tpu_torch.train.loops import run_pretrain


def main(argv=None, device=None):
    config = parse_opts(argv)
    if config.task not in ("loss_com", "r_byol", "resume"):
        raise SystemExit(f"main_byol handles pretrain tasks, got {config.task!r}")
    return run_pretrain(config, device=device)


if __name__ == "__main__":
    main()
