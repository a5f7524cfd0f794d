"""Finetune entry point, flag-compatible with the JAX package's
``cstp_tpu.cli.main_ft`` (the reference's ``main_ft_mp.py``):

    python -m cstp_tpu_torch.cli.main_ft --task ft_all --pretrained_path <ckpt> \
        --dataset UCF101 --n_finetune_classes 101 --batch_size 60 \
        --learning_rate 0.02 --pb_rate 4 --n_epochs 100 ...

``main([...], device="cpu")`` runs it on the CPU.
"""

from cstp_tpu_torch.config import parse_opts
from cstp_tpu_torch.parallel import distributed_run
from cstp_tpu_torch.train.loops import run_finetune


def main(argv=None, device=None):
    with distributed_run(device):
        return _main(argv, device)


def _main(argv, device):
    config = parse_opts(argv)
    if config.task not in ("ft_fc", "ft_all", "scratch", "resume"):
        raise SystemExit(f"main_ft handles finetune tasks, got {config.task!r}")
    out = run_finetune(config, device=device)
    print("Best val acc:", out["best"]["acc"], "at epoch", out["best"]["epoch"])
    return out


if __name__ == "__main__":
    main()
