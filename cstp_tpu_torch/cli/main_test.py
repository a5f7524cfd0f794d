"""Video-level test entry point, flag-compatible with the JAX package's
``cstp_tpu.cli.main_test`` (the reference's ``test.py``):

    python -m cstp_tpu_torch.cli.main_test --task test --t_ft_task ft_all \
        --dataset UCF101 --pb_rate 4 ...

``main([...], device="cpu")`` runs it on the CPU.
"""

from cstp_tpu_torch.config import parse_opts
from cstp_tpu_torch.parallel import distributed_run
from cstp_tpu_torch.train.loops import run_test


def main(argv=None, device=None):
    with distributed_run(device):
        return _main(argv, device)


def _main(argv, device):
    config = parse_opts(argv)
    if config.task != "test":
        raise SystemExit(f"main_test handles task 'test', got {config.task!r}")
    out = run_test(config, device=device)
    print("Video accuracy = ", out["accuracy"])
    return out


if __name__ == "__main__":
    main()
