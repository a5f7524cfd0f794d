"""Nearest-neighbour video retrieval entry point (task ``retrieval``),
flag-compatible with the JAX package's ``cstp_tpu.cli.main_retrieval``:
test clips query the train gallery by cosine similarity of backbone
features, from a pretrain checkpoint or a finetune checkpoint:

    python -m cstp_tpu_torch.cli.main_retrieval --task retrieval \
        --dataset UCF101 --model_name r21d --model_depth 1 \
        --pretrained_path results/UCF101/loss_com/save_300 \
        --frame_dir <jpegs> --annotation_path <lists> --result_path results

``main([...], device="cpu")`` runs it on the CPU.
"""

from cstp_tpu_torch.config import parse_opts
from cstp_tpu_torch.parallel import distributed_run
from cstp_tpu_torch.train.loops import run_retrieval


def main(argv=None, device=None):
    with distributed_run(device):
        return _main(argv, device)


def _main(argv, device):
    config = parse_opts(argv)
    if config.task != "retrieval":
        raise SystemExit(
            f"main_retrieval handles task 'retrieval', got {config.task!r}")
    out = run_retrieval(config, device=device)
    for k in ("R@1", "R@5", "R@10", "R@20", "R@50"):
        print(f"{k} = {out[k]}")
    print("report:", out["report"])
    return out


if __name__ == "__main__":
    main()
