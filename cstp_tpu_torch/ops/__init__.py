"""CUDA kernels of the port, each beside its plain PyTorch version."""


def launch_counts():
    """Launches of every kernel of the port since the last reset, by the
    kernel names of ``chip_smoke.py``'s record."""
    from cstp_tpu_torch.ops import augment as A
    from cstp_tpu_torch.ops import conv21d as C
    from cstp_tpu_torch.ops import quant as Q

    return {"conv21d_stats": C.launches["stats"],
            "conv21d_fwd": C.launches["fwd"],
            "conv21d_taps9_stats": C.launches["stats_taps9"],
            "conv21d_taps9_fwd": C.launches["fwd_taps9"],
            "augment": A.launches, "int8_conv": Q.launches,
            "int8_conv_store": Q.store_launches,
            "int8_bn_relu": Q.bnrelu_launches}


def reset_launch_counts():
    """Set every kernel's launch count to 0."""
    from cstp_tpu_torch.ops import augment as A
    from cstp_tpu_torch.ops import conv21d as C
    from cstp_tpu_torch.ops import quant as Q

    C.launches.update(dict.fromkeys(C.launches, 0))
    A.launches = 0
    Q.launches = Q.store_launches = Q.bnrelu_launches = 0
