"""PyTorch/CUDA port of CSTP (R(2+1)D): the pretrain step (loss_com), the
finetune, eval and video-level test steps, checkpoints and meters.

Public layouts follow the JAX package: NDHWC activations and
``(B, T, H0, W0, 3)`` uint8 frames. Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller asks for something else; a CUDA request on a
    machine without CUDA raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cstp_tpu_torch: CUDA was requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run on the CPU")
    return dev
