"""PyTorch + CUDA port of iron_tpu (the JAX package beside it is the reference).

Entry points run on the CUDA device unless the caller passes device="cpu";
asking for CUDA without a card raises.  On CUDA the precision policy of the
JAX package holds: float32 everywhere, never TF32, bf16 operands with f32
accumulation only inside the two coarse-trace kernels, the 3-pass trace
kernel (split bf16 operands, f32-class results) and, with
`Stage2Config.mat_bf16`, the material networks.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    no card is visible (there is no silent CPU path)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but no CUDA device is "
                               "visible; pass device='cpu' to run on the CPU")
        # f32 matmuls and convolutions stay full f32 (the 5e-5 root threshold
        # and the 1e-2 Sobel threshold are below TF32's error)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
