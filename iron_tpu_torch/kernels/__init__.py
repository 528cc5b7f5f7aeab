"""Hand-written CUDA kernels for Hopper (sm_90a) that replace the JAX
package's Pallas TPU kernels, each beside its plain PyTorch version:

  K1     `fused_sdf.coarse_march`                   the coarse sphere-trace march (bf16,
                                                   compacted in one cooperative launch)
  K2     `fused_sdf.sdf_only_bf16`                  the coarse SDF evaluator (bf16, wgmma)
  K3-fwd `fused_sdf_grad.sdf_value_feat_grad_fwd`   value, feature and grad (3xTF32)
  K3-bwd `fused_sdf_grad.sdf_value_feat_grad_bwd`   their adjoint: dW, db and dx (3xTF32)
  K4     `fused_sdf.sdf_only_3pass`                 the accurate trace evaluator (bf16x3)
  K5     `fused_sdf_grad.sdf_full`                  [sdf, features] of every point (3xTF32)

Sources live in `csrc/`; `build.py` compiles them with nvcc at the first
CUDA call.  Importing this package needs neither nvcc nor a card.
"""
from iron_tpu_torch.kernels.fused_sdf import coarse_march, sdf_only_3pass, sdf_only_bf16
from iron_tpu_torch.kernels.fused_sdf_grad import (make_sdf_fn,  # noqa: F401 (exported)
                                                   sdf_full, sdf_value_feat_grad_bwd,
                                                   sdf_value_feat_grad_fwd)

KERNELS = {"coarse_march": coarse_march, "sdf_only_bf16": sdf_only_bf16,
           "sdf_value_feat_grad": sdf_value_feat_grad_fwd,
           "sdf_value_feat_grad_bwd": sdf_value_feat_grad_bwd,
           "sdf_only_3pass": sdf_only_3pass, "sdf_full": sdf_full}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
