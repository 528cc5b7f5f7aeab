"""Image losses and regularisers (counterpart of iron_tpu/losses)."""
from iron_tpu_torch.losses.image import psnr, pyramid_l2_loss, ssim_loss
from iron_tpu_torch.losses.regularizers import (dielectric_eta_loss, eikonal_loss,
                                                mask_bce_loss, metal_eta_k_loss,
                                                roughness_range_loss)

__all__ = ["psnr", "pyramid_l2_loss", "ssim_loss", "dielectric_eta_loss", "eikonal_loss",
           "mask_bce_loss", "metal_eta_k_loss", "roughness_range_loss"]
