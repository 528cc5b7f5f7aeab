"""Image-space losses: Gaussian-pyramid L2 and masked SSIM (counterpart of
iron_tpu/losses/image.py).

  * pyramid L2: 5 levels; each level is a 7x7 Gaussian (sigma 1) depthwise
    convolution (padding 3) then a 2x average pool; the loss sums
    sum(diff^2) / (H_l * W_l) over levels, with H_l = H / 2^l;
  * SSIM: 11x11 Gaussian (sigma 1.5) windows, valid-convolution SSIM map,
    mean over channels; with a mask, the map is padded with 1.0 back to the
    input size and averaged over the mask eroded by the window; 1 - mean.

Inputs are [B, C, H, W] as in the JAX package.  The convolutions are f32
depthwise `conv2d` (TF32 stays off: resolve_device disables it for cuDNN).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gauss7x7() -> np.ndarray:
    x = np.arange(-3, 4)
    g = np.exp(-x ** 2 / 2.0)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _gauss1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _depthwise_conv2d(x: torch.Tensor, kern2d: np.ndarray, padding: int) -> torch.Tensor:
    """x [B, C, H, W], kern2d [kh, kw] applied per channel."""
    C = x.shape[1]
    k = torch.as_tensor(kern2d, dtype=x.dtype, device=x.device)[None, None].repeat(C, 1, 1, 1)
    return F.conv2d(x, k, padding=padding, groups=C)


def pyramid_l2_loss(pred_img: torch.Tensor, trgt_img: torch.Tensor) -> torch.Tensor:
    """pred / trgt [B, C, H, W] -> scalar."""
    h, w = pred_img.shape[-2:]
    g = _gauss7x7()
    diff = pred_img - trgt_img
    loss = torch.sum(diff ** 2) / (h * w)
    for lvl in range(1, 5):
        diff = F.avg_pool2d(_depthwise_conv2d(diff, g, 3), 2)
        loss = loss + torch.sum(diff ** 2) / ((h / 2.0 ** lvl) * (w / 2.0 ** lvl))
    return loss


def _erode(mask: torch.Tensor, win: int) -> torch.Tensor:
    """Binary erosion by a win x win window; mask [B, 1, H, W] float, the
    border counting as inside."""
    return -F.max_pool2d(-mask, win, stride=1, padding=win // 2)


def ssim_loss(X: torch.Tensor, Y: torch.Tensor, mask: Optional[torch.Tensor] = None,
              data_range: float = 1.0, win_size: int = 11, win_sigma: float = 1.5,
              K=(0.01, 0.03)) -> torch.Tensor:
    """1 - (masked) mean SSIM, inputs [B, C, H, W]."""
    C1 = (K[0] * data_range) ** 2
    C2 = (K[1] * data_range) ** 2
    g1 = _gauss1d(win_size, win_sigma)
    kern = np.outer(g1, g1)
    f = lambda img: _depthwise_conv2d(img, kern, 0)
    mu1, mu2 = f(X), f(Y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = f(X * X) - mu1_sq
    sigma2_sq = f(Y * Y) - mu2_sq
    sigma12 = f(X * Y) - mu1_mu2
    cs = (2 * sigma12 + C2) / (sigma1_sq + sigma2_sq + C2)
    ssim_map = ((2 * mu1_mu2 + C1) / (mu1_sq + mu2_sq + C1)) * cs
    ssim_map = ssim_map.mean(dim=1, keepdim=True)
    if mask is None:
        return 1.0 - ssim_map.mean()
    pad = win_size // 2
    ssim_full = F.pad(ssim_map, (pad, pad, pad, pad), value=1.0)
    m = (_erode(mask.to(torch.float32), win_size) > 0.5).to(ssim_full.dtype)
    mean = torch.sum(ssim_full * m) / torch.clamp(torch.sum(m), min=1.0)
    return 1.0 - mean


def psnr(pred: torch.Tensor, target: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PSNR with an optional mask [...] over the last (channel) axis."""
    if mask is None:
        mse = torch.mean((pred - target) ** 2)
    else:
        m = mask.to(pred.dtype)
        mse = torch.sum(((pred - target) ** 2) * m) / (torch.sum(m) * pred.shape[-1] + 1e-5)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-12))
