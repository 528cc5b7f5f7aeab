"""Image morphology on the surface-render path (counterpart of
iron_tpu/surface/morphology.py):
  * 3x3 grayscale closing of the depth for hole filling (dilation pads with
    -inf, erosion with +inf: max_pool2d on x and on -x);
  * the normalised Sobel gradient magnitude for edge seeding (kernels
    divided by 8, zero padding).
The Sobel is written as shifted sums, not a convolution: cuDNN would run an
f32 convolution in TF32, whose error is above the 1e-2 edge threshold's
resolution.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def closing3x3(img: torch.Tensor) -> torch.Tensor:
    """Grayscale morphological closing with a 3x3 ones kernel; img [H, W]."""
    x = img[None, None]
    dil = F.max_pool2d(x, 3, stride=1, padding=1)
    ero = -F.max_pool2d(-dil, 3, stride=1, padding=1)
    return ero[0, 0]


def sobel_magnitude(img: torch.Tensor) -> torch.Tensor:
    """Normalised Sobel gradient magnitude; img [H, W]."""
    H, W = img.shape
    p = F.pad(img, (1, 1, 1, 1))
    s = lambda dy, dx: p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    gx = ((s(-1, 1) - s(-1, -1)) + 2.0 * (s(0, 1) - s(0, -1)) + (s(1, 1) - s(1, -1))) / 8.0
    gy = ((s(1, -1) - s(-1, -1)) + 2.0 * (s(1, 0) - s(-1, 0)) + (s(1, 1) - s(-1, 1))) / 8.0
    return torch.sqrt(gx * gx + gy * gy + 1e-12)
