"""Ray / sphere geometry (counterpart of iron_tpu/core/rays.py)."""
from __future__ import annotations

from typing import Tuple

import torch


def intersect_sphere(ray_o: torch.Tensor, ray_d: torch.Tensor, r: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mask_intersect, near = clamp(d1 - d2, 0), far = d1 + d2), shapes [...]."""
    d1 = -torch.sum(ray_d * ray_o, dim=-1) / torch.sum(ray_d * ray_d, dim=-1)
    p = ray_o + d1[..., None] * ray_d
    tmp = r * r - torch.sum(p * p, dim=-1)
    mask_intersect = tmp > 0.0
    d2 = torch.sqrt(torch.clamp(tmp, min=0.0)) / torch.linalg.norm(ray_d, dim=-1)
    return mask_intersect, torch.clamp(d1 - d2, min=0.0), d1 + d2
