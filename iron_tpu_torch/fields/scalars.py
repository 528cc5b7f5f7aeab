"""Point-light intensity (counterpart of iron_tpu/fields/scalars.py)."""
from __future__ import annotations

import torch
from torch import nn


class PointLight(nn.Module):
    """One learnable scalar intensity."""

    def __init__(self, init_val: float = 5.0, device="cuda"):
        super().__init__()
        self.light = nn.Parameter(torch.tensor(float(init_val), device=device))

    def forward(self) -> torch.Tensor:
        return self.light


def init_point_light(init_val: float = 5.0, device="cuda") -> PointLight:
    return PointLight(init_val, device)


def point_light_apply(net: PointLight) -> torch.Tensor:
    return net()
