"""Scalar learnable networks: the NeuS inverse deviation and the point-light
intensity (counterpart of iron_tpu/fields/scalars.py)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class Variance(nn.Module):
    """One learnable scalar v; inv_s = exp(10 v)."""

    def __init__(self, init_val: float = 0.3, device="cuda"):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(float(init_val), device=device))

    def forward(self) -> torch.Tensor:
        return variance_apply(self)


def init_variance(init_val: float = 0.3, device="cuda") -> Variance:
    return Variance(init_val, device)


def variance_apply(net: Variance) -> torch.Tensor:
    """Scalar inv_s (callers broadcast as needed)."""
    return torch.exp(net.variance * 10.0)


def variance_from_numpy(tree: dict, device) -> Variance:
    return Variance(float(np.asarray(tree["variance"])), device)


def variance_to_numpy(net: Variance) -> dict:
    return {"variance": np.asarray(net.variance.detach().cpu().numpy(), np.float32)}


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
