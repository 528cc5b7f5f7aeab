"""Linear layers with explicit weight-norm reparameterisation (counterpart of
iron_tpu/fields/mlp.py).

The layout is the JAX package's: v is stored [d_in, d_out] and the norm runs
per output column, so the effective weight W = v * g / ||v||_col feeds a
plain x @ W.  Weights carried across from a JAX checkpoint load unchanged.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


class WeightNormLinear(nn.Module):
    """x @ W + b with W = v * (g / ||v||) per column (or a plain weight w
    when weight_norm is off)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, weight_norm: bool = True):
        super().__init__()
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(w)
            self.g = nn.Parameter(torch.linalg.norm(w, dim=0))
        else:
            self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    @property
    def d_in(self) -> int:
        return (self.v if self.weight_norm else self.w).shape[0]

    @property
    def d_out(self) -> int:
        return (self.v if self.weight_norm else self.w).shape[1]

    def effective_weight(self) -> torch.Tensor:
        if self.weight_norm:
            vnorm = torch.linalg.norm(self.v, dim=0, keepdim=True)
            return self.v * (self.g[None, :] / (vnorm + 1e-12))
        return self.w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.effective_weight() + self.b


def torch_default_linear(d_in: int, d_out: int, generator: torch.Generator,
                         device, weight_norm: bool = True) -> WeightNormLinear:
    """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias, in the [d_in, d_out] layout."""
    bound = 1.0 / math.sqrt(d_in)
    w = (torch.rand((d_in, d_out), generator=generator, device=device) * 2 - 1) * bound
    b = (torch.rand((d_out,), generator=generator, device=device) * 2 - 1) * bound
    return WeightNormLinear(w, b, weight_norm)


def normal_weight(d_in: int, d_out: int, mean: float, std: float,
                  generator: torch.Generator, device) -> torch.Tensor:
    return mean + std * torch.randn((d_in, d_out), generator=generator, device=device)


def linear_from_numpy(p: dict, device) -> WeightNormLinear:
    """A layer from the JAX parameter dict {"v","g","b"} or {"w","b"}
    (arrays are copied)."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    if "v" in p:
        layer = WeightNormLinear(t(p["v"]), t(p["b"]))
        with torch.no_grad():
            layer.g.copy_(t(p["g"]))
        return layer
    return WeightNormLinear(t(p["w"]), t(p["b"]), weight_norm=False)


def linear_to_numpy(layer: WeightNormLinear) -> dict:
    names = ("v", "g", "b") if layer.weight_norm else ("w", "b")
    return {k: getattr(layer, k).detach().cpu().numpy() for k in names}
