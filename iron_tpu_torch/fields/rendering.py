"""IDR-style rendering / material MLP (counterpart of iron_tpu/fields/rendering.py).

input = concat of (points, view_dirs, normals, feature) chosen by `mode`;
optional PE on points / view dirs; ReLU hidden layers; output =
output_scale * (x + output_bias), then sigmoid * squeeze_out_scale.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from iron_tpu_torch.core.embedder import pe_dim, positional_encoding
from iron_tpu_torch.fields.mlp import (linear_from_numpy, linear_to_numpy,
                                       torch_default_linear)


@dataclass(frozen=True)
class RenderingConfig:
    d_feature: int = 256
    mode: str = "idr"  # idr | no_view_dir | no_normal | points_only
    d_in: int = 9
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 4
    weight_norm: bool = True
    multires: int = 0
    multires_view: int = 0
    squeeze_out: bool = True
    squeeze_out_scale: float = 1.0
    output_bias: float = 0.0
    output_scale: float = 1.0
    skip_in: Tuple[int, ...] = ()
    # 'bfloat16' runs the products and activations in bf16 (weights cast
    # after the f32 weight norm, output cast back to f32); None = f32
    compute_dtype: Optional[str] = None

    @property
    def d_input(self) -> int:
        d = self.d_in + self.d_feature
        if self.multires > 0:
            d += pe_dim(self.multires, 3) - 3
        if self.multires_view > 0:
            d += pe_dim(self.multires_view, 3) - 3
        return d

    @property
    def dims(self) -> Tuple[int, ...]:
        dims = [self.d_input] + [self.d_hidden] * self.n_layers + [self.d_out]
        for l in self.skip_in:
            if not 0 < l < len(dims):
                raise ValueError(f"skip_in index {l} out of range for "
                                 f"n_layers={self.n_layers}")
            dims[l] += dims[0]
        return tuple(dims)


class RenderingNetwork(nn.Module):
    def __init__(self, cfg: RenderingConfig, layers):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(layers)

    def forward(self, points, normals, view_dirs, features):
        return rendering_apply(self, self.cfg, points, normals, view_dirs, features)


def init_rendering(cfg: RenderingConfig, generator: torch.Generator,
                   device="cuda") -> RenderingNetwork:
    dims = cfg.dims
    layers = []
    for l in range(len(dims) - 1):
        out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
        layers.append(torch_default_linear(dims[l], out_dim, generator, device,
                                           cfg.weight_norm))
    return RenderingNetwork(cfg, layers)


def rendering_from_numpy(tree: dict, cfg: RenderingConfig, device) -> RenderingNetwork:
    return RenderingNetwork(cfg, [linear_from_numpy(p, device) for p in tree["layers"]])


def rendering_to_numpy(net: RenderingNetwork) -> dict:
    return {"layers": [linear_to_numpy(l) for l in net.layers]}


def rendering_apply(net: RenderingNetwork, cfg: RenderingConfig, points: torch.Tensor,
                    normals: Optional[torch.Tensor],
                    view_dirs: Optional[torch.Tensor],
                    features: torch.Tensor) -> torch.Tensor:
    """Query the material head; shapes [..., d].  `cfg` is the network's
    own config or a variant of it (e.g. with compute_dtype set)."""
    if cfg.multires > 0:
        points = positional_encoding(points, cfg.multires)
    if cfg.multires_view > 0 and cfg.mode not in ("no_view_dir", "points_only"):
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)

    if cfg.mode == "idr":
        inp = torch.cat([points, view_dirs, normals, features], dim=-1)
    elif cfg.mode == "no_view_dir":
        inp = torch.cat([points, normals, features], dim=-1)
    elif cfg.mode == "no_normal":
        inp = torch.cat([points, view_dirs, features], dim=-1)
    elif cfg.mode == "points_only":
        inp = torch.cat([points, features], dim=-1)
    else:
        raise ValueError(f"unknown mode {cfg.mode}")

    dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    if dt is not None:
        inp = inp.to(dt)
    h = inp
    n = len(net.layers)
    for l, layer in enumerate(net.layers):
        if l in cfg.skip_in:
            h = torch.cat([h, inp], dim=-1) / math.sqrt(2)
        if dt is None:
            h = layer(h)
        else:
            h = h @ layer.effective_weight().to(dt) + layer.b.to(dt)
        if l < n - 1:
            h = torch.relu(h)
    h = h.to(torch.float32)
    h = cfg.output_scale * (h + cfg.output_bias)
    if cfg.squeeze_out:
        h = cfg.squeeze_out_scale * torch.sigmoid(h)
    return h
