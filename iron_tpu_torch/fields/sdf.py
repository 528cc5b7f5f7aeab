"""SDF field: 8x256 MLP with a skip connection, positional encoding,
geometric initialisation and weight norm (counterpart of iron_tpu/fields/sdf.py).

dims = [pe_dim] + [d_hidden]*n_layers + [d_out]; the layer before the skip
outputs d_hidden - pe_dim and the skip layer consumes concat(h, pe)/sqrt(2);
softplus(beta=100) activations; the input is scaled by `scale` and the sdf
output divided by it.  Everything here is float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from iron_tpu_torch.core.embedder import pe_dim, positional_encoding
from iron_tpu_torch.fields.mlp import (WeightNormLinear, linear_from_numpy,
                                       linear_to_numpy, normal_weight)


@dataclass(frozen=True)
class SDFConfig:
    d_in: int = 3
    d_out: int = 257            # 1 sdf + 256 feature
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: Tuple[int, ...] = (4,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    inside_outside: bool = False
    precision: str = "highest"  # kept for config parity; the port is f32

    @property
    def d_embed(self) -> int:
        return pe_dim(self.multires, self.d_in)

    @property
    def dims(self) -> Tuple[int, ...]:
        return (self.d_embed,) + (self.d_hidden,) * self.n_layers + (self.d_out,)


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus(100 x)/100 in the JAX package's form, max(z,0) + log1p(exp(-|z|))."""
    z = 100.0 * x
    return (torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z)))) / 100.0


class SDFNetwork(nn.Module):
    def __init__(self, cfg: SDFConfig, layers):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sdf_apply(self, x)


def init_sdf(cfg: SDFConfig = SDFConfig(), generator: torch.Generator = None,
             device="cuda") -> SDFNetwork:
    """Geometric init (sphere-like SDF of radius `bias`); the JAX package's
    recipe, drawn from a torch.Generator."""
    dims = list(cfg.dims)
    n = len(dims)
    layers = []
    for l in range(n - 1):
        out_dim = dims[l + 1] - dims[0] if (l + 1) in cfg.skip_in else dims[l + 1]
        d_in = dims[l]
        if cfg.geometric_init:
            if l == n - 2:
                sign = -1.0 if cfg.inside_outside else 1.0
                w = normal_weight(d_in, out_dim, sign * math.sqrt(math.pi) / math.sqrt(d_in),
                                  1e-4, generator, device)
                b = torch.full((out_dim,), -sign * cfg.bias, device=device)
            else:
                w = normal_weight(d_in, out_dim, 0.0, math.sqrt(2) / math.sqrt(out_dim),
                                  generator, device)
                if cfg.multires > 0 and l == 0:
                    w[cfg.d_in:, :] = 0.0
                elif cfg.multires > 0 and l in cfg.skip_in:
                    w[-(dims[0] - cfg.d_in):, :] = 0.0
                b = torch.zeros((out_dim,), device=device)
        else:
            bound = 1.0 / math.sqrt(d_in)
            w = (torch.rand((d_in, out_dim), generator=generator, device=device) * 2 - 1) * bound
            b = (torch.rand((out_dim,), generator=generator, device=device) * 2 - 1) * bound
        layers.append(WeightNormLinear(w, b, cfg.weight_norm))
    return SDFNetwork(cfg, layers)


def sdf_from_numpy(tree: dict, cfg: SDFConfig, device) -> SDFNetwork:
    return SDFNetwork(cfg, [linear_from_numpy(p, device) for p in tree["layers"]])


def sdf_to_numpy(net: SDFNetwork) -> dict:
    return {"layers": [linear_to_numpy(l) for l in net.layers]}


def sdf_apply(net: SDFNetwork, x: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., d_out] = [sdf, features]."""
    cfg = net.cfg
    inputs = positional_encoding(x * cfg.scale, cfg.multires)
    h = inputs
    n = len(net.layers)
    for l, layer in enumerate(net.layers):
        if l in cfg.skip_in:
            h = torch.cat([h, inputs], dim=-1) / math.sqrt(2)
        h = layer(h)
        if l < n - 1:
            h = softplus100(h)
    return torch.cat([h[..., :1] / cfg.scale, h[..., 1:]], dim=-1)


def sdf_only(net: SDFNetwork, x: torch.Tensor) -> torch.Tensor:
    return sdf_apply(net, x)[..., 0]


def sdf_value_feat_grad(net: SDFNetwork, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sdf [...], feature [..., d_out-1], grad [..., 3]) from one forward and
    one reverse sweep.  The graph is kept (differentiable) when grad mode is
    on, as the JAX vjp is."""
    keep = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x if (keep and x.requires_grad) else x.detach().requires_grad_(True)
        out = sdf_apply(net, xg)
        (grad,) = torch.autograd.grad(out[..., 0], xg,
                                      grad_outputs=torch.ones_like(out[..., 0]),
                                      create_graph=keep)
    if not keep:
        out = out.detach()
    return out[..., 0], out[..., 1:], grad
