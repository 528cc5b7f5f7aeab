"""Background NeRF MLP with its single- and dual-spectrum heads (counterpart
of iron_tpu/fields/nerf.py).

D x W trunk on PE(points) (ReLU, the input PE concatenated in front of h
after the ReLU of each layer in `skips`); alpha = Linear(W, 1)(h),
feature = Linear(W, W)(h), h = ReLU(Linear(W + pe_view, W // 2)(cat(feature,
PE(views)))), rgb = Linear(W // 2, 3)(h) [+ nir = Linear(W // 2, 1)(h) with
`dual`].  Plain weights in the [d_in, d_out] layout (no weight norm), as the
JAX package stores them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from iron_tpu_torch.core.embedder import pe_dim, positional_encoding
from iron_tpu_torch.fields.mlp import linear_from_numpy, linear_to_numpy, torch_default_linear


@dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    d_in: int = 4              # inverted-sphere background: (x/r, 1/r)
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    dual: bool = False         # the extra 1-channel NIR head

    @property
    def input_ch(self) -> int:
        return pe_dim(self.multires, self.d_in)

    @property
    def input_ch_view(self) -> int:
        return pe_dim(self.multires_view, self.d_in_view)


_HEADS = ("feature_linear", "alpha_linear", "views_linear", "rgb_linear")


class NeRFNetwork(nn.Module):
    def __init__(self, cfg: NeRFConfig, pts_linears, heads: dict):
        super().__init__()
        self.cfg = cfg
        self.pts_linears = nn.ModuleList(pts_linears)
        self.heads = nn.ModuleDict(heads)

    def forward(self, pts, views):
        return nerf_apply(self, self.cfg, pts, views)


def init_nerf(cfg: NeRFConfig = NeRFConfig(), generator: torch.Generator = None,
              device="cuda") -> NeRFNetwork:
    """torch.nn.Linear's default init of every layer, drawn from `generator`."""
    lin = lambda a, b: torch_default_linear(a, b, generator, device, weight_norm=False)
    pts = []
    for i in range(cfg.D):
        if i == 0:
            d_in = cfg.input_ch
        elif (i - 1) in cfg.skips:
            d_in = cfg.W + cfg.input_ch
        else:
            d_in = cfg.W
        pts.append(lin(d_in, cfg.W))
    heads = {"feature_linear": lin(cfg.W, cfg.W), "alpha_linear": lin(cfg.W, 1),
             "views_linear": lin(cfg.input_ch_view + cfg.W, cfg.W // 2),
             "rgb_linear": lin(cfg.W // 2, 3)}
    if cfg.dual:
        heads["nir_linear"] = lin(cfg.W // 2, 1)
    return NeRFNetwork(cfg, pts, heads)


def nerf_from_numpy(tree: dict, cfg: NeRFConfig, device) -> NeRFNetwork:
    """The network of a JAX parameter tree {"pts_linears": [{"w", "b"}, ...],
    "feature_linear", "alpha_linear", "views_linear", "rgb_linear"[,
    "nir_linear"]} (arrays copied)."""
    names = _HEADS + (("nir_linear",) if cfg.dual else ())
    return NeRFNetwork(cfg, [linear_from_numpy(p, device) for p in tree["pts_linears"]],
                       {k: linear_from_numpy(tree[k], device) for k in names})


def nerf_to_numpy(net: NeRFNetwork) -> dict:
    out = {"pts_linears": [linear_to_numpy(l) for l in net.pts_linears]}
    out.update({k: linear_to_numpy(l) for k, l in net.heads.items()})
    return out


def nerf_apply(net: NeRFNetwork, cfg: NeRFConfig, pts: torch.Tensor, views: torch.Tensor):
    """[..., d_in], [..., 3] -> (density [..., 1], rgb [..., 3][, nir [..., 1]])."""
    input_pts = positional_encoding(pts, cfg.multires)
    input_views = positional_encoding(views, cfg.multires_view)
    h = input_pts
    for i, layer in enumerate(net.pts_linears):
        h = torch.relu(layer(h))
        if i in cfg.skips:
            h = torch.cat([input_pts, h], dim=-1)
    heads = net.heads
    alpha = heads["alpha_linear"](h)
    feature = heads["feature_linear"](h)
    h = torch.relu(heads["views_linear"](torch.cat([feature, input_views], dim=-1)))
    rgb = heads["rgb_linear"](h)
    if cfg.dual:
        return alpha, rgb, heads["nir_linear"](h)
    return alpha, rgb
