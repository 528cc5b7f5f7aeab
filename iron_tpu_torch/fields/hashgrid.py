"""Multiresolution hash-grid encoding and the hash-grid fields of
instant-NGP (counterpart of iron_tpu/fields/hashgrid.py): an SDF, a
rendering head and a NeRF, each a learned feature table per level read at
the 8 cell corners and blended trilinearly, before a small ReLU MLP.

Plain PyTorch, as the JAX package's is plain jnp (no Pallas kernel): the
corner reads of all levels are one gather from the flattened table, so the
backward is one scatter-add, and the trilinear weights and the gather are
differentiable to second order (the eikonal term of the hash SDF).

The spatial hash is instant-NGP's, in the JAX package's uint32 arithmetic:
(x * 1) ^ (y * 2654435761) ^ (z * 805459861), wrapped mod 2^32, then mod T.
PyTorch has no uint32 multiply on CUDA, so the products run in int64 (they
stay below 2^44) and are masked to 32 bits.  Levels whose (r + 1)^3 dense
grid fits the table are indexed densely with r, exactly as the JAX package
does; the level resolutions are floored from float64 numpy.

The MLP layers are plain {"w", "b"} (WeightNormLinear without the weight
norm), [d_in, d_out] as in the JAX tree; `*_from_numpy` / `*_to_numpy`
carry a JAX parameter tree across.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from iron_tpu_torch.core.embedder import pe_dim, positional_encoding
from iron_tpu_torch.fields.mlp import WeightNormLinear, linear_from_numpy, linear_to_numpy

# instant-NGP spatial hash primes
PRIMES = (1, 2654435761, 805459861)
# the 8 cell corners, bit i of the corner number the offset along axis i
_CORNERS = tuple(((c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8))


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.3819  # ~2048 finest at 16 levels
    bound: float = 1.0               # inputs in [-bound, bound]

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def level_resolutions(self) -> np.ndarray:
        return np.floor(self.base_resolution
                        * self.per_level_scale ** np.arange(self.n_levels)).astype(np.int64)


class HashGrid(nn.Module):
    """The feature tables of every level, [n_levels, 2^log2_hashmap_size, F]."""

    def __init__(self, table: torch.Tensor):
        super().__init__()
        self.table = nn.Parameter(table)


def init_hashgrid(cfg: HashGridConfig, generator: torch.Generator, device="cuda") -> HashGrid:
    """The table drawn from U(-1e-4, 1e-4)."""
    shape = (cfg.n_levels, 1 << cfg.log2_hashmap_size, cfg.n_features_per_level)
    u = torch.rand(shape, generator=generator, device=device)
    return HashGrid(u * 2e-4 - 1e-4)


def hashgrid_from_numpy(tree: Dict, device) -> HashGrid:
    return HashGrid(torch.tensor(np.asarray(tree["table"], np.float32), device=device))


def hashgrid_to_numpy(grid: HashGrid) -> Dict:
    return {"table": grid.table.detach().cpu().numpy()}


def hashgrid_corners(x: torch.Tensor, cfg: HashGridConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The table rows each point reads: (idx [..., n_levels, 8] int64, the
    row within its level; weights [..., n_levels, 8], the trilinear weight
    of each corner), corners in the JAX package's order."""
    T = 1 << cfg.log2_hashmap_size
    u = torch.clamp((x / cfg.bound + 1.0) * 0.5, 0.0, 1.0)
    off = torch.tensor(_CORNERS, dtype=torch.int64, device=x.device)          # [8, 3]
    on = off.to(torch.bool)
    idxs, weights = [], []
    for r in cfg.level_resolutions().tolist():
        pos = u * (r - 1)
        p0 = torch.floor(pos)
        w = (pos - p0)[..., None, :]                                          # [..., 1, 3]
        pc = torch.clamp(p0.to(torch.int64)[..., None, :] + off, 0, r - 1)    # [..., 8, 3]
        if (r + 1) ** 3 <= T:        # dense indexing of the coarse levels (NGP)
            idx = (pc[..., 0] * r + pc[..., 1]) * r + pc[..., 2]
        else:
            idx = ((pc[..., 0] * PRIMES[0]) ^ (pc[..., 1] * PRIMES[1])
                   ^ (pc[..., 2] * PRIMES[2])) & 0xFFFFFFFF
            idx = idx % T
        cw = torch.where(on, w, 1.0 - w)
        idxs.append(idx)
        weights.append(cw[..., 0] * cw[..., 1] * cw[..., 2])
    return torch.stack(idxs, dim=-2), torch.stack(weights, dim=-2)


def hashgrid_encode(grid: HashGrid, x: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """[..., 3] in [-bound, bound] -> [..., n_levels * F]."""
    T = 1 << cfg.log2_hashmap_size
    idx, w = hashgrid_corners(x, cfg)
    level = torch.arange(cfg.n_levels, device=x.device)[:, None] * T
    table = grid.table.reshape(-1, cfg.n_features_per_level)
    f = table[idx + level]                                                   # [..., L, 8, F]
    enc = torch.sum(w[..., None] * f, dim=-2)                                # [..., L, F]
    return enc.reshape(*x.shape[:-1], cfg.out_dim)


def _plain_mlp(dims: List[int], generator: torch.Generator, device) -> nn.ModuleList:
    """Weights U(-1/sqrt(d_in), 1/sqrt(d_in)), zero biases."""
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(a)
        w = (torch.rand((a, b), generator=generator, device=device) * 2 - 1) * bound
        layers.append(WeightNormLinear(w, torch.zeros((b,), device=device),
                                       weight_norm=False))
    return nn.ModuleList(layers)


def _run_mlp(layers: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
    for l, layer in enumerate(layers):
        h = layer(h)
        if l < len(layers) - 1:
            h = torch.relu(h)
    return h


def _layers_from_numpy(layers, device) -> nn.ModuleList:
    return nn.ModuleList([linear_from_numpy(p, device) for p in layers])


def _layers_to_numpy(layers: nn.ModuleList) -> list:
    return [linear_to_numpy(l) for l in layers]


# ---- the hash-grid SDF ----

@dataclass(frozen=True)
class HashSDFConfig:
    grid: HashGridConfig = field(default_factory=HashGridConfig)
    d_hidden: int = 64
    n_layers: int = 2
    d_feature: int = 15   # geometric feature dim (d_out = 1 + d_feature)
    sphere_init_radius: float = 0.5


class HashSDF(nn.Module):
    def __init__(self, grid: HashGrid, layers: nn.ModuleList):
        super().__init__()
        self.grid = grid
        self.layers = layers


def init_hash_sdf(cfg: HashSDFConfig, generator: torch.Generator, device="cuda") -> HashSDF:
    grid = init_hashgrid(cfg.grid, generator, device)
    dims = [cfg.grid.out_dim + 3] + [cfg.d_hidden] * cfg.n_layers + [1 + cfg.d_feature]
    return HashSDF(grid, _plain_mlp(dims, generator, device))


def hash_sdf_from_numpy(tree: Dict, device) -> HashSDF:
    return HashSDF(hashgrid_from_numpy(tree["grid"], device),
                   _layers_from_numpy(tree["layers"], device))


def hash_sdf_to_numpy(net: HashSDF) -> Dict:
    return {"grid": hashgrid_to_numpy(net.grid), "layers": _layers_to_numpy(net.layers)}


def hash_sdf_apply(net: HashSDF, x: torch.Tensor, cfg: HashSDFConfig) -> torch.Tensor:
    """[..., 3] -> [..., 1 + d_feature]; the sdf biased towards a sphere of
    sphere_init_radius (the bias plays the geometric init's role)."""
    h = torch.cat([x, hashgrid_encode(net.grid, x, cfg.grid)], dim=-1)
    h = _run_mlp(net.layers, h)
    sphere = torch.linalg.norm(x, dim=-1, keepdim=True) - cfg.sphere_init_radius
    return torch.cat([h[..., :1] + sphere, h[..., 1:]], dim=-1)


def hash_sdf_only(net: HashSDF, x: torch.Tensor, cfg: HashSDFConfig) -> torch.Tensor:
    return hash_sdf_apply(net, x, cfg)[..., 0]


def hash_sdf_value_feat_grad(net: HashSDF, x: torch.Tensor, cfg: HashSDFConfig
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sdf [...], feature [..., d_feature], grad [..., 3]) from one forward
    and one reverse sweep; under grad mode the gradient keeps its graph
    (create_graph), so the eikonal term differentiates through the
    trilinear weights and the table gathers a second time."""
    keep = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x if (keep and x.requires_grad) else x.detach().requires_grad_(True)
        out = hash_sdf_apply(net, xg, cfg)
        (grad,) = torch.autograd.grad(out[..., 0], xg,
                                      grad_outputs=torch.ones_like(out[..., 0]),
                                      create_graph=keep)
    if not keep:
        out = out.detach()
    return out[..., 0], out[..., 1:], grad


# ---- the hash-grid rendering head ----

@dataclass(frozen=True)
class HashRenderingConfig:
    grid: HashGridConfig = field(default_factory=HashGridConfig)
    d_feature: int = 15
    d_hidden: int = 64
    n_layers: int = 2
    d_out: int = 3
    multires_view: int = 4
    squeeze_out: bool = True


class HashRendering(nn.Module):
    def __init__(self, grid: HashGrid, layers: nn.ModuleList):
        super().__init__()
        self.grid = grid
        self.layers = layers


def init_hash_rendering(cfg: HashRenderingConfig, generator: torch.Generator,
                        device="cuda") -> HashRendering:
    grid = init_hashgrid(cfg.grid, generator, device)
    d_in = cfg.grid.out_dim + 3 + 3 + pe_dim(cfg.multires_view, 3) + cfg.d_feature
    dims = [d_in] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out]
    return HashRendering(grid, _plain_mlp(dims, generator, device))


def hash_rendering_from_numpy(tree: Dict, device) -> HashRendering:
    return HashRendering(hashgrid_from_numpy(tree["grid"], device),
                         _layers_from_numpy(tree["layers"], device))


def hash_rendering_to_numpy(net: HashRendering) -> Dict:
    return {"grid": hashgrid_to_numpy(net.grid), "layers": _layers_to_numpy(net.layers)}


def hash_rendering_apply(net: HashRendering, cfg: HashRenderingConfig, points, normals,
                         view_dirs, features) -> torch.Tensor:
    """The hash-encoded colour head: [points, hash(points), normals,
    PE(view_dirs), features] -> MLP (-> sigmoid)."""
    enc = hashgrid_encode(net.grid, points, cfg.grid)
    v = positional_encoding(view_dirs, cfg.multires_view)
    h = _run_mlp(net.layers, torch.cat([points, enc, normals, v, features], dim=-1))
    return torch.sigmoid(h) if cfg.squeeze_out else h


# ---- the hash-grid NeRF ----

@dataclass(frozen=True)
class HashNeRFConfig:
    grid: HashGridConfig = field(default_factory=HashGridConfig)
    d_hidden: int = 64
    n_layers: int = 2
    d_geo: int = 15
    multires_view: int = 4
    d_color_hidden: int = 64
    n_color_layers: int = 2


class HashNeRF(nn.Module):
    def __init__(self, grid: HashGrid, sigma_mlp: nn.ModuleList, color_mlp: nn.ModuleList):
        super().__init__()
        self.grid = grid
        self.sigma_mlp = sigma_mlp
        self.color_mlp = color_mlp


def init_hash_nerf(cfg: HashNeRFConfig, generator: torch.Generator,
                   device="cuda") -> HashNeRF:
    grid = init_hashgrid(cfg.grid, generator, device)
    sigma = _plain_mlp([cfg.grid.out_dim] + [cfg.d_hidden] * cfg.n_layers + [1 + cfg.d_geo],
                       generator, device)
    color = _plain_mlp([cfg.d_geo + pe_dim(cfg.multires_view, 3)]
                       + [cfg.d_color_hidden] * cfg.n_color_layers + [3], generator, device)
    return HashNeRF(grid, sigma, color)


def hash_nerf_from_numpy(tree: Dict, device) -> HashNeRF:
    return HashNeRF(hashgrid_from_numpy(tree["grid"], device),
                    _layers_from_numpy(tree["sigma_mlp"], device),
                    _layers_from_numpy(tree["color_mlp"], device))


def hash_nerf_to_numpy(net: HashNeRF) -> Dict:
    return {"grid": hashgrid_to_numpy(net.grid), "sigma_mlp": _layers_to_numpy(net.sigma_mlp),
            "color_mlp": _layers_to_numpy(net.color_mlp)}


def hash_nerf_apply(net: HashNeRF, cfg: HashNeRFConfig, pts: torch.Tensor,
                    views: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(density [..., 1], rgb [..., 3]) as the NeRF gives them; pts [..., 3]
    or [..., 4] (the background's (x/r, 1/r), of which the grid reads x/r)."""
    geo = _run_mlp(net.sigma_mlp, hashgrid_encode(net.grid, pts[..., :3], cfg.grid))
    sigma, feat = geo[..., :1], geo[..., 1:]
    v = positional_encoding(views, cfg.multires_view)
    rgb = torch.sigmoid(_run_mlp(net.color_mlp, torch.cat([feat, v], dim=-1)))
    return sigma, rgb
