"""Occupancy-grid guided ray sampling for the volume renderer (counterpart of
iron_tpu/volume/occupancy.py).

A periodically refreshed R^3 grid marks the cells whose centre lies within
a margin of the SDF's zero set; the initial ray samples are drawn by
inverse CDF over per-ray occupancy weights, so the sample budget goes to the
occupied intervals instead of uniformly over [near, far].  Every ray keeps
`n_samples` samples; only their placement changes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from iron_tpu_torch.surface.tracer import linspace01
from iron_tpu_torch.volume.sampling import sample_pdf


@dataclass(frozen=True)
class OccupancyGridConfig:
    resolution: int = 64
    bound: float = 1.0          # the grid spans [-bound, bound]^3
    margin_cells: float = 1.5   # occupied if |sdf| < margin_cells * cell diagonal
    coarse_samples: int = 64    # per-ray occupancy probes for the CDF
    floor_weight: float = 0.01  # least weight, so that no interval is starved


@torch.no_grad()
def update_occupancy_grid(sdf_fn: Callable, cfg: OccupancyGridConfig, device,
                          chunk: int = 262144) -> torch.Tensor:
    """The SDF at every cell centre -> bool grid [R, R, R] on `device`."""
    R = cfg.resolution
    cell = 2.0 * cfg.bound / R
    c = (torch.arange(R, dtype=torch.float32, device=device) + 0.5) * cell - cfg.bound
    X, Y, Z = torch.meshgrid(c, c, c, indexing="ij")
    pts = torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], dim=-1)
    thresh = cfg.margin_cells * cell * math.sqrt(3.0)
    vals = [torch.abs(sdf_fn(pts[i:i + chunk])) < thresh for i in range(0, pts.shape[0], chunk)]
    return torch.cat(vals).reshape(R, R, R)


def occupancy_lookup(grid: torch.Tensor, pts: torch.Tensor,
                     cfg: OccupancyGridConfig) -> torch.Tensor:
    """Nearest-cell occupancy at points [..., 3] -> float [...]."""
    R = cfg.resolution
    idx = torch.floor((pts / cfg.bound + 1.0) * 0.5 * R).to(torch.int64)
    idx = torch.clamp(idx, 0, R - 1)
    inside = torch.all(torch.abs(pts) <= cfg.bound, dim=-1)
    occ = grid[idx[..., 0], idx[..., 1], idx[..., 2]]
    return torch.where(inside, occ.to(torch.float32), torch.zeros_like(pts[..., 0]))


def occupancy_guided_z(grid: torch.Tensor, cfg: OccupancyGridConfig,
                       rays_o: torch.Tensor, rays_d: torch.Tensor,
                       near: torch.Tensor, far: torch.Tensor, n_samples: int,
                       generator: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-ray z values [B, n_samples], sorted, concentrated in occupied
    cells: coarse occupancy probes along each ray (+ the floor, so that an
    empty ray falls back to uniform) form a CDF that the samples invert.
    Deterministic (midpoint u) when neither `generator` nor `u` [B,
    n_samples] is given."""
    B = rays_o.shape[0]
    near = near.reshape(B, 1)
    far = far.reshape(B, 1)
    z_coarse = near + (far - near) * linspace01(cfg.coarse_samples, rays_o.device)[None, :]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_coarse[..., None]
    occ = occupancy_lookup(grid, pts, cfg)                                  # [B, M]
    # weight of a segment: the larger of its end points' occupancies + floor
    w = torch.maximum(occ[:, :-1], occ[:, 1:]) + cfg.floor_weight           # [B, M - 1]
    det = generator is None and u is None
    z = sample_pdf(z_coarse, w, n_samples, det=det, generator=generator, u=u)
    return torch.sort(z, dim=-1).values
