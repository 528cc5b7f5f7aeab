"""Pinhole camera and pure ray/projection functions (counterpart of
iron_tpu/core/camera.py).

K and W2C are 4x4; rays go through pixel centres (uv + 0.5); ray_d is unit
length and ray_d_norm (the pre-normalisation length) converts camera-z depth
to ray distance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from iron_tpu_torch import resolve_device


@dataclass(frozen=True)
class Camera:
    K: torch.Tensor
    W2C: torch.Tensor
    K_inv: torch.Tensor
    C2W: torch.Tensor
    H: int
    W: int

    @property
    def device(self) -> torch.device:
        return self.K.device


def make_camera(K, W2C, H: int, W: int, device="cuda") -> Camera:
    device = resolve_device(device)
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    W2C = torch.as_tensor(np.asarray(W2C, np.float32), device=device)
    return Camera(K=K, W2C=W2C, K_inv=torch.linalg.inv(K),
                  C2W=torch.linalg.inv(W2C), H=int(H), W=int(W))


def camera_origin(cam: Camera) -> torch.Tensor:
    return cam.C2W[:3, 3]


def pixel_grid(H: int, W: int, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """[H, W, 2] pixel-centre uv coordinates."""
    u = torch.arange(W, dtype=dtype, device=device)
    v = torch.arange(H, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1) + 0.5


def get_rays(cam: Camera, uv: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uv [..., 2] -> (ray_o, ray_d, ray_d_norm)."""
    uv_h = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    d_cam = uv_h @ cam.K_inv[:3, :3].T
    d_world = d_cam @ cam.C2W[:3, :3].T
    ray_d_norm = torch.linalg.norm(d_world, dim=-1)
    ray_d = d_world / ray_d_norm[..., None]
    ray_o = torch.broadcast_to(cam.C2W[:3, 3], ray_d.shape)
    return ray_o, ray_d, ray_d_norm


def project(cam: Camera, points: torch.Tensor) -> torch.Tensor:
    """World points [..., 3] -> pixel uv [..., 2]."""
    p_h = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    uvw = (p_h @ cam.W2C.T) @ cam.K.T
    return uvw[..., :2] / uvw[..., 2:3]


def crop_camera(cam: Camera, ul_col, ul_row, trgt_W: int, trgt_H: int) -> Camera:
    """Shift the principal point for a (ul_col, ul_row, trgt_W, trgt_H) crop."""
    K = cam.K.clone()
    K[0, 2] = K[0, 2] - float(ul_col)
    K[1, 2] = K[1, 2] - float(ul_row)
    return Camera(K=K, W2C=cam.W2C, K_inv=torch.linalg.inv(K), C2W=cam.C2W,
                  H=int(trgt_H), W=int(trgt_W))


def resize_camera(cam: Camera, factor: float) -> Camera:
    """Scale the intrinsics for a resized render."""
    trgt_H, trgt_W = int(cam.H * factor), int(cam.W * factor)
    K = cam.K.clone()
    K[0, :3] = K[0, :3] * (trgt_W / cam.W)
    K[1, :3] = K[1, :3] * (trgt_H / cam.H)
    return Camera(K=K, W2C=cam.W2C, K_inv=torch.linalg.inv(K), C2W=cam.C2W,
                  H=trgt_H, W=trgt_W)
