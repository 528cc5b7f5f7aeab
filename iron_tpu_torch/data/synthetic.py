"""Synthetic co-located-flash datasets (counterpart of
iron_tpu/data/synthetic.py): analytic SDF scenes, ring and hemisphere camera
rigs, and a GGX roughplastic shade function, rendered through the port's own
`render_camera`.  The ground truth of the end-to-end tests and the bench,
without JAX; `write_scene_dir` writes one as a scene folder on disk.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from iron_tpu_torch.core.camera import make_camera
from iron_tpu_torch.data.io import write_image
from iron_tpu_torch.shading.brdf import ggx_colocated
from iron_tpu_torch.surface.render import SurfaceRenderConfig, render_camera


def look_at_w2c(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenCV-convention world->camera: +z forward, +x right, +y down."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.asarray([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    W2C = np.eye(4)
    W2C[:3, :3] = R
    W2C[:3, 3] = -R @ eye
    return W2C.astype(np.float32)


def _intrinsics(focal: float, H: int, W: int) -> np.ndarray:
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = focal
    K[0, 2], K[1, 2] = W / 2, H / 2
    return K


def ring_cameras(n: int, radius: float = 3.0, H: int = 128, W: int = 128,
                 focal: float = 160.0, elevation: float = 0.35,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(Ks, W2Cs) of n cameras on a jittered ring looking at the origin."""
    g = np.random.default_rng(seed)
    Ks, W2Cs = [], []
    for i in range(n):
        theta = 2 * np.pi * i / n + g.uniform(-0.1, 0.1)
        z = elevation + g.uniform(-0.1, 0.1)
        eye = np.array([radius * np.cos(theta), radius * np.sin(theta), z * radius])
        Ks.append(_intrinsics(focal, H, W))
        W2Cs.append(look_at_w2c(eye, np.zeros(3)))
    return np.stack(Ks), np.stack(W2Cs)


def hemisphere_cameras(n: int, radius: float = 3.0, H: int = 128, W: int = 128,
                       focal: float = 160.0, z_range=(-0.1, 0.92), pole: str = "z",
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(Ks, W2Cs) of n cameras on a Fibonacci spiral over the (mostly upper)
    view sphere, its pole along `pole`."""
    g = np.random.default_rng(seed)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    perm = {"z": (0, 1, 2), "y": (0, 2, 1), "x": (2, 1, 0)}[pole]
    Ks, W2Cs = [], []
    z_lo, z_hi = z_range
    for i in range(n):
        z = z_lo + (z_hi - z_lo) * (i + 0.5) / n + g.uniform(-0.02, 0.02)
        z = float(np.clip(z, -0.99, 0.99))
        rho = np.sqrt(max(1.0 - z * z, 1e-6))
        theta = golden * i + g.uniform(-0.05, 0.05)
        eye = radius * np.array([rho * np.cos(theta), rho * np.sin(theta), z])[list(perm)]
        up_pole = np.array([0.0, 0.0, 1.0]) if abs(z) < 0.97 else np.array([0.0, 1.0, 0.0])
        Ks.append(_intrinsics(focal, H, W))
        W2Cs.append(look_at_w2c(eye, np.zeros(3), up=tuple(up_pole[list(perm)])))
    return np.stack(Ks), np.stack(W2Cs)


# ---- analytic scenes: (sdf_fn, sdf_all_fn) ----

def _with_autograd_grad(sdf_fn):
    def sdf_all_fn(p):
        with torch.enable_grad():
            pg = p.detach().requires_grad_(True)
            v = sdf_fn(pg)
            (g,) = torch.autograd.grad(v.sum(), pg)
        return v.detach(), p.new_zeros(p.shape[:-1] + (16,)), g
    return sdf_fn, sdf_all_fn


def sphere_scene(radius: float = 0.5):
    def sdf_fn(p):
        return torch.linalg.norm(p, dim=-1) - radius

    def sdf_all_fn(p):
        n = torch.linalg.norm(p, dim=-1)
        return n - radius, p.new_zeros(p.shape[:-1] + (16,)), p / (n[..., None] + 1e-9)

    return sdf_fn, sdf_all_fn


def blobby_scene(radius: float = 0.45, amp: float = 0.08):
    """A sphere with low-frequency angular bumps."""
    def sdf_fn(p):
        h = amp * (torch.sin(4.0 * p[..., 0]) * torch.sin(4.0 * p[..., 1])
                   + 0.5 * torch.sin(6.0 * p[..., 2]))
        return torch.linalg.norm(p, dim=-1) - radius - h
    return _with_autograd_grad(sdf_fn)


def torus_scene(R: float = 0.42, r: float = 0.18):
    """A torus in the xz-plane."""
    def sdf_fn(p):
        q = torch.stack([torch.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2) - R, p[..., 1]], dim=-1)
        return torch.linalg.norm(q, dim=-1) - r
    return _with_autograd_grad(sdf_fn)


def genus2_scene(R: float = 0.26, r: float = 0.13, sep: float = 0.26, k: float = 0.06):
    """Two tori in the xy-plane welded by a polynomial smooth-min."""
    def torus_xy(p, cx):
        q0 = torch.sqrt((p[..., 0] - cx) ** 2 + p[..., 1] ** 2) - R
        return torch.sqrt(q0 ** 2 + p[..., 2] ** 2) - r

    def sdf_fn(p):
        a, b = torus_xy(p, -sep), torus_xy(p, sep)
        h = torch.clamp(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
        return b + (a - b) * h - k * h * (1.0 - h)
    return _with_autograd_grad(sdf_fn)


def make_ggx_shade_fn(light: float, diffuse_albedo=(0.6, 0.3, 0.2),
                      specular_albedo=0.3, roughness=0.2):
    def shade_fn(ray_o, ray_d, points, normals, features):
        n = normals / (torch.linalg.norm(normals, dim=-1, keepdim=True) + 1e-10)
        sh = points.shape[:-1]
        da = torch.as_tensor(diffuse_albedo, dtype=points.dtype, device=points.device)
        params = {"diffuse_albedo": torch.broadcast_to(da, sh + (3,)),
                  "specular_albedo": points.new_full(sh + (3,), specular_albedo),
                  "specular_roughness": points.new_full(sh + (1,), roughness)}
        dist = torch.linalg.norm(points - ray_o, dim=-1, keepdim=True)
        res = ggx_colocated(light, dist, n, -ray_d, params)
        return {"color": res["rgb"], "normal": n, "diffuse_color": res["diffuse_rgb"],
                "specular_color": res["specular_rgb"]}
    return shade_fn


def render_synthetic_dataset(scene: str = "sphere", n_views: int = 12, H: int = 128,
                             W: int = 128, light: float = 30.0, rig: str = "ring",
                             rig_kwargs: Dict = None, device="cuda",
                             **scene_kwargs) -> Dict:
    """A co-located-flash multiview dataset of an analytic scene: images
    [N, H, W, 3], coverage masks [N, H, W, 1] (pixel-centre hits), Ks,
    W2Cs, as numpy arrays, and the scene's SDF functions."""
    makers = {"sphere": sphere_scene, "blobby": blobby_scene, "torus": torus_scene,
              "genus2": genus2_scene}
    sdf_fn, sdf_all_fn = makers[scene](**scene_kwargs)
    shade_fn = make_ggx_shade_fn(light)
    rig_fn = {"ring": ring_cameras, "hemisphere": hemisphere_cameras}[rig]
    Ks, W2Cs = rig_fn(n_views, H=H, W=W, **(rig_kwargs or {}))
    cfg = SurfaceRenderConfig(edge_budget=1024)
    imgs, masks = [], []
    with torch.no_grad():
        for K, W2C in zip(Ks, W2Cs):
            res = render_camera(sdf_fn, sdf_all_fn, shade_fn,
                                make_camera(K, W2C, H, W, device=device), cfg)
            imgs.append(res["color"].cpu().numpy())
            masks.append(res["hit_mask"].cpu().numpy()[..., None])
    return {"images": np.stack(imgs), "masks": np.stack(masks).astype(np.float32),
            "Ks": Ks, "W2Cs": W2Cs, "light": light, "sdf_fn": sdf_fn, "sdf_all_fn": sdf_all_fn}


def write_scene_dir(data: Dict, path: str, folder_name: str = "image",
                    denormalize: Optional[Tuple[np.ndarray, float]] = None) -> str:
    """Write a dataset as a scene folder: `<path>/<folder_name>/NNNNN.png`,
    `<path>/masks/NNNNN.png` and `cam_dict_norm.json`.  With
    `denormalize=(translate, scale)` an un-normalised `cam_dict.json` is
    written too, its poses under the inverse of `cameras.transform_pose`."""
    img_dir = os.path.join(path, folder_name)
    mask_dir = os.path.join(path, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    H, W = data["images"].shape[1:3]
    cam_dict = {}
    for i in range(data["images"].shape[0]):
        name = f"{i:05d}.png"
        write_image(os.path.join(img_dir, name), data["images"][i])
        write_image(os.path.join(mask_dir, name), np.repeat(data["masks"][i], 3, axis=-1))
        cam_dict[name] = {"K": [float(x) for x in np.asarray(data["Ks"][i]).flatten()],
                          "W2C": [float(x) for x in np.asarray(data["W2Cs"][i]).flatten()],
                          "img_size": [W, H]}
    with open(os.path.join(path, "cam_dict_norm.json"), "w") as f:
        json.dump(cam_dict, f, indent=2, sort_keys=True)
    if denormalize is not None:
        translate, scale = denormalize
        raw = {}
        for name, entry in cam_dict.items():
            C2W = np.linalg.inv(np.asarray(entry["W2C"], np.float64).reshape(4, 4))
            C2W[:3, 3] = C2W[:3, 3] / scale - np.asarray(translate)
            raw[name] = {**entry, "W2C": [float(x) for x in np.linalg.inv(C2W).flatten()]}
        with open(os.path.join(path, "cam_dict.json"), "w") as f:
            json.dump(raw, f, indent=2, sort_keys=True)
    return path
