"""Texture-atlas material baking (counterpart of iron_tpu/export/materials.py).

Behavioral spec from reference `models/export_materials.py:84-222`
(export_materials): sample 5x5M area-weighted surface points with UVs,
query the material predictor per point, splat each sample into the texture
atlas over a 5-tap neighborhood with Gaussian(sigma=1) weights, normalize
by accumulated weight, write diffuse/specular/roughness maps + .mtl.

The groupby accumulation is replaced by np.add.at scatter-adds.  The
sampling and the splat are host numpy, seeded as in the JAX package
(default_rng(0)), so both packages bake the same samples; the predictor
runs on `device`, 320,000 points a call, without a graph.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from iron_tpu_torch import resolve_device
from iron_tpu_torch.data.io import write_image
from iron_tpu_torch.export.mesh import read_obj


def sample_surface(verts, tris, uvs, tri_uvs, n_samples: int,
                   rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface samples with interpolated UVs
    (export_materials.py:13-56)."""
    rng = rng or np.random.default_rng(0)
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    p = area / np.clip(area.sum(), 1e-12, None)
    idx = rng.choice(len(tris), size=n_samples, p=p)
    r = rng.random((n_samples, 2)).astype(np.float32)
    s = np.sqrt(r[:, :1])
    w = (1 - s, s * (1 - r[:, 1:]), s * r[:, 1:])
    P = w[0] * a[idx] + w[1] * b[idx] + w[2] * c[idx]
    ua, ub, uc = uvs[tri_uvs[idx, 0]], uvs[tri_uvs[idx, 1]], uvs[tri_uvs[idx, 2]]
    P_uv = w[0] * ua + w[1] * ub + w[2] * uc
    return P.astype(np.float32), P_uv.astype(np.float32)


def splat_to_atlas(material_image, weight_image, uv, material, sigma: float = 1.0):
    """Gaussian 5-tap splat (export_materials.py:84-140) via scatter-add."""
    H, W = weight_image.shape
    uv = uv.copy()
    uv[:, 0] = uv[:, 0] * W
    uv[:, 1] = H - uv[:, 1] * H

    offsets = np.asarray([[0, 0], [0, -1], [1, 0], [0, 1], [-1, 0]], np.float32)
    for off in offsets:
        u = uv + off[None]
        col = np.floor(u[:, 0])
        row = np.floor(u[:, 1])
        label = (row * W + col).astype(np.int64)
        ok = (label >= 0) & (label < H * W)
        wgt = np.exp(-((u[:, 0] - col - 0.5) ** 2 + (u[:, 1] - row - 0.5) ** 2)
                     / (2 * sigma * sigma))
        lab = label[ok]
        np.add.at(material_image.reshape(H * W, -1), lab,
                  wgt[ok, None] * material[ok])
        np.add.at(weight_image.reshape(H * W), lab, wgt[ok])
    return material_image, weight_image


def export_materials(mesh_fpath: str, material_predictor: Callable, out_dir: str,
                     n_rounds: int = 5, samples_per_round: int = 5 * 10 ** 5,
                     chunk: int = 320_000, texture_H: int = 1024,
                     texture_W: int = 1024, mtl_name: str = "mesh",
                     device="cuda") -> Dict[str, np.ndarray]:
    """Bake material maps for a UV-unwrapped mesh (export_materials.py:165-222).

    material_predictor: points, a tensor [N,3] on `device` -> (diffuse
    [N,3], specular [N,3], roughness [N,1]).
    """
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    verts, tris, uvs, tri_uvs = read_obj(mesh_fpath)
    if len(uvs) == 0:
        raise ValueError(f"{mesh_fpath}: mesh must be UV-unwrapped first (export/uv.py)")

    material_image = np.zeros((texture_H, texture_W, 7), np.float32)
    weight_image = np.zeros((texture_H, texture_W), np.float32)
    rng = np.random.default_rng(0)

    for _ in range(n_rounds):
        pts, pts_uv = sample_surface(verts, tris, uvs, tri_uvs,
                                     samples_per_round, rng)
        mats = []
        with torch.no_grad():
            for i in range(0, len(pts), chunk):
                d, s, r = material_predictor(torch.as_tensor(pts[i:i + chunk], device=dev))
                mats.append(torch.cat([d, s, r], -1).to(torch.float32).cpu().numpy())
        mats = np.concatenate(mats)
        splat_to_atlas(material_image, weight_image, pts_uv, mats)

    w = np.clip(weight_image[..., None], 1e-8, None)
    atlas = material_image / w
    covered = weight_image > 1e-8

    maps = {
        "diffuse_albedo": atlas[..., 0:3],
        "specular_albedo": atlas[..., 3:6],
        "roughness": np.repeat(atlas[..., 6:7], 3, axis=-1),
    }
    for name, img in maps.items():
        write_image(os.path.join(out_dir, f"{name}.png"),
                    np.where(covered[..., None], img, 0.0))
    with open(os.path.join(out_dir, f"{mtl_name}.mtl"), "w") as f:
        f.write(f"newmtl {mtl_name}\nKd 1 1 1\nmap_Kd diffuse_albedo.png\n"
                f"map_Ks specular_albedo.png\nmap_Ns roughness.png\n")
    maps["coverage"] = covered
    return maps
