"""Relighting validation of exported assets (counterpart of
iron_tpu/eval/relight.py).

Replaces the reference's Mitsuba-docker relighting scripts
(`test_mitsuba/render_rgb_envmap_mat.py` / `render_rgb_flash_mat.py`:
re-render the exported mesh + baked textures under novel lighting to
validate the export).  Here the exported .obj + texture atlas is ray-traced
with the native BVH (iron_tpu_torch/native) and shaded with the same
analytic GGX BRDF, under a point light at an arbitrary position.  The rays
come from the port's camera on the camera's device; the BRDF terms (the
port's shading/fresnel.py) run there in f32, the rest is host numpy.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from iron_tpu_torch.core.camera import Camera, get_rays, pixel_grid
from iron_tpu_torch.data.io import read_image
from iron_tpu_torch.export.mesh import read_obj
from iron_tpu_torch.native import ray_mesh_intersect
from iron_tpu_torch.shading.fresnel import fresnel_dielectric, ggx_ndf, smith_g1


def _sample_atlas(atlas: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Nearest-texel lookup with the baking convention (v flipped,
    export_materials.py:96-98)."""
    H, W = atlas.shape[:2]
    col = np.clip((uv[:, 0] * W).astype(np.int64), 0, W - 1)
    row = np.clip((H - uv[:, 1] * H).astype(np.int64), 0, H - 1)
    return atlas[row, col]


def load_assets(mesh_path: str, material_dir: str) -> Dict[str, np.ndarray]:
    """An exported mesh and its three atlases, read once for the renders of
    several views (`assets=`)."""
    verts, tris, uvs, tri_uvs = read_obj(mesh_path)
    return {"verts": verts, "tris": tris, "uvs": uvs, "tri_uvs": tri_uvs,
            "diffuse": read_image(os.path.join(material_dir, "diffuse_albedo.png")),
            "specular": read_image(os.path.join(material_dir, "specular_albedo.png")),
            "rough": read_image(os.path.join(material_dir, "roughness.png"))}


def _trace_and_materials(mesh_path: str, material_dir: str, cam: Camera,
                         assets: Optional[Dict] = None):
    """Shared first-hit pass: primary intersection, viewer-oriented
    geometric normals, and texture-atlas material lookups (of `assets`, or
    of the files when None)."""
    a = assets if assets is not None else load_assets(mesh_path, material_dir)
    verts, tris, uvs, tri_uvs = a["verts"], a["tris"], a["uvs"], a["tri_uvs"]
    diffuse_map, specular_map, rough_map = a["diffuse"], a["specular"], a["rough"]

    uv_grid = pixel_grid(cam.H, cam.W, device=cam.device)
    ray_o, ray_d, _ = get_rays(cam, uv_grid)
    ro = ray_o.cpu().numpy().reshape(-1, 3)
    rd = ray_d.cpu().numpy().reshape(-1, 3)

    t, tri_idx, bary = ray_mesh_intersect(ro, rd, verts, tris)
    hit = t > 0
    t_safe = np.where(hit, t, 1.0)
    pts = ro + rd * t_safe[:, None]

    tri_safe = np.clip(tri_idx, 0, len(tris) - 1)
    # geometric normals
    a = verts[tris[tri_safe, 0]]
    b = verts[tris[tri_safe, 1]]
    c = verts[tris[tri_safe, 2]]
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    # orient towards the viewer
    n = np.where(np.sum(n * rd, axis=-1, keepdims=True) > 0, -n, n)

    # interpolated UVs
    if len(uvs) > 0:
        ua = uvs[tri_uvs[tri_safe, 0]]
        ub = uvs[tri_uvs[tri_safe, 1]]
        uc = uvs[tri_uvs[tri_safe, 2]]
        w0 = (1 - bary[:, 0] - bary[:, 1])[:, None]
        uv_hit = w0 * ua + bary[:, 0:1] * ub + bary[:, 1:2] * uc
        diffuse = _sample_atlas(diffuse_map, uv_hit)
        specular = _sample_atlas(specular_map, uv_hit)
        rough = _sample_atlas(rough_map, uv_hit)[:, :1]
    else:
        diffuse = np.full_like(pts, 0.5)
        specular = np.full_like(pts, 0.2)
        rough = np.full((len(pts), 1), 0.3, np.float32)

    return {"verts": verts, "tris": tris, "ro": ro, "rd": rd, "t": t,
            "hit": hit, "pts": pts, "normal": n,
            "diffuse": diffuse, "specular": specular, "rough": rough}


def _ggx_roughplastic_np(wi, wo, n, diffuse, specular, rough, device):
    """General (non-colocated) GGX roughplastic BRDF x cos_i: numpy, the
    microfacet terms in f32 on `device`."""
    cos_i = np.clip(np.sum(n * wi, axis=-1, keepdims=True), 1e-5, 1 - 1e-5)
    cos_o = np.clip(np.sum(n * wo, axis=-1, keepdims=True), 1e-5, 1 - 1e-5)
    h = wi + wo
    h /= np.linalg.norm(h, axis=-1, keepdims=True) + 1e-12
    cos_h = np.clip(np.sum(n * h, axis=-1, keepdims=True), 1e-5, 1 - 1e-5)

    alpha = np.clip(rough, 1e-4, None)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    host = lambda x: x.cpu().numpy()
    D = host(ggx_ndf(t(cos_h), t(alpha)))
    G = host(smith_g1(t(cos_i), t(alpha)) * smith_g1(t(cos_o), t(alpha)))
    F = host(fresnel_dielectric(t(
        np.clip(np.sum(h * wi, axis=-1, keepdims=True), 1e-5, 1 - 1e-5)), 1.48958738))
    spec = specular * F * D * G / (4.0 * cos_o + 1e-10)
    diff = diffuse / np.pi * cos_i
    return diff, spec


def render_mesh_flash(mesh_path: str, material_dir: str, cam: Camera,
                      light: float, light_pos: Optional[np.ndarray] = None,
                      assets: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """Render the exported mesh under a point light (co-located with the
    camera when light_pos is None; novel position = true relighting).
    `assets` (load_assets) stands in for the files."""
    tr = _trace_and_materials(mesh_path, material_dir, cam, assets)
    pts, n, hit = tr["pts"], tr["normal"], tr["hit"]

    lp = np.asarray(cam.C2W[:3, 3].cpu().numpy() if light_pos is None else light_pos,
                    np.float32)
    wi = lp[None] - pts
    dist = np.linalg.norm(wi, axis=-1, keepdims=True)
    wi = wi / (dist + 1e-12)
    wo = -tr["rd"]

    diff, spec = _ggx_roughplastic_np(wi, wo, n, tr["diffuse"], tr["specular"],
                                      tr["rough"], cam.device)
    li = light / (dist * dist + 1e-10)
    color = np.where(hit[:, None], li * (diff + spec), 0.0)

    H, W = cam.H, cam.W
    return {
        "color": color.reshape(H, W, 3).astype(np.float32),
        "depth": np.where(hit, tr["t"], 0.0).reshape(H, W),
        "mask": hit.reshape(H, W),
        "normal": np.where(hit[:, None], n, 0.0).reshape(H, W, 3),
    }


# ---------------------------------------------------------------------------
# environment-map relighting (test_mitsuba/render_rgb_envmap_mat.py analogue)
# ---------------------------------------------------------------------------

def make_uniform_envmap(radiance=(1.0, 1.0, 1.0), H: int = 16,
                        W: int = 32) -> np.ndarray:
    return np.broadcast_to(np.asarray(radiance, np.float32),
                           (H, W, 3)).copy()


def make_gradient_envmap(top=(1.0, 1.0, 1.2), bottom=(0.1, 0.1, 0.08),
                         H: int = 16, W: int = 32) -> np.ndarray:
    """Simple sky-to-ground gradient (z-up): a smooth directional envmap."""
    t = np.linspace(0.0, 1.0, H, dtype=np.float32)[:, None, None]
    return ((1 - t) * np.asarray(top, np.float32)
            + t * np.asarray(bottom, np.float32)) * np.ones((H, W, 3), np.float32)


def envmap_lookup(envmap: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Equirectangular lookup, z-up: row <- theta = arccos(d_z),
    col <- phi = atan2(d_y, d_x)."""
    He, We = envmap.shape[:2]
    theta = np.arccos(np.clip(dirs[..., 2], -1.0, 1.0))
    phi = np.arctan2(dirs[..., 1], dirs[..., 0])
    row = np.clip((theta / np.pi * He).astype(np.int64), 0, He - 1)
    col = np.clip(((phi + np.pi) / (2 * np.pi) * We).astype(np.int64), 0, We - 1)
    return envmap[row, col]


def sphere_dirs_weights(n_theta: int = 16, n_phi: int = 32):
    """Fixed latitude-longitude quadrature over the full sphere:
    directions [M, 3] and solid-angle weights [M] (sum = 4 pi)."""
    th = (np.arange(n_theta) + 0.5) / n_theta * np.pi
    ph = (np.arange(n_phi) + 0.5) / n_phi * 2 * np.pi - np.pi
    T, P = np.meshgrid(th, ph, indexing="ij")
    dirs = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                     np.cos(T)], axis=-1).reshape(-1, 3)
    w = (np.sin(T) * (np.pi / n_theta) * (2 * np.pi / n_phi)).reshape(-1)
    return dirs.astype(np.float32), w.astype(np.float32)


def render_mesh_envmap(mesh_path: str, material_dir: str, cam: Camera,
                       envmap: np.ndarray, n_theta: int = 16,
                       n_phi: int = 32, shadow_eps: float = 2e-3,
                       with_shadows: bool = True,
                       assets: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """Render the exported mesh under an environment map
    (`test_mitsuba/render_rgb_envmap_mat.py` equivalent): for every first
    hit, integrate Li * brdf * cos over a lat-long direction quadrature,
    with BVH shadow rays for visibility.  Pure numpy + native BVH —
    independent of the framework's compute path.  `assets` (load_assets)
    stands in for the files."""
    tr = _trace_and_materials(mesh_path, material_dir, cam, assets)
    pts, n, hit = tr["pts"], tr["normal"], tr["hit"]
    wo = -tr["rd"]
    N = pts.shape[0]

    dirs, w = sphere_dirs_weights(n_theta, n_phi)
    M = len(dirs)
    Li_all = envmap_lookup(envmap, dirs)          # [M, 3]
    color = np.zeros((N, 3), np.float64)

    hit_idx = np.nonzero(hit)[0]
    Nh = len(hit_idx)
    if Nh == 0:
        H, W = cam.H, cam.W
        return {"color": color.reshape(H, W, 3).astype(np.float32),
                "depth": np.where(hit, tr["t"], 0.0).reshape(H, W),
                "mask": hit.reshape(H, W),
                "normal": np.where(hit[:, None], n, 0.0).reshape(H, W, 3)}
    hp = pts[hit_idx]
    hn = n[hit_idx]
    hwo = wo[hit_idx]
    hdiff, hspec, hrough = (tr["diffuse"][hit_idx], tr["specular"][hit_idx],
                            tr["rough"][hit_idx])

    cos_i = hn @ dirs.T                           # [Nh, M]
    front = cos_i > 1e-4
    vis = front.copy()
    if with_shadows:
        # one batched BVH pass over every front-facing (hit, dir) pair
        pi, dj = np.nonzero(front)
        so = hp[pi] + shadow_eps * hn[pi]
        sd = dirs[dj]
        ts, _, _ = ray_mesh_intersect(np.ascontiguousarray(so),
                                      np.ascontiguousarray(sd),
                                      tr["verts"], tr["tris"])
        vis[pi, dj] = ts <= 0  # no hit -> sky visible

    # per-pair BRDF: broadcast points over the direction axis
    wi_b = np.broadcast_to(dirs[None], (Nh, M, 3))
    diff, spec = _ggx_roughplastic_np(
        wi_b, hwo[:, None, :], hn[:, None, :], hdiff[:, None, :],
        hspec[:, None, :], hrough[:, None, :], cam.device)    # [Nh, M, 3]
    contrib = (Li_all[None] * w[None, :, None]) * (diff + spec)
    color[hit_idx] = np.sum(np.where(vis[..., None], contrib, 0.0), axis=1)
    H, W = cam.H, cam.W
    return {
        "color": color.reshape(H, W, 3).astype(np.float32),
        "depth": np.where(hit, tr["t"], 0.0).reshape(H, W),
        "mask": hit.reshape(H, W),
        "normal": np.where(hit[:, None], n, 0.0).reshape(H, W, 3),
    }
