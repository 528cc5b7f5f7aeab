"""Independent ground-truth renderer (counterpart of
iron_tpu/eval/independent_gt.py), the port's own numpy copy.

A direct-light renderer whose every stage is disjoint from the port's
compute path, the stand-in for the Mitsuba renders the reference validates
against:

  * geometry: the analytic SDF meshed by the native marching cubes
    (`iron_tpu_torch.native`), pixel rays intersected by the native BVH:
    no sphere tracing, no PyTorch;
  * ray generation: numpy from K / W2C (OpenCV convention), not
    `core.camera`;
  * shading: the co-located roughplastic GGX re-implemented in numpy from
    the Mitsuba / reference formulas over the shipped Mitsuba rtrans tables,
    with its own table lookup: nothing of `iron_tpu_torch.shading`;
  * normals: numpy central differences of the numpy scene SDF.

The scene SDFs (sphere, blobby, torus, genus2) are re-stated in numpy; the
camera rigs come from `data.synthetic` (they only place the eyes).
"""
from __future__ import annotations

import functools
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from iron_tpu_torch.native import marching_cubes, ray_mesh_intersect

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "assets", "ggx")


# ---------------------------------------------------------------------------
# numpy scene SDFs (re-statements of the data/synthetic.py scenes)
# ---------------------------------------------------------------------------

def sphere_sdf_np(radius: float = 0.5) -> Callable[[np.ndarray], np.ndarray]:
    def f(p):
        return np.linalg.norm(p, axis=-1) - radius
    return f


def blobby_sdf_np(radius: float = 0.45, amp: float = 0.08) -> Callable:
    def f(p):
        h = amp * (np.sin(4.0 * p[..., 0]) * np.sin(4.0 * p[..., 1])
                   + 0.5 * np.sin(6.0 * p[..., 2]))
        return np.linalg.norm(p, axis=-1) - radius - h
    return f


def torus_sdf_np(R: float = 0.42, r: float = 0.18) -> Callable:
    def f(p):
        q = np.stack([np.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2) - R,
                      p[..., 1]], axis=-1)
        return np.linalg.norm(q, axis=-1) - r
    return f


def genus2_sdf_np(R: float = 0.26, r: float = 0.13, sep: float = 0.26,
                  k: float = 0.06) -> Callable:
    """Genus-2 pretzel (two smooth-min-welded xy-plane tori, hole axes z), a
    numpy re-statement of data/synthetic.py genus2_scene."""
    def torus_xy(p, cx):
        q0 = np.sqrt((p[..., 0] - cx) ** 2 + p[..., 1] ** 2) - R
        return np.sqrt(q0 ** 2 + p[..., 2] ** 2) - r

    def f(p):
        a = torus_xy(p, -sep)
        b = torus_xy(p, sep)
        h = np.clip(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
        return b + (a - b) * h - k * h * (1.0 - h)
    return f


SCENES_NP = {"sphere": sphere_sdf_np, "blobby": blobby_sdf_np,
             "torus": torus_sdf_np, "genus2": genus2_sdf_np}


def sdf_normals_np(sdf_fn: Callable, pts: np.ndarray,
                   eps: float = 1e-4) -> np.ndarray:
    """Central-difference normals of a numpy SDF."""
    g = np.stack([
        sdf_fn(pts + np.array([eps, 0, 0])) - sdf_fn(pts - np.array([eps, 0, 0])),
        sdf_fn(pts + np.array([0, eps, 0])) - sdf_fn(pts - np.array([0, eps, 0])),
        sdf_fn(pts + np.array([0, 0, eps])) - sdf_fn(pts - np.array([0, 0, eps])),
    ], axis=-1)
    return g / (np.linalg.norm(g, axis=-1, keepdims=True) + 1e-12)


# ---------------------------------------------------------------------------
# numpy co-located roughplastic GGX (independent of iron_tpu_torch.shading)
# ---------------------------------------------------------------------------

_NUM_THETA = 100
_NUM_ALPHA = 50
_ETA_PLASTIC = 1.48958738


@functools.lru_cache(maxsize=None)
def _tables() -> Tuple[np.ndarray, np.ndarray]:
    trans = np.loadtxt(os.path.join(_ASSET_DIR, "ext_mts_rtrans_data.txt"))
    diff = np.loadtxt(os.path.join(_ASSET_DIR, "int_mts_diff_rtrans_data.txt"))
    return trans.astype(np.float64), diff.astype(np.float64)


def ggx_colocated_np(light: float, dist: np.ndarray, normal: np.ndarray,
                     viewdir: np.ndarray, diffuse_albedo: np.ndarray,
                     specular_albedo: np.ndarray,
                     roughness: np.ndarray) -> Dict[str, np.ndarray]:
    """Mitsuba roughplastic under a co-located point light, in numpy.

    Formulas per Mitsuba's roughplastic plugin specialized to n.v == n.l
    == n.h (the co-located geometry, renderer_ggx.py:61-146):
      spec = Li * s_albedo * F * D * G / (4 cos)
      diff = Li * d_albedo/(1-Fdr)/pi * cos * T12 * T21 / eta^2
    with F = 0.03867 (const), D = GGX NDF, G = smithG1^2, and T12/Fdr from
    the shipped Mitsuba rtrans tables (warped-index nearest lookup).
    """
    trans_tab, diff_tab = _tables()
    cos = np.sum(viewdir * normal, axis=-1, keepdims=True)
    cos = np.clip(cos, 0.00001, 0.99999)
    alpha = np.clip(roughness, 0.0001, None)
    li = light / (dist * dist + 1e-10)

    # GGX NDF at the (co-located) half-vector cosine
    cos2 = cos * cos
    root = cos2 + (1.0 - cos2) / (alpha * alpha + 1e-10)
    D = 1.0 / (np.pi * alpha * alpha * root * root + 1e-10)
    # Smith G1 squared
    tan = np.sqrt(np.clip(1.0 - cos2, 0.0, None)) / (cos + 1e-10)
    G1 = 2.0 / (1.0 + np.hypot(alpha * tan, 1.0))
    F = 0.03867
    spec = li * specular_albedo * F * D * G1 * G1 / (4.0 * cos + 1e-10)

    # table-driven internal-scattering diffuse
    w_cos = cos ** 0.25
    w_alpha = (alpha / 4.0) ** 0.25
    tx = np.floor(w_cos * _NUM_THETA).astype(np.int64)
    ty = np.floor(w_alpha * _NUM_ALPHA).astype(np.int64)
    t_idx = np.clip(ty * _NUM_THETA + tx, 0, trans_tab.shape[0] - 1)
    T12 = np.clip(trans_tab[t_idx], 0.0, 1.0)
    f_idx = np.clip(np.floor(w_alpha * _NUM_ALPHA).astype(np.int64),
                    0, diff_tab.shape[0] - 1)
    Fdr = np.clip(1.0 - diff_tab[f_idx], 0.0, 1.0)
    diff = (li * (diffuse_albedo / (1.0 - Fdr + 1e-10) / np.pi)
            * cos * T12 * T12 / (_ETA_PLASTIC * _ETA_PLASTIC))

    return {"diffuse_rgb": diff.astype(np.float32),
            "specular_rgb": spec.astype(np.float32),
            "rgb": (diff + spec).astype(np.float32)}


# ---------------------------------------------------------------------------
# meshing + ray casting + rendering
# ---------------------------------------------------------------------------

def mesh_scene_np(sdf_fn: Callable, resolution: int = 384,
                  bound: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh the SDF zero set with the native marching tetrahedra."""
    xs = np.linspace(-bound, bound, resolution, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    field = sdf_fn(pts).reshape(resolution, resolution, resolution).astype(np.float32)
    spacing = xs[1] - xs[0]
    verts, tris = marching_cubes(field, origin=(-bound, -bound, -bound),
                                 spacing=(spacing, spacing, spacing), iso=0.0)
    return verts, tris


def rays_np(K: np.ndarray, W2C: np.ndarray, H: int, W: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel-center rays in world space, OpenCV convention (numpy)."""
    C2W = np.linalg.inv(np.asarray(W2C, np.float64))
    K_inv = np.linalg.inv(np.asarray(K, np.float64)[:3, :3])
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    dirs_cam = pix @ K_inv.T
    dirs = dirs_cam @ C2W[:3, :3].T
    o = np.broadcast_to(C2W[:3, 3], dirs.shape)
    return o.astype(np.float32).copy(), dirs.astype(np.float32).copy()


def render_view_np(verts: np.ndarray, tris: np.ndarray, sdf_fn: Callable,
                   K: np.ndarray, W2C: np.ndarray, H: int, W: int,
                   light: float, diffuse_albedo=(0.6, 0.3, 0.2),
                   specular_albedo: float = 0.3, roughness: float = 0.2,
                   refine_iters: int = 6) -> Dict[str, np.ndarray]:
    """Render one co-located-flash view: BVH first hit + numpy GGX shade.

    `refine_iters` Newton steps along the ray (t -= f/(grad.d)) polish the
    mesh hit onto the true SDF zero set, removing the O(grid spacing)
    tessellation bias while keeping the visibility decision (which ray
    hits, and which triangle first) entirely the BVH's.
    """
    ro, rd = rays_np(K, W2C, H, W)
    rd_n = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    t, tri_idx, _ = ray_mesh_intersect(ro, rd_n, verts, tris)
    hit = t > 0
    t_safe = np.where(hit, t, 1.0)
    pts = ro + rd_n * t_safe[:, None]
    for _ in range(refine_iters):
        f = sdf_fn(pts)
        n = sdf_normals_np(sdf_fn, pts)
        denom = np.sum(n * rd_n, axis=-1)
        step = f / np.where(np.abs(denom) < 1e-6,
                            np.sign(denom + 1e-12) * 1e-6, denom)
        step = np.clip(step, -2e-3, 2e-3)  # stay within the tessellation cell
        pts = pts - np.where(hit, step, 0.0)[:, None] * rd_n

    normal = sdf_normals_np(sdf_fn, pts)
    viewdir = -rd_n
    # orient towards the viewer (matches the tracer's outward convention)
    normal = np.where(np.sum(normal * viewdir, axis=-1, keepdims=True) < 0,
                      -normal, normal)
    dist = np.linalg.norm(pts - ro, axis=-1, keepdims=True)

    sh = ggx_colocated_np(light, dist, normal, viewdir,
                          np.asarray(diffuse_albedo, np.float32)[None],
                          np.full((1, 3), specular_albedo, np.float32),
                          np.full((1, 1), roughness, np.float32))
    m = hit[:, None]
    return {
        "color": np.where(m, sh["rgb"], 0.0).reshape(H, W, 3).astype(np.float32),
        "diffuse_color": np.where(m, sh["diffuse_rgb"], 0.0).reshape(H, W, 3).astype(np.float32),
        "specular_color": np.where(m, sh["specular_rgb"], 0.0).reshape(H, W, 3).astype(np.float32),
        "mask": hit.reshape(H, W),
        "depth": np.where(hit, t, 0.0).reshape(H, W).astype(np.float32),
        "normal": np.where(m, normal, 0.0).reshape(H, W, 3).astype(np.float32),
    }


def render_independent_dataset(scene: str = "sphere", n_views: int = 12,
                               H: int = 128, W: int = 128, light: float = 30.0,
                               rig: str = "ring", rig_kwargs: Optional[Dict] = None,
                               mesh_resolution: int = 384,
                               **scene_kwargs) -> Dict:
    """Multi-view co-located-flash dataset from the independent renderer:
    images, masks, Ks, W2Cs and light as `data.synthetic.
    render_synthetic_dataset` gives them, with "verts" / "tris" of the GT
    mesh, so trainers and `write_scene_dir` take it unchanged.  Camera rigs
    come from data.synthetic (they only place the eyes); the rays here are
    numpy."""
    from iron_tpu_torch.data.synthetic import hemisphere_cameras, ring_cameras

    sdf_fn = SCENES_NP[scene](**scene_kwargs)
    rig_fn = {"ring": ring_cameras, "hemisphere": hemisphere_cameras}[rig]
    Ks, W2Cs = rig_fn(n_views, H=H, W=W, **(rig_kwargs or {}))
    verts, tris = mesh_scene_np(sdf_fn, resolution=mesh_resolution)

    imgs, masks = [], []
    for i in range(n_views):
        out = render_view_np(verts, tris, sdf_fn, Ks[i], W2Cs[i], H, W, light)
        imgs.append(out["color"])
        masks.append(out["mask"][..., None])
    return {
        "images": np.stack(imgs), "masks": np.stack(masks).astype(np.float32),
        "Ks": Ks, "W2Cs": W2Cs, "light": light,
        "verts": verts, "tris": tris,
    }
