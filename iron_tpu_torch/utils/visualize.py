"""Camera-frustum visualisation and Fresnel-term plots (counterpart of
iron_tpu/utils/visualize.py): the reference's camera viewer (per-split
coloured frustums and the unit sphere) and its Fresnel plots (conductor and
dielectric Fresnel against the angle), drawn with matplotlib, which is
imported only when a plot is made.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def frustum_lines(K: np.ndarray, W2C: np.ndarray, img_size: Tuple[int, int],
                  frustum_length: float = 0.3) -> np.ndarray:
    """8 line segments ([16, 3] points) of a camera frustum in world space."""
    W, H = img_size
    K = np.asarray(K, np.float64)
    C2W = np.linalg.inv(np.asarray(W2C, np.float64))
    corners_px = np.array([[0, 0], [W, 0], [W, H], [0, H]], np.float64)
    rays = np.concatenate([corners_px, np.ones((4, 1))], axis=1) @ np.linalg.inv(K[:3, :3]).T
    rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True) * frustum_length
    cam_pts = np.concatenate([np.zeros((1, 3)), rays], axis=0)
    world = cam_pts @ C2W[:3, :3].T + C2W[:3, 3]
    o, a, b, c, d = world
    segs = [o, a, o, b, o, c, o, d, a, b, b, c, c, d, d, a]
    return np.asarray(segs)


def plot_cameras(cam_splits: Dict[str, Dict], out_path: str,
                 sphere_radius: float = 1.0) -> None:
    """3D plot of the camera frustums of each split and the unit sphere."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    colors = ["tab:red", "tab:blue", "tab:green", "tab:orange", "tab:purple"]
    for i, (split, cams) in enumerate(cam_splits.items()):
        col = colors[i % len(colors)]
        first = True
        for name, entry in cams.items():
            segs = frustum_lines(np.asarray(entry["K"]).reshape(4, 4),
                                 np.asarray(entry["W2C"]).reshape(4, 4),
                                 entry.get("img_size", (512, 512)))
            for s in range(0, len(segs), 2):
                ax.plot(*segs[s:s + 2].T, color=col, linewidth=0.7,
                        label=split if first and s == 0 else None)
            first = False
    u, v = np.mgrid[0:2 * np.pi:24j, 0:np.pi:12j]
    ax.plot_wireframe(sphere_radius * np.cos(u) * np.sin(v),
                      sphere_radius * np.sin(u) * np.sin(v),
                      sphere_radius * np.cos(v), color="gray", alpha=0.2,
                      linewidth=0.4)
    ax.legend()
    ax.set_box_aspect((1, 1, 1))
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_fresnel_terms(out_path: str) -> None:
    """Conductor / dielectric Fresnel curves against cos(theta)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch
    from iron_tpu_torch.shading.brdf import CONDUCTOR_IOR_850NM
    from iron_tpu_torch.shading.fresnel import fresnel_conductor_exact, fresnel_dielectric

    cos = np.linspace(0.01, 1.0, 256)
    cos_t = torch.as_tensor(cos, dtype=torch.float32)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for eta in (1.3, 1.5, 1.8):
        axes[0].plot(cos, fresnel_dielectric(cos_t, eta).numpy(),
                     label=f"eta={eta}")
    axes[0].set_title("dielectric Fresnel")
    axes[0].set_xlabel("cos(theta)")
    axes[0].legend()
    for name, (eta, k) in CONDUCTOR_IOR_850NM.items():
        axes[1].plot(cos, fresnel_conductor_exact(cos_t, eta, k).numpy(),
                     label=f"{name} (850nm)")
    axes[1].set_title("conductor Fresnel")
    axes[1].set_xlabel("cos(theta)")
    axes[1].legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
