"""Camera-frustum visualisation and Fresnel-term plots (counterpart of
iron_tpu/utils/visualize.py): the reference's camera viewer (per-split
coloured frustums and the unit sphere) and its Fresnel plots (conductor and
dielectric Fresnel against the angle), drawn by a small numpy rasteriser of
the port's own and written through `data.io.write_image`, with nothing of
matplotlib, OpenCV or PIL (the card's machine has none of them).

The figures keep the content of the JAX package's matplotlib figures at
its pixel size (dpi 120: 960 x 960 and 1200 x 480) on a white ground:
each split's frustum segments in matplotlib's tab10 colours (the JAX
package's split order: red, blue, green, orange, purple) over the gray
unit-sphere wireframe (alpha 0.2), seen orthographically from matplotlib's
default 3D view (elevation 30, azimuth -60) in a box of equal sides around
the data; and two panels of the port's `fresnel_dielectric` (eta 1.3, 1.5,
1.8) and `fresnel_conductor_exact` (CONDUCTOR_IOR_850NM) at the same 256
cosines, in the colour cycle's order, each panel framed in black on
matplotlib's autoscaled limits (the data range and 5% margins).  Text --
titles, axis labels, ticks, legends -- is not drawn, and lines are not
antialiased.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# matplotlib's tab10, in its colour-cycle order (C0 ... C9)
TAB10 = {"tab:blue": (31, 119, 180), "tab:orange": (255, 127, 14), "tab:green": (44, 160, 44),
         "tab:red": (214, 39, 40), "tab:purple": (148, 103, 189), "tab:brown": (140, 86, 75),
         "tab:pink": (227, 119, 194), "tab:gray": (127, 127, 127), "tab:olive": (188, 189, 34),
         "tab:cyan": (23, 190, 207)}
SPLIT_COLOURS = ("tab:red", "tab:blue", "tab:green", "tab:orange", "tab:purple")
DPI = 120
CAMERA_FIGURE = (8, 8)           # inches, as the JAX package's figure
FRESNEL_FIGURE = (10, 4)
ELEV, AZIM = 30.0, -60.0         # matplotlib's default 3D view, degrees
MARGIN = 0.05                    # matplotlib's autoscale margins
FRESNEL_COS = np.linspace(0.01, 1.0, 256)
# each Fresnel panel's frame in figure fractions (left, bottom, right, top;
# about where tight_layout puts them), and the camera plot's square box
FRESNEL_PANELS = ((0.06, 0.12, 0.48, 0.92), (0.56, 0.12, 0.98, 0.92))
CAMERA_BOX = (0.125, 0.11, 0.9, 0.88)


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


class Canvas:
    """An RGB raster on a white ground, float in [0, 255], y down."""

    def __init__(self, width: int, height: int):
        self.pixels = np.full((height, width, 3), 255.0)

    def segments(self, p0: np.ndarray, p1: np.ndarray, colour, width: float = 1.0,
                 alpha: float = 1.0) -> None:
        """Straight segments from p0 [n, 2] to p1 [n, 2] (pixel x, y), each
        pixel they cross blended once with `colour` at `alpha`; a width
        above 1.5 pixels stamps a square of side 2 floor(width / 2) + 1."""
        p0, p1 = np.atleast_2d(np.asarray(p0, np.float64)), np.atleast_2d(np.asarray(p1,
                                                                                     np.float64))
        steps = np.ceil(np.abs(p1 - p0).max(-1) * 2).astype(np.int64) + 1
        t = np.concatenate([np.linspace(0, 1, n) for n in steps])
        a = np.repeat(p0, steps, 0)
        pts = np.rint(a + (np.repeat(p1, steps, 0) - a) * t[:, None]).astype(np.int64)
        r = int(width // 2) if width > 1.5 else 0
        if r:
            off = np.stack(np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1)), -1)
            pts = (pts[:, None] + off.reshape(1, -1, 2)).reshape(-1, 2)
        H, W = self.pixels.shape[:2]
        pts = pts[(pts[:, 0] >= 0) & (pts[:, 0] < W) & (pts[:, 1] >= 0) & (pts[:, 1] < H)]
        idx = np.unique(pts[:, 1] * W + pts[:, 0])
        flat = self.pixels.reshape(-1, 3)
        flat[idx] = alpha * np.asarray(colour, np.float64) + (1 - alpha) * flat[idx]

    def polyline(self, pts: np.ndarray, colour, width: float = 1.0, alpha: float = 1.0) -> None:
        pts = np.asarray(pts, np.float64)
        self.segments(pts[:-1], pts[1:], colour, width, alpha)

    def rectangle(self, x0: float, y0: float, x1: float, y1: float, colour=(0, 0, 0)) -> None:
        c = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]])
        self.polyline(c, colour)

    def write(self, path: str) -> None:
        from iron_tpu_torch.data.io import write_image
        write_image(path, np.clip(np.rint(self.pixels), 0, 255).astype(np.uint8))


def _limits(values: np.ndarray) -> Tuple[float, float]:
    """matplotlib's autoscaled limits: the data range and 5% margins."""
    lo, hi = float(np.min(values)), float(np.max(values))
    pad = (hi - lo) * MARGIN if hi > lo else max(abs(lo), 1.0) * MARGIN
    return lo - pad, hi + pad


def _view_axes() -> Tuple[np.ndarray, np.ndarray]:
    """The screen's right and up directions in world space for the view
    from ELEV / AZIM degrees (z up), as matplotlib's 3D axes orient them."""
    e, a = np.radians(ELEV), np.radians(AZIM)
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.array([-np.sin(e) * np.cos(a), -np.sin(e) * np.sin(a), np.cos(e)])
    return right, up


def camera_projection(points: np.ndarray):
    """The camera plot's map of world points [..., 3] to pixels [..., 2]:
    each axis scaled from its autoscaled limits over `points` to a cube of
    side 1, seen orthographically from the default view, the view's
    extent fitted into CAMERA_BOX of the 960 x 960 figure."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    lims = np.array([_limits(pts[:, i]) for i in range(3)])
    right, up = _view_axes()
    corners = np.array(np.meshgrid(*lims, indexing="ij")).reshape(3, -1).T
    W, H = (int(s * DPI) for s in CAMERA_FIGURE)
    x0, y0, x1, y1 = CAMERA_BOX

    def unit(p):
        return (np.asarray(p, np.float64) - lims[:, 0]) / (lims[:, 1] - lims[:, 0]) - 0.5

    box = np.stack([unit(corners) @ right, unit(corners) @ up], -1)
    half = np.abs(box).max()
    size = min((x1 - x0) * W, (y1 - y0) * H)
    cx, cy = (x0 + x1) / 2 * W, (1 - (y0 + y1) / 2) * H

    def project(p):
        u = unit(p)
        return np.stack([cx + (u @ right) / half * size / 2,
                         cy - (u @ up) / half * size / 2], -1)
    return project


def _sphere_grid(radius: float) -> np.ndarray:
    """The wireframe's grid [24, 12, 3]: u over [0, 2 pi], v over [0, pi]."""
    u, v = np.mgrid[0:2 * np.pi:24j, 0:np.pi:12j]
    return np.stack([radius * np.cos(u) * np.sin(v), radius * np.sin(u) * np.sin(v),
                     radius * np.cos(v)], -1)


def camera_segments(cam_splits: Dict[str, Dict]) -> List[Tuple[str, np.ndarray]]:
    """(colour name, [8, 2, 3] frustum segments) of every camera, in the
    order the plot draws them."""
    out = []
    for i, (split, cams) in enumerate(cam_splits.items()):
        col = SPLIT_COLOURS[i % len(SPLIT_COLOURS)]
        for name, entry in cams.items():
            segs = frustum_lines(np.asarray(entry["K"]).reshape(4, 4),
                                 np.asarray(entry["W2C"]).reshape(4, 4),
                                 entry.get("img_size", (512, 512)))
            out.append((col, segs.reshape(8, 2, 3)))
    return out


def plot_cameras(cam_splits: Dict[str, Dict], out_path: str,
                 sphere_radius: float = 1.0) -> None:
    """3D plot of the camera frustums of each split and the unit sphere:
    a 960 x 960 image (no text; see the module's docstring)."""
    segs = camera_segments(cam_splits)
    grid = _sphere_grid(sphere_radius)
    every = np.concatenate([grid.reshape(-1, 3)] + [s.reshape(-1, 3) for _, s in segs])
    project = camera_projection(every)
    canvas = Canvas(*(int(s * DPI) for s in CAMERA_FIGURE))
    g = project(grid)
    lines = [g[i] for i in range(g.shape[0])] + [g[:, j] for j in range(g.shape[1])]
    p0 = np.concatenate([ln[:-1] for ln in lines])
    p1 = np.concatenate([ln[1:] for ln in lines])
    canvas.segments(p0, p1, TAB10["tab:gray"], alpha=0.2)
    for col, s in segs:
        canvas.segments(project(s[:, 0]), project(s[:, 1]), TAB10[col])
    canvas.write(out_path)


def fresnel_curves() -> List[List[Tuple[str, np.ndarray]]]:
    """The two panels' curves: for each panel a list of (colour name,
    values at FRESNEL_COS) -- the port's dielectric Fresnel for eta 1.3,
    1.5, 1.8, then its exact conductor Fresnel of each 850 nm metal."""
    import torch
    from iron_tpu_torch.shading.brdf import CONDUCTOR_IOR_850NM
    from iron_tpu_torch.shading.fresnel import fresnel_conductor_exact, fresnel_dielectric

    cos_t = torch.as_tensor(FRESNEL_COS, dtype=torch.float32)
    cycle = list(TAB10)
    diel = [(cycle[i], fresnel_dielectric(cos_t, eta).numpy())
            for i, eta in enumerate((1.3, 1.5, 1.8))]
    cond = [(cycle[i], fresnel_conductor_exact(cos_t, eta, k).numpy())
            for i, (eta, k) in enumerate(CONDUCTOR_IOR_850NM.values())]
    return [diel, cond]


def fresnel_projection(panel: int, curves: Sequence[np.ndarray]):
    """Panel `panel`'s map of (cos, value) to pixels of the 1200 x 480
    figure, on limits autoscaled over FRESNEL_COS and `curves`."""
    W, H = (int(s * DPI) for s in FRESNEL_FIGURE)
    x0, y0, x1, y1 = FRESNEL_PANELS[panel]
    (xa, xb), (ya, yb) = _limits(FRESNEL_COS), _limits(np.concatenate(list(curves)))

    def project(x, y):
        return np.stack([(x0 + (np.asarray(x) - xa) / (xb - xa) * (x1 - x0)) * W,
                         (1 - y0 - (np.asarray(y) - ya) / (yb - ya) * (y1 - y0)) * H], -1)
    return project


def plot_fresnel_terms(out_path: str) -> None:
    """Conductor / dielectric Fresnel curves against cos(theta): a
    1200 x 480 image of two framed panels (no text; see the module's
    docstring)."""
    W, H = (int(s * DPI) for s in FRESNEL_FIGURE)
    canvas = Canvas(W, H)
    for panel, curves in enumerate(fresnel_curves()):
        project = fresnel_projection(panel, [v for _, v in curves])
        x0, y0, x1, y1 = FRESNEL_PANELS[panel]
        canvas.rectangle(x0 * W, (1 - y1) * H, x1 * W, (1 - y0) * H)
        for col, values in curves:
            canvas.polyline(project(FRESNEL_COS, values), TAB10[col], width=2.5)
    canvas.write(out_path)
