"""UV parameterization (a copy of iron_tpu/export/uv.py, host numpy).

The reference shells out to headless Blender Smart-UV-Project
(`models/export_uv.py`, invoked at render_surface.py:426-428 and
auto-downloaded by ckpt_loader.py:68-74).  This image has neither Blender
nor network egress, so the built-in parameterization is a dependency-free
**smart unwrap** implementing the same algorithm family as Blender's
Smart-UV-Project / xatlas (SURVEY §7.4.8):

  1. grow charts by region-growing over edge-adjacent faces whose normals
     stay within an angle limit of the chart seed normal,
  2. project each chart onto its seed-normal plane (per-chart planar
     parameterization — angle-bounded, so area/angle distortion is
     bounded by cos(angle_limit)),
  3. shelf-pack the chart bounding boxes into the unit square with a
     margin.

`grid_uv_unwrap` (the round-1 per-face grid atlas) remains as the exact
fallback; `unwrap_obj` prefers Blender when on PATH, then the smart
unwrap.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Tuple

import numpy as np


def grid_uv_unwrap(verts: np.ndarray, tris: np.ndarray, margin: float = 0.15
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-face grid atlas.  Returns (uvs [3T, 2], tri_uvs [T, 3])."""
    T = len(tris)
    cells = int(np.ceil(np.sqrt(T)))
    cell = 1.0 / cells
    idx = np.arange(T)
    cx = (idx % cells).astype(np.float32)
    cy = (idx // cells).astype(np.float32)
    # triangle corners inside each cell (left-lower right-lower top)
    local = np.asarray([[margin, margin],
                        [1.0 - margin, margin],
                        [margin, 1.0 - margin]], np.float32)
    uvs = (np.stack([cx, cy], axis=-1)[:, None, :] + local[None]) * cell
    uvs = uvs.reshape(-1, 2)
    tri_uvs = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    return uvs, tri_uvs


def _face_adjacency(tris: np.ndarray) -> list:
    """Edge-shared face adjacency lists (list of np arrays, one per face)."""
    T = len(tris)
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    face_of = np.tile(np.arange(T), 3)
    # group identical edges: sort lexicographically, shared edges adjacent
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    e = edges[order]
    f = face_of[order]
    same = np.all(e[1:] == e[:-1], axis=1)
    a, b = f[:-1][same], f[1:][same]
    adj = [[] for _ in range(T)]
    for i, j in zip(a, b):
        adj[i].append(j)
        adj[j].append(i)
    return [np.asarray(x, np.int64) for x in adj]


def smart_uv_unwrap(verts: np.ndarray, tris: np.ndarray,
                    angle_limit_deg: float = 15.0,
                    margin: float = 0.003,
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Charted planar unwrap (Blender Smart-UV-Project equivalent).

    Returns (uvs [3T, 2], tri_uvs [T, 3]) — same interface as
    `grid_uv_unwrap`, but charts are contiguous surface regions so texel
    efficiency is several times higher (measured ~0.5-0.65 packing
    efficiency vs ~0.24 for the per-face grid on marching-cubes meshes).

    The JAX package's algorithm, its rotation search over 64 angles done a
    chart at a time (one batched product, the extents reduced along
    contiguous memory): the same products and exact maxima and minima, so
    the uvs are the JAX package's, bit for bit.
    """
    from iron_tpu_torch.export.mesh import orient_faces

    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    T = len(tris)
    # charting normals need CONSISTENT winding: the native marching-tet
    # emits mixed orientation, which scatters face normals to both
    # hemispheres and fragments normal-clustered charts into thousands of
    # singletons.  Orientation is used for the normals only — the emitted
    # uvs follow the caller's original corner order.
    tris_o = orient_faces(verts, tris)
    w0, w1, w2 = verts[tris_o[:, 0]], verts[tris_o[:, 1]], verts[tris_o[:, 2]]
    fn = np.cross(w1 - w0, w2 - w0)
    area2 = np.linalg.norm(fn, axis=1)
    # degenerate (zero-area) faces — marching cubes emits them when grid
    # vertices coincide — get a dummy +z normal: a zero seed normal would
    # produce a NaN projection basis, and one NaN chart bbox poisons the
    # global packing scale (every uv NaN — caught on the 256^3 torus
    # export, round 5)
    degenerate = area2 < 1e-16
    fn = fn / np.clip(area2[:, None], 1e-20, None)
    fn[degenerate] = np.array([0.0, 0.0, 1.0])
    cos_lim = np.cos(np.deg2rad(angle_limit_deg))

    adj = _face_adjacency(tris)

    # --- chart growing: BFS from highest-area unassigned seed ---
    chart = np.full(T, -1, np.int64)
    seeds_order = np.argsort(-area2)
    charts = []
    for seed in seeds_order:
        if chart[seed] >= 0:
            continue
        cid = len(charts)
        n0 = fn[seed]
        members = [seed]
        chart[seed] = cid
        frontier = [seed]
        while frontier:
            nxt = []
            for fidx in frontier:
                for nb in adj[fidx]:
                    if chart[nb] < 0 and float(fn[nb] @ n0) >= cos_lim:
                        chart[nb] = cid
                        members.append(nb)
                        nxt.append(nb)
            frontier = nxt
        charts.append((np.asarray(members, np.int64), n0))

    # --- per-chart planar projection onto the seed-normal plane ---
    angles = np.linspace(0.0, np.pi / 2, 64, endpoint=False)
    rotations = np.stack([np.asarray([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
                          for a in angles])
    chart_uv = []     # per chart: corner uvs [Tc, 3, 2] (origin at 0)
    chart_wh = []
    for members, n0 in charts:
        # orthonormal basis of the projection plane
        h = np.array([1.0, 0.0, 0.0]) if abs(n0[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        bu = np.cross(n0, h)
        nb = np.linalg.norm(bu)
        if nb < 1e-12:                          # belt & braces vs NaN basis
            bu, bv = np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0])
        else:
            bu = bu / nb
            bv = np.cross(n0, bu)
        corners = verts[tris[members]]          # [Tc, 3, 3]
        uv = np.stack([corners @ bu, corners @ bv], axis=-1)  # [Tc, 3, 2]
        # rotate to the minimum-area bounding box (exhaustive over 64
        # angles — crescent/ring charts fill an axis-aligned box poorly)
        pts = uv.reshape(-1, 2)
        r = np.matmul(pts[None], rotations).transpose(0, 2, 1)    # [64, 2, 3 Tc]
        r = np.ascontiguousarray(r)
        wh = r.max(-1) - r.min(-1)
        area = wh[:, 0] * wh[:, 1]
        # the first angle of least area (NaN areas never win)
        best_a = angles[int(np.argmin(np.where(np.isnan(area), np.inf, area)))]
        c, s = np.cos(best_a), np.sin(best_a)
        uv = uv @ np.asarray([[c, -s], [s, c]])
        mn = uv.reshape(-1, 2).min(0)
        uv = uv - mn
        chart_uv.append(uv)
        chart_wh.append(uv.reshape(-1, 2).max(0))
    chart_wh = np.asarray(chart_wh)             # [C, 2] in mesh units

    # --- shelf packing at the largest feasible scale (bisection) ---
    def try_pack(scale):
        order = np.argsort(-chart_wh[:, 1])     # tallest first
        pos = np.zeros((len(charts), 2))
        x = y = shelf_h = 0.0
        for ci in order:
            w, h = chart_wh[ci] * scale + 2 * margin
            if w > 1.0:
                return None
            if x + w > 1.0:                     # new shelf
                y += shelf_h
                x = 0.0
                shelf_h = 0.0
            if y + h > 1.0:
                return None
            pos[ci] = (x + margin, y + margin)
            x += w
            shelf_h = max(shelf_h, h)
        return pos

    total_area = float(np.prod(chart_wh + 1e-12, axis=1).sum())
    lo, hi = 0.0, 1.2 / np.sqrt(total_area)
    pos = None
    while pos is None:                          # find any feasible scale
        pos = try_pack(hi * 0.5)
        if pos is None:
            hi *= 0.5
        else:
            lo = hi * 0.5
    for _ in range(16):                         # maximize it
        mid = 0.5 * (lo + hi)
        p = try_pack(mid)
        if p is not None:
            lo, pos = mid, p
        else:
            hi = mid
    scale = lo
    if scale <= 0:
        raise RuntimeError("uv packing failed to converge")

    uvs = np.zeros((3 * T, 2), np.float32)
    tri_uvs = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    for ci, (members, _) in enumerate(charts):
        uv = chart_uv[ci] * scale + pos[ci]
        uvs[tri_uvs[members].reshape(-1)] = uv.reshape(-1, 2).astype(np.float32)
    if not np.isfinite(uvs).all():   # fail loudly, never bake black atlases
        raise RuntimeError("smart_uv_unwrap produced non-finite uvs")
    return uvs, tri_uvs


def packing_efficiency(uvs: np.ndarray, tri_uvs: np.ndarray) -> float:
    """Fraction of the unit square covered by UV triangles."""
    p = uvs[tri_uvs]                            # [T, 3, 2]
    a = 0.5 * np.abs((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
                     - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    return float(a.sum())


def blender_available() -> bool:
    return shutil.which("blender") is not None


def unwrap_obj(in_path: str, out_path: str) -> None:
    """UV-unwrap an .obj.  Uses Blender smart-project when available,
    otherwise the grid atlas."""
    from iron_tpu_torch.export.mesh import read_obj, write_obj

    if blender_available():
        script = (
            "import bpy, sys\n"
            "argv = sys.argv[sys.argv.index('--')+1:]\n"
            "bpy.ops.object.select_all(action='SELECT')\n"
            "bpy.ops.object.delete()\n"
            "bpy.ops.import_scene.obj(filepath=argv[0])\n"
            "for obj in bpy.context.scene.objects:\n"
            "    bpy.context.view_layer.objects.active = obj\n"
            "    bpy.ops.object.mode_set(mode='EDIT')\n"
            "    bpy.ops.mesh.select_all(action='SELECT')\n"
            "    bpy.ops.uv.smart_project()\n"
            "    bpy.ops.object.mode_set(mode='OBJECT')\n"
            "bpy.ops.export_scene.obj(filepath=argv[1])\n")
        with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
            f.write(script)
            spath = f.name
        try:
            subprocess.run(["blender", "--background", "--python", spath,
                            "--", in_path, out_path], check=True,
                           capture_output=True)
            return
        except subprocess.CalledProcessError:
            pass
        finally:
            os.unlink(spath)

    verts, tris, _, _ = read_obj(in_path)
    try:
        uvs, tri_uvs = smart_uv_unwrap(verts, tris)
    except RuntimeError:    # packing did not converge, or non-finite uvs
        uvs, tri_uvs = grid_uv_unwrap(verts, tris)  # exact fallback
    write_obj(out_path, verts, tris, uvs=uvs, tri_uvs=tri_uvs)
