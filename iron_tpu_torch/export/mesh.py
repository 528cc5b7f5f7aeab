"""Mesh extraction & export (counterpart of iron_tpu/export/mesh.py).

Behavioral spec from reference `models/export_mesh.py:50-130` (export_mesh):
two-pass extraction — low-res 100^3 marching cubes, keep the largest
connected component, sample 10k surface points, PCA-align a tight grid,
re-run marching cubes at `resolution` in the aligned frame, transform back,
write .obj.  `extract_geometry` mirrors models/renderer.py:34-42 (field is
-sdf, threshold 0).

Native path: iso-surfacing runs in the C++ runtime
(iron_tpu_torch/native/mesh_native.cpp) since neither PyMCubes nor skimage
is available; connected components via scipy.sparse.  The grids are numpy
f32, as in the JAX package, so both evaluate the same points; the SDF
(`sdf_fn`: a torch tensor [N, 3] -> [N]) runs on `device`, 200,000 points a
call, without a graph.
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

from iron_tpu_torch import resolve_device
from iron_tpu_torch.native import marching_cubes


def _eval_sdf_grid(sdf_fn: Callable, pts: np.ndarray, chunk: int = 200_000,
                   device="cuda") -> np.ndarray:
    """Chunked SDF evaluation (chunk size per raytracer.py:153): each chunk
    moved to `device`, evaluated without a graph, and brought back."""
    dev = resolve_device(device)
    out = []
    with torch.no_grad():
        for i in range(0, pts.shape[0], chunk):
            p = torch.as_tensor(np.ascontiguousarray(pts[i:i + chunk], np.float32), device=dev)
            out.append(sdf_fn(p).detach().to(torch.float32).cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.float32)


def extract_geometry(sdf_fn: Callable, bound_min=(-1, -1, -1), bound_max=(1, 1, 1),
                     resolution: int = 128, threshold: float = 0.0, device="cuda"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Marching cubes of the SDF zero set (renderer.py:34-42 semantics:
    query = -sdf, surface at `threshold`)."""
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    axes = [np.linspace(bound_min[d], bound_max[d], resolution, dtype=np.float32)
            for d in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
    field = _eval_sdf_grid(sdf_fn, pts, device=device).reshape(resolution, resolution,
                                                               resolution)
    spacing = (bound_max - bound_min) / (resolution - 1)
    # inside = sdf < 0  <=>  -sdf > threshold
    return marching_cubes(field, origin=bound_min, spacing=spacing, iso=-threshold)


def largest_component(verts: np.ndarray, tris: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the connected component with the largest surface area
    (export_mesh.py:76-79)."""
    if len(tris) == 0:
        return verts, tris
    n = len(verts)
    i = np.concatenate([tris[:, 0], tris[:, 1], tris[:, 2]])
    j = np.concatenate([tris[:, 1], tris[:, 2], tris[:, 0]])
    adj = sp.coo_matrix((np.ones_like(i), (i, j)), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    tri_label = labels[tris[:, 0]]
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    best = np.argmax(np.bincount(tri_label, weights=area))
    keep = tri_label == best
    tris = tris[keep]
    used = np.unique(tris)
    remap = np.full(n, -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[tris].astype(np.int32)


def orient_faces(verts: np.ndarray, tris: np.ndarray,
                 sdf_fn: Callable = None, device="cuda") -> np.ndarray:
    """Make triangle winding consistent across each connected component,
    then globally outward (positive enclosed volume; or, when `sdf_fn` is
    given, normals pointing toward increasing SDF; it runs on `device`).

    The native marching-tetrahedra emits per-tet triangles with
    inconsistent winding (measured 56/44 outward/inward on a sphere),
    which breaks any orientation consumer — normal-clustered UV charting,
    exported .obj shading, signed volume.  BFS over edge-adjacency:
    a shared edge must appear in OPPOSITE vertex order in its two faces.
    """
    tris = np.asarray(tris, np.int64).copy()
    T = len(tris)
    # directed-edge map: for each face, its 3 directed edges
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    face_of = np.tile(np.arange(T), 3)
    und = np.sort(edges, axis=1)
    order = np.lexsort((und[:, 1], und[:, 0]))
    e_s, f_s, dir_s = und[order], face_of[order], (edges[:, 0] < edges[:, 1])[order]
    same = np.all(e_s[1:] == e_s[:-1], axis=1)
    # neighbor pairs + whether their shared edge runs in the same direction
    pair_a, pair_b = f_s[:-1][same], f_s[1:][same]
    same_dir = dir_s[:-1][same] == dir_s[1:][same]
    adj = [[] for _ in range(T)]
    for a, b, sd in zip(pair_a, pair_b, same_dir):
        adj[a].append((b, sd))
        adj[b].append((a, sd))

    flip = np.zeros(T, bool)
    seen = np.zeros(T, bool)
    for seed in range(T):
        if seen[seed]:
            continue
        seen[seed] = True
        frontier = [seed]
        while frontier:
            nxt = []
            for f in frontier:
                for nb, sd in adj[f]:
                    if not seen[nb]:
                        seen[nb] = True
                        # consistent orientation = shared edge in opposite
                        # direction; same direction means exactly one of the
                        # two faces must flip
                        flip[nb] = flip[f] ^ sd
                        nxt.append(nb)
            frontier = nxt
    tris[flip] = tris[flip][:, ::-1]

    # global orientation: outward = positive signed volume
    v = np.asarray(verts, np.float64)
    p0, p1, p2 = v[tris[:, 0]], v[tris[:, 1]], v[tris[:, 2]]
    vol = np.sum(np.einsum("ij,ij->i", p0, np.cross(p1, p2))) / 6.0
    if sdf_fn is not None:
        fn = np.cross(p1 - p0, p2 - p0)
        c = (p0 + p1 + p2) / 3.0
        nn = fn / np.clip(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20, None)
        h = 1e-3
        d = _eval_sdf_grid(sdf_fn, (c + h * nn).astype(np.float32), device=device) - \
            _eval_sdf_grid(sdf_fn, (c - h * nn).astype(np.float32), device=device)
        if np.mean(d > 0) < 0.5:
            tris = tris[:, ::-1]
    elif vol < 0:
        tris = tris[:, ::-1]
    return tris


def sample_mesh_points(verts: np.ndarray, tris: np.ndarray, n: int,
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Area-weighted surface sampling (export_materials.py:13-56 scheme)."""
    rng = rng or np.random.default_rng(0)
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    p = area / area.sum()
    idx = rng.choice(len(tris), size=n, p=p)
    r = rng.random((n, 2))
    s = np.sqrt(r[:, :1])
    return ((1 - s) * a[idx] + s * (1 - r[:, 1:]) * b[idx] + s * r[:, 1:] * c[idx]
            ).astype(np.float32)


def export_mesh(sdf_fn: Callable, mesh_fpath: str, resolution: int = 512,
                low_res: int = 100, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Two-pass PCA-aligned extraction (export_mesh.py:50-130)."""
    if not mesh_fpath.endswith(".obj"):
        raise ValueError(f"must use .obj format: {mesh_fpath}")
    verts, tris = extract_geometry(lambda p: -sdf_fn(p), resolution=low_res, device=device)
    verts, tris = largest_component(verts, tris)
    pc = sample_mesh_points(verts, tris, 10_000)

    mean = pc.mean(axis=0)
    cov = (pc - mean).T @ (pc - mean)
    _, vecs = np.linalg.eigh(cov)
    vecs = vecs.T[::-1].copy()  # rows = principal axes, descending variance
    if np.linalg.det(vecs) < 0:
        vecs = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32) @ vecs
    aligned = (pc - mean) @ vecs.T

    eps = 0.1
    amin = aligned.min(axis=0) - eps
    amax = aligned.max(axis=0) + eps
    shortest = np.argmin(amax - amin)
    length = (amax - amin)[shortest]
    step = length / (resolution - 1)
    axes = [np.arange(amin[d], amax[d] + step, step, dtype=np.float32)
            if d != shortest else
            np.linspace(amin[d], amax[d], resolution, dtype=np.float32)
            for d in range(3)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    grid_aligned = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)
    grid_world = grid_aligned @ vecs + mean
    field = _eval_sdf_grid(sdf_fn, grid_world.astype(np.float32), device=device)
    field = field.reshape(len(axes[0]), len(axes[1]), len(axes[2]))

    if field.min() > 0 or field.max() < 0:
        verts2, tris2 = verts, tris
    else:
        v_al, tris2 = marching_cubes(field, origin=amin,
                                     spacing=[axes[0][1] - axes[0][0],
                                              axes[1][1] - axes[1][0],
                                              axes[2][1] - axes[2][0]], iso=0.0)
        verts2 = (v_al @ vecs + mean).astype(np.float32)
        verts2, tris2 = largest_component(verts2, tris2)

    tris2 = orient_faces(verts2, tris2)
    write_obj(mesh_fpath, verts2, tris2)
    return verts2, tris2


# ---------------- minimal OBJ IO (trimesh replacement) ----------------
# The JAX package's text format, written and parsed a column at a time: a
# mesh of a 512^3 export has millions of lines, where a Python loop over the
# lines takes minutes.  `_read_obj_lines` is the JAX package's line parser,
# kept for files outside the fast path's layout (read_obj picks it).

def write_obj(path: str, verts: np.ndarray, tris: np.ndarray,
              uvs: Optional[np.ndarray] = None,
              tri_uvs: Optional[np.ndarray] = None,
              mtl_name: Optional[str] = None) -> None:
    cols = lambda a, n: np.asarray(a).reshape(-1, n).T.tolist()
    with open(path, "w") as f:
        if mtl_name:
            f.write(f"mtllib {mtl_name}.mtl\nusemtl {mtl_name}\n")
        f.write("".join(map("v {:.6f} {:.6f} {:.6f}\n".format, *cols(verts, 3))))
        t = cols(np.asarray(tris, np.int64) + 1, 3)
        if uvs is not None:
            f.write("".join(map("vt {:.6f} {:.6f}\n".format, *cols(uvs, 2))))
            tu = cols(np.asarray(tri_uvs, np.int64) + 1, 3)
            n = min(len(t[0]), len(tu[0]))
            f.write("".join(map("f {}/{} {}/{} {}/{}\n".format,
                                *(c[:n] for pair in zip(t, tu) for c in pair))))
        else:
            f.write("".join(map("f {} {} {}\n".format, *t)))


def _numbers(data: bytes, starts, ends, rows, prefix: bytes, k: int, dtype, slashes: int = 0):
    """The numbers of lines `rows` (each `prefix` + k numbers, `slashes` of
    them a line joined by "/" to the next) as [n, k], or None when the
    lines hold anything else."""
    if len(rows) == 0:
        return np.zeros((0, k), dtype)
    breaks = np.flatnonzero(np.diff(rows) != 1)
    first = np.concatenate([[rows[0]], rows[breaks + 1]])
    last = np.concatenate([rows[breaks], [rows[-1]]])
    text = b"".join((b"\n" + data[starts[i]:ends[j]]).replace(b"\n" + prefix, b"\n")
                    for i, j in zip(first.tolist(), last.tolist()))
    if text.count(b"/") != slashes * len(rows) or b"//" in text:
        return None
    text = text.replace(b"/", b" ")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        try:
            vals = np.fromstring(text, dtype=dtype, sep=" ")
        except (ValueError, DeprecationWarning):
            return None
    return vals.reshape(-1, k) if vals.size == k * len(rows) else None


def _read_obj_fast(data: bytes):
    """read_obj's result for the layout write_obj writes (vertices of 3
    numbers, uvs of 2, triangles all "a" or all "a/b", each line led by its
    keyword and one space), found by a scan of the bytes; None for any
    other file."""
    buf = np.frombuffer(data + b"\0\0\0", np.uint8)
    if not len(data) or (buf == 13).any():
        return None
    nl = np.flatnonzero(buf[:len(data)] == 10)
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [len(data)]])
    c0, c1, c2 = buf[starts], buf[starts + 1], buf[starts + 2]
    if ((c0 == 32) | (c0 == 9)).any() or (((c0 == 118) | (c0 == 102)) & (c1 == 9)).any() \
            or ((c0 == 118) & (c1 == 116) & (c2 == 9)).any():
        return None                     # whitespace the scan does not parse: line parser
    is_v = np.flatnonzero((c0 == 118) & (c1 == 32))
    is_vt = np.flatnonzero((c0 == 118) & (c1 == 116) & (c2 == 32))
    is_f = np.flatnonzero((c0 == 102) & (c1 == 32))
    if not len(is_v) or not len(is_f):
        return None
    verts = _numbers(data, starts, ends, is_v, b"v ", 3, np.float64)
    uvs = _numbers(data, starts, ends, is_vt, b"vt ", 2, np.float64)
    tris = _numbers(data, starts, ends, is_f, b"f ", 3, np.int64)
    pairs = None if tris is not None else _numbers(data, starts, ends, is_f, b"f ", 6, np.int64,
                                                   slashes=3)
    if verts is None or uvs is None or (tris is None and pairs is None):
        return None
    tri_uvs = np.zeros((0, 3), np.int32)
    if tris is None:
        tris, tri_uvs = pairs[:, 0::2], (pairs[:, 1::2] - 1).astype(np.int32)
    return (verts.astype(np.float32), (tris - 1).astype(np.int32), uvs.astype(np.float32),
            tri_uvs)


def read_obj(path: str):
    """Returns (verts, tris, uvs, tri_uvs); uvs may be empty."""
    with open(path, "rb") as f:
        data = f.read()
    fast = _read_obj_fast(data)
    return fast if fast is not None else _read_obj_lines(data.decode())


def _read_obj_lines(text: str):
    """The JAX package's line-by-line parser (iron_tpu/export/mesh.py)."""
    verts, uvs, tris, tri_uvs = [], [], [], []
    for line in text.splitlines():
        p = line.split()
        if not p:
            continue
        if p[0] == "v":
            verts.append([float(x) for x in p[1:4]])
        elif p[0] == "vt":
            uvs.append([float(x) for x in p[1:3]])
        elif p[0] == "f":
            vi, ti = [], []
            for tok in p[1:4]:
                parts = tok.split("/")
                vi.append(int(parts[0]) - 1)
                if len(parts) > 1 and parts[1]:
                    ti.append(int(parts[1]) - 1)
            tris.append(vi)
            if ti:
                tri_uvs.append(ti)
    return (np.asarray(verts, np.float32), np.asarray(tris, np.int32),
            np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32),
            np.asarray(tri_uvs, np.int32) if tri_uvs else np.zeros((0, 3), np.int32))
