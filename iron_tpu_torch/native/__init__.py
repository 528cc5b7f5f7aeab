"""ctypes bindings for the native mesh runtime (counterpart of
iron_tpu/native/__init__.py): host C++ for marching tetrahedra, BVH
point-to-mesh distances and ray casting, in `mesh_native.cpp` (a copy of the
JAX package's source).

The library is built with g++ at first use into `native/build/`, which git
ignores, named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one reused.  Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mesh_native.cpp")
BUILD_DIR = os.path.join(_DIR, "build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp"]
_LOCK = threading.Lock()
_LIB = None


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmesh_native-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native mesh runtime is built with g++ at "
                           "first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *FLAGS, _SRC, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for mesh_native.cpp (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.mc_extract.restype = ctypes.c_int64
        lib.mc_extract.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, f32p, f32p, ctypes.c_float]
        lib.mc_num_verts.restype = ctypes.c_int64
        lib.mc_num_verts.argtypes = []
        lib.mc_num_tris.restype = ctypes.c_int64
        lib.mc_num_tris.argtypes = []
        lib.mc_get_verts.restype = None
        lib.mc_get_verts.argtypes = [f32p]
        lib.mc_get_tris.restype = None
        lib.mc_get_tris.argtypes = [i32p]
        lib.mc_free.restype = None
        lib.mc_free.argtypes = []
        lib.bvh_create.restype = None
        lib.bvh_create.argtypes = [f32p, ctypes.c_int64, i32p, ctypes.c_int64]
        lib.bvh_sq_distances.restype = None
        lib.bvh_sq_distances.argtypes = [f32p, ctypes.c_int64, f32p]
        lib.bvh_ray_intersect.restype = None
        lib.bvh_ray_intersect.argtypes = [f32p, f32p, ctypes.c_int64, f32p, i32p, f32p]
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = []
        _LIB = lib
        return lib


def _check_mesh(verts: np.ndarray, tris: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    verts = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    tris = np.ascontiguousarray(tris, np.int32).reshape(-1, 3)
    if len(tris) and (tris.min() < 0 or tris.max() >= len(verts)):
        raise ValueError(f"triangle indices out of range for {len(verts)} vertices")
    return verts, tris


def marching_cubes(field: np.ndarray, origin, spacing, iso: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The iso-surface of a [nx, ny, nz] scalar field -> (verts [V, 3]
    float32, tris [T, 3] int32).  Values below `iso` are inside (pass -sdf
    with iso 0 for the reference's `-sdf` convention, renderer.py:455-462)."""
    lib = _lib()
    field = np.ascontiguousarray(field, np.float32)
    if field.ndim != 3:
        raise ValueError(f"marching_cubes takes a 3-d field, got {field.shape}")
    origin = np.ascontiguousarray(origin, np.float32).reshape(3)
    spacing = np.ascontiguousarray(spacing, np.float32).reshape(3)
    with _LOCK:
        lib.mc_extract(field, *field.shape, origin, spacing, np.float32(iso))
        nv, nt = lib.mc_num_verts(), lib.mc_num_tris()
        verts = np.empty((nv, 3), np.float32)
        tris = np.empty((nt, 3), np.int32)
        if nv:
            lib.mc_get_verts(verts)
        if nt:
            lib.mc_get_tris(tris)
        lib.mc_free()
    return verts, tris


def ray_mesh_intersect(ray_o: np.ndarray, ray_d: np.ndarray, verts: np.ndarray,
                       tris: np.ndarray):
    """Closest-hit ray casting against a triangle mesh -> (t [N] (-1 a
    miss), tri_idx [N], bary_uv [N, 2])."""
    lib = _lib()
    ray_o = np.ascontiguousarray(ray_o, np.float32).reshape(-1, 3)
    ray_d = np.ascontiguousarray(ray_d, np.float32).reshape(-1, 3)
    if ray_o.shape != ray_d.shape:
        raise ValueError(f"ray origins {ray_o.shape} and directions {ray_d.shape} differ")
    verts, tris = _check_mesh(verts, tris)
    n = ray_o.shape[0]
    out_t = np.empty(n, np.float32)
    out_tri = np.empty(n, np.int32)
    out_uv = np.empty((n, 2), np.float32)
    with _LOCK:
        lib.bvh_create(verts, verts.shape[0], tris, tris.shape[0])
        lib.bvh_ray_intersect(ray_o, ray_d, n, out_t, out_tri, out_uv)
        lib.bvh_free()
    return out_t, out_tri, out_uv


def point_mesh_sq_distances(points: np.ndarray, verts: np.ndarray,
                            tris: np.ndarray) -> np.ndarray:
    """Squared distance from each point [N, 3] to the mesh."""
    lib = _lib()
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    verts, tris = _check_mesh(verts, tris)
    out = np.empty(points.shape[0], np.float32)
    with _LOCK:
        lib.bvh_create(verts, verts.shape[0], tris, tris.shape[0])
        lib.bvh_sq_distances(points, points.shape[0], out)
        lib.bvh_free()
    return out
