"""Camera-dictionary IO and normalization (a copy of iron_tpu/data/cameras.py,
pure numpy).

The on-disk format matches the reference: `cam_dict_norm.json` maps image
filename -> {"K": 16 floats, "W2C": 16 floats, "img_size": [W, H]}
(models/dataset.py:152-163).  Normalization translates + scales all camera
centers into a target-radius sphere (models/normalize_cam_dict.py:34-95) —
the "objects inside the unit sphere" convention the whole pipeline assumes.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Tuple

import numpy as np


def load_cam_dict(path: str) -> Dict[str, Dict]:
    with open(path) as f:
        cam_dict = json.load(f)
    out = {}
    for name, entry in cam_dict.items():
        out[name] = {
            "K": np.asarray(entry["K"], np.float32).reshape(4, 4),
            "W2C": np.asarray(entry["W2C"], np.float32).reshape(4, 4),
            "img_size": tuple(entry.get("img_size", (0, 0))),
        }
    return out


def get_tf_cams(cam_dict: Dict, target_radius: float = 1.0) -> Tuple[np.ndarray, float]:
    """Translate/scale bringing all camera centers inside target_radius
    (normalize_cam_dict.py:34-56): radius = 1.1 * max distance to the mean
    center."""
    centers = []
    for entry in cam_dict.values():
        W2C = np.asarray(entry["W2C"], np.float64).reshape(4, 4)
        centers.append(np.linalg.inv(W2C)[:3, 3])
    centers = np.stack(centers, axis=0)
    mean = centers.mean(axis=0)
    radius = 1.1 * np.max(np.linalg.norm(centers - mean, axis=-1))
    return -mean, target_radius / radius


def transform_pose(W2C: np.ndarray, translate: np.ndarray, scale: float) -> np.ndarray:
    C2W = np.linalg.inv(np.asarray(W2C, np.float64))
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.linalg.inv(C2W).astype(np.float32)


def load_K_Rt_from_P(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decompose a 3x4 projection matrix into (K [4,4], C2W [4,4]) via RQ
    decomposition (reference models/dataset.py:18-39, NeuS convention:
    K normalized by K[2,2], pose returned camera-to-world)."""
    P = np.asarray(P, np.float64)[:3, :4]
    M = P[:3, :3]
    # RQ decomposition via flipped QR
    rev = np.flipud(np.eye(3))
    q, r = np.linalg.qr((rev @ M).T)
    K = rev @ r.T @ rev
    R = rev @ q.T
    # enforce positive diagonal of K
    s = np.diag(np.sign(np.diag(K)))
    K = K @ s
    R = s @ R
    if np.linalg.det(R) < 0:
        R = -R
    t = np.linalg.inv(K) @ P[:3, 3]
    K = K / K[2, 2]
    K4 = np.eye(4)
    K4[:3, :3] = K
    pose = np.eye(4)
    pose[:3, :3] = R.T
    pose[:3, 3] = -R.T @ t
    return K4.astype(np.float32), pose.astype(np.float32)


def load_transforms_json(path: str, H: int, W: int) -> Dict[str, Dict]:
    """Convert an instant-ngp / NeRF-synthetic `transforms.json` into the
    cam-dict format (reference models/dataset.py:254-270 load_TCNN_dict):
    K from camera_angle_x; W2C from the inverse transform_matrix with the
    OpenGL->OpenCV axis flip (y,z negated)."""
    with open(path) as f:
        meta = json.load(f)
    focal = 0.5 * W / np.tan(0.5 * meta["camera_angle_x"])
    K = np.eye(4, dtype=np.float64)
    K[0, 0] = K[1, 1] = focal
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    out = {}
    for fr in meta["frames"]:
        c2w_gl = np.asarray(fr["transform_matrix"], np.float64)
        c2w = c2w_gl @ flip  # rotate camera axes into OpenCV convention
        name = os.path.basename(fr["file_path"])
        if "." not in name:
            name += ".png"
        out[name] = {"K": K.astype(np.float32).copy(),
                     "W2C": np.linalg.inv(c2w).astype(np.float32),
                     "img_size": (W, H)}
    return out


def normalize_cam_dict(in_path: str, out_path: str, target_radius: float = 1.0) -> None:
    """Rewrite a cam dict with normalized poses (normalize_cam_dict.py:59-95)."""
    with open(in_path) as f:
        cam_dict = json.load(f)
    translate, scale = get_tf_cams(
        {k: {"W2C": np.asarray(v["W2C"]).reshape(4, 4)} for k, v in cam_dict.items()},
        target_radius)
    out = copy.deepcopy(cam_dict)
    for name in out:
        W2C = np.asarray(out[name]["W2C"], np.float64).reshape(4, 4)
        W2C = transform_pose(W2C, translate, scale)
        assert np.isclose(np.linalg.det(W2C[:3, :3]), 1.0, atol=1e-4)
        out[name]["W2C"] = [float(x) for x in W2C.flatten()]
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
