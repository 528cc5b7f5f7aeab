"""Mitsuba roughplastic transmission tables (counterpart of
iron_tpu/shading/tables.py).

The tables are data, the port's own copy of the JAX package's
`iron_tpu/assets/ggx/*.txt` in `iron_tpu_torch/assets/ggx/`.  Lookup:
warpedCos = dot^0.25, warpedAlpha = (alpha/4)^0.25; T12 index =
floor(wAlpha*50)*100 + floor(wCos*100), clamped, value clamped to [0, 1];
Fdr = clamp(1 - diff_table[floor(wAlpha*50)], 0, 1).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from iron_tpu_torch import resolve_device

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "assets", "ggx")

NUM_THETA_SAMPLES = 100
NUM_ALPHA_SAMPLES = 50


@functools.lru_cache(maxsize=None)
def _load(name: str, device: str) -> torch.Tensor:
    """The table on `device`, read once per process and device."""
    return torch.as_tensor(np.loadtxt(os.path.join(ASSET_DIR, name)).astype(np.float32),
                           device=device)


def _table(name: str, like: torch.Tensor) -> torch.Tensor:
    return _load(name, str(like.device))


def mts_trans_table(device="cuda") -> torch.Tensor:
    """5000-entry external-IOR transmission table (a copy), on the CUDA
    device unless device="cpu"."""
    return _load("ext_mts_rtrans_data.txt", str(resolve_device(device))).clone()


def mts_diff_trans_table(device="cuda") -> torch.Tensor:
    """50-entry internal diffuse transmission table (a copy), on the CUDA
    device unless device="cpu"."""
    return _load("int_mts_diff_rtrans_data.txt", str(resolve_device(device))).clone()


def lookup_T12(dot: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """T12 transmission factor, shapes [..., 1]."""
    table = _table("ext_mts_rtrans_data.txt", dot)
    warped_cos = dot ** 0.25
    warped_alpha = (alpha / 4.0) ** 0.25
    tx = torch.floor(warped_cos * NUM_THETA_SAMPLES).to(torch.int64)
    ty = torch.floor(warped_alpha * NUM_ALPHA_SAMPLES).to(torch.int64)
    t_idx = torch.clamp(ty * NUM_THETA_SAMPLES + tx, 0, table.shape[0] - 1)
    return torch.clamp(table[t_idx], 0.0, 1.0)


def lookup_Fdr(alpha: torch.Tensor) -> torch.Tensor:
    """Internal diffuse reflectance Fdr."""
    table = _table("int_mts_diff_rtrans_data.txt", alpha)
    warped_alpha = (alpha / 4.0) ** 0.25
    t_idx = torch.clamp(torch.floor(warped_alpha * NUM_ALPHA_SAMPLES).to(torch.int64),
                        0, table.shape[0] - 1)
    return torch.clamp(1.0 - table[t_idx], 0.0, 1.0)
