"""NeRF-style sin/cos positional encoding (counterpart of iron_tpu/core/embedder.py).

Output order: [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...], each
sin/cos block spanning all d input dims; width d * (1 + 2 * multires).
"""
from __future__ import annotations

import torch


def pe_dim(multires: int, d: int = 3) -> int:
    if multires <= 0:
        return d
    return d * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """Encode [..., d] -> [..., d*(1+2*multires)]."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]                    # [..., m, d]
    enc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
    return torch.cat([x, enc], dim=-1)
