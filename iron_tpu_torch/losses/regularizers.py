"""Geometry and material regularisers (counterpart of
iron_tpu/losses/regularizers.py): the eikonal term, the roughness hinge, the
metal eta/k and dielectric eta priors and the mask BCE, all as masked
fixed-shape means."""
from __future__ import annotations

from typing import Optional

import torch


def eikonal_loss(grads: torch.Tensor, mask: Optional[torch.Tensor] = None):
    """(sum((|g| - 1)^2 * mask), count), so that callers can pool several
    gradient sources before dividing."""
    err = (torch.linalg.norm(grads, dim=-1) - 1.0) ** 2
    if mask is None:
        return torch.sum(err), err.numel()
    m = mask.to(err.dtype)
    return torch.sum(err * m), torch.sum(m)


def roughness_range_loss(roughness: torch.Tensor, mask: torch.Tensor,
                         threshold: float = 0.5) -> torch.Tensor:
    """Hinge mean over the mask of (roughness - threshold)+."""
    m = mask.to(roughness.dtype)
    over = torch.clamp(roughness - threshold, min=0.0) * m
    valid = (over > 0).to(roughness.dtype)
    return torch.sum(over) / torch.clamp(torch.sum(valid), min=1.0)


def metal_eta_k_loss(metal_eta: torch.Tensor, metal_k: torch.Tensor, mask: torch.Tensor,
                     eta_value: float = 1.0, k_value: float = 10.0):
    """|eta - eta_value| over eta > eta_value, and the same for k."""
    m = mask.to(metal_eta.dtype)
    e_on = (metal_eta > eta_value).to(metal_eta.dtype) * m
    k_on = (metal_k > k_value).to(metal_k.dtype) * m
    e_over = torch.abs(metal_eta - eta_value) * e_on
    k_over = torch.abs(metal_k - k_value) * k_on
    return (torch.sum(e_over) / torch.clamp(torch.sum(e_on), min=1.0),
            torch.sum(k_over) / torch.clamp(torch.sum(k_on), min=1.0))


def dielectric_eta_loss(dielectric_eta: torch.Tensor, mask: torch.Tensor,
                        target: float = 1.5) -> torch.Tensor:
    m = mask.to(dielectric_eta.dtype)
    return torch.sum(torch.abs(dielectric_eta - target) * m) / torch.clamp(torch.sum(m), min=1.0)


def mask_bce_loss(weight_sum: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """BCE(clip(weight_sum), mask)."""
    w = torch.clamp(weight_sum, 1e-3, 1.0 - 1e-3)
    m = mask.to(w.dtype)
    return -torch.mean(m * torch.log(w) + (1.0 - m) * torch.log(1.0 - w))
