"""Implicit-function reparameterisation of sphere-traced hit points
(counterpart of iron_tpu/surface/reparam.py):

    p_diff = p - d / <grad, d> * (f(p) - detach(f(p)))

has the value p and carries df/dtheta into dp/dtheta without differentiating
the tracer loop.
"""
from __future__ import annotations

import torch


def reparam_points(nondiff_points: torch.Tensor, nondiff_grads: torch.Tensor,
                   nondiff_trgt_dirs: torch.Tensor, diff_sdf_vals: torch.Tensor) -> torch.Tensor:
    """points / grads / dirs [..., 3]; diff_sdf_vals [..., 1]."""
    dot = torch.sum(nondiff_grads * nondiff_trgt_dirs, dim=-1, keepdim=True)
    dot = torch.clamp(dot, min=1e-4)
    return nondiff_points - nondiff_trgt_dirs / dot * (diff_sdf_vals - diff_sdf_vals.detach())
