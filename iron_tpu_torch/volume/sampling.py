"""Hierarchical sampling along rays: inverse-CDF resampling and NeuS
importance up-sampling (counterpart of iron_tpu/volume/sampling.py).

  * `sample_pdf`: weights + 1e-5, cdf prefixed with 0, midpoint-uniform u
    (det), u drawn from a generator or u passed in, searchsorted(right),
    lerp between the bracketing bins;
  * `up_sample`: section alpha with a fixed inv_s, section cos from SDF
    differences clamped by min(prev_cos, cos) and [-1e3, 0], masked to
    sections that touch the unit sphere, transmittance weights, then
    `sample_pdf` (det);
  * `cat_z_vals`: merge and sort new samples, the SDF values carried along.
    The sort is stable, as jnp.argsort is: the deterministic `sample_pdf`
    returns tied z values on flat weights, and an unstable sort could pair a
    tied z with the other sample's SDF value.

Every shape is static; nothing here syncs the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bins [B, N + 1], weights [B, N] -> samples [B, n_samples].  det: u at
    the midpoints of n_samples equal strata; otherwise u [B, n_samples] as
    given, or drawn U[0, 1) from `generator`."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1).contiguous()   # [B, N + 1]
    B = cdf.shape[0]
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device).expand(B, n_samples)
    elif u is None:
        u = torch.rand((B, n_samples), generator=generator, dtype=cdf.dtype, device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def up_sample(rays_o: torch.Tensor, rays_d: torch.Tensor, z_vals: torch.Tensor,
              sdf: torch.Tensor, n_importance: int, inv_s: float) -> torch.Tensor:
    """One NeuS importance round.  Returns new z [B, n_importance], without
    a graph."""
    with torch.no_grad():
        batch_size = z_vals.shape[0]
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]
        radius = torch.linalg.norm(pts, dim=-1)
        inside_sphere = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)

        prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
        prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
        mid_sdf = (prev_sdf + next_sdf) * 0.5
        cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)

        prev_cos = torch.cat([torch.zeros_like(cos_val[:, :1]), cos_val[:, :-1]], dim=-1)
        cos_val = torch.minimum(prev_cos, cos_val)
        cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

        dist = next_z - prev_z
        prev_esti = mid_sdf - cos_val * dist * 0.5
        next_esti = mid_sdf + cos_val * dist * 0.5
        prev_cdf = torch.sigmoid(prev_esti * inv_s)
        next_cdf = torch.sigmoid(next_esti * inv_s)
        alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
        weights = alpha * transmittance(alpha, batch_size)
        return sample_pdf(z_vals, weights, n_importance, det=True)


class _CumprodPositive(torch.autograd.Function):
    """torch.cumprod along the last axis of an input with no zero entry.
    Its backward is cumprod's for that case, reversed_cumsum(grad * out) /
    x, without the check for zeros by which torch.cumprod's backward reads
    a device value (a host sync)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(grad * out, [-1]), dim=-1), [-1]) / x


def transmittance(alpha: torch.Tensor, batch_size: int) -> torch.Tensor:
    """T_i = prod_{j < i} (1 - alpha_j + 1e-7), [B, N], for alpha <= 1 (so
    that no factor is zero)."""
    ones = torch.ones((batch_size, 1), dtype=alpha.dtype, device=alpha.device)
    return torch.cat([ones, _CumprodPositive.apply(1.0 - alpha + 1e-7)], dim=-1)[:, :-1]


def cat_z_vals(z_vals: torch.Tensor, new_z_vals: torch.Tensor,
               sdf: Optional[torch.Tensor], new_sdf: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Merge and stably sort samples, carrying per-sample SDF values along.
    Pass new_sdf=None on the last round."""
    z_all = torch.cat([z_vals, new_z_vals], dim=-1)
    z_sorted, order = torch.sort(z_all, dim=-1, stable=True)
    if sdf is None or new_sdf is None:
        return z_sorted, None
    return z_sorted, torch.gather(torch.cat([sdf, new_sdf], dim=-1), -1, order)
