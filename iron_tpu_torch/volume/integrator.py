"""NeuS volume rendering: SDF -> section alpha -> transmittance compositing,
with the inverted-sphere background NeRF blended in (counterpart of
iron_tpu/volume/integrator.py).

  * `neus_render`: n_samples uniform z with an optional per-ray jitter,
    `up_sample_steps` importance rounds (inv_s = 64 * 2^i) without a graph,
    background z from an inverted distribution beyond the sphere;
  * `render_core_outside`: the NeRF on (x/r, 1/r), softplus density ->
    alpha, transmittance weights;
  * `render_core`: section-estimated prev/next SDF with cos annealing,
    alpha = clip((sig(prev s) - sig(next s) + eps) / (sig(prev s) + eps)),
    the background blended in outside the sphere, cumprod transmittance, the
    eikonal error over the points inside radius 1.2.

Randomness: with perturb > 0 the per-ray jitter t_rand [B, 1] (in
[-0.5, 0.5)) and the background jitter t_rand_outside [B, n_outside] (in
[0, 1)) are the tensors passed in, or are drawn from `generator`; JAX's
draws can be injected so.  The shapes are static and nothing syncs the
host.

Callbacks:
  sdf_fn:     pts [..., 3] -> sdf [...] (called without a graph)
  sdf_all_fn: pts [..., 3] -> (sdf [...], feat [..., F], grad [..., 3])
  color_fn:   (pts, grads, dirs, feat) -> rgb [..., 3]
  nerf_fn:    (pts4 [..., 4], dirs [..., 3]) -> (density [..., 1], rgb [..., 3])
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from iron_tpu_torch.surface.tracer import linspace01
from iron_tpu_torch.volume.sampling import cat_z_vals, transmittance, up_sample


@dataclass(frozen=True)
class NeuSRenderConfig:
    n_samples: int = 64
    n_importance: int = 64
    n_outside: int = 32
    up_sample_steps: int = 4
    perturb: float = 1.0


def _uniform(shape, generator, like: torch.Tensor) -> torch.Tensor:
    if generator is None:
        raise ValueError("perturb > 0 needs t_rand / t_rand_outside or a generator")
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def nerf_density_render(rays_o, rays_d, near, far, nerf_fn: Callable, n_samples: int,
                        background_dist: float = 0.0, background_rgb=None,
                        t_rand: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Plain density-field volume rendering over unit-normalised sample
    positions: uniform z (jittered by t_rand [B, 1] in [-0.5, 0.5) when
    given), softplus(density) -> alpha, transmittance compositing; returns
    colour, depth map and weights."""
    batch_size = rays_o.shape[0]
    near = near.reshape(batch_size, 1)
    far = far.reshape(batch_size, 1)
    z_vals = near + (far - near) * linspace01(n_samples, rays_o.device)[None, :] + background_dist
    if t_rand is not None:
        z_vals = z_vals + t_rand * (far - near) / n_samples
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, dists[..., :1]], dim=-1)
    mid_z = z_vals + dists * 0.5

    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]
    dis = torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    dirs = rays_d[:, None, :].expand(pts.shape)
    density, sampled_color = nerf_fn(pts / dis, dirs)
    alpha = 1.0 - torch.exp(-F.softplus(density[..., 0]) * dists)
    weights = alpha * transmittance(alpha, batch_size)
    color = torch.sum(weights[..., None] * sampled_color, dim=1)
    zmap = torch.sum(weights[..., None] * z_vals[..., None], dim=1)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    return {"color": color, "sampled_color": sampled_color, "zmap": zmap, "weights": weights}


def render_core_outside(rays_o, rays_d, z_vals, sample_dist: float, nerf_fn: Callable,
                        background_rgb=None) -> Dict[str, torch.Tensor]:
    """The background model over z_vals [B, N]."""
    batch_size = z_vals.shape[0]
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5

    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]
    dis_to_center = torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / dis_to_center, 1.0 / dis_to_center], dim=-1)
    dirs = rays_d[:, None, :].expand(pts.shape)

    density, sampled_color = nerf_fn(pts4, dirs)
    alpha = 1.0 - torch.exp(-F.softplus(density[..., 0]) * dists)
    weights = alpha * transmittance(alpha, batch_size)
    color = torch.sum(weights[..., None] * sampled_color, dim=1)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    return {"color": color, "sampled_color": sampled_color, "alpha": alpha,
            "weights": weights}


def render_core(rays_o, rays_d, z_vals, sample_dist: float, sdf_all_fn: Callable,
                color_fn: Callable, inv_s: torch.Tensor, background_alpha=None,
                background_sampled_color=None, background_rgb=None,
                cos_anneal_ratio: float = 0.0) -> Dict[str, torch.Tensor]:
    """The NeuS compositing of z_vals [B, N]."""
    batch_size, n_samples = z_vals.shape
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], sample_dist)], dim=-1)
    mid_z = z_vals + dists * 0.5

    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., :, None]     # [B, N, 3]
    dirs = rays_d[:, None, :].expand(pts.shape)

    sdf, feature, gradients = sdf_all_fn(pts)
    sampled_color = color_fn(pts, gradients, dirs, feature)

    inv_s = torch.clamp(inv_s, 1e-6, 1e6)
    true_cos = torch.sum(dirs * gradients, dim=-1)                           # [B, N]
    # the anneal keeps cos "not dead" early in training
    iter_cos = -(F.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + F.relu(-true_cos) * cos_anneal_ratio)
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)

    pts_norm = torch.linalg.norm(pts, dim=-1).detach()
    inside_sphere = (pts_norm < 1.0).to(alpha.dtype)
    relax_inside = (pts_norm < 1.2).to(alpha.dtype)

    if background_alpha is not None:
        alpha = alpha * inside_sphere + background_alpha[:, :n_samples] * (1.0 - inside_sphere)
        alpha = torch.cat([alpha, background_alpha[:, n_samples:]], dim=-1)
        sampled_color = (sampled_color * inside_sphere[..., None]
                         + background_sampled_color[:, :n_samples]
                         * (1.0 - inside_sphere)[..., None])
        sampled_color = torch.cat([sampled_color, background_sampled_color[:, n_samples:]],
                                  dim=1)

    weights = alpha * transmittance(alpha, batch_size)
    weights_sum = torch.sum(weights, dim=-1, keepdim=True)
    color = torch.sum(sampled_color * weights[..., None], dim=1)
    if background_rgb is not None:
        color = color + background_rgb * (1.0 - weights_sum)

    # the eikonal mean over the points inside radius 1.2, and its sum and
    # count, which a data-parallel step reduces over the ranks before dividing
    eik_sum = torch.sum(relax_inside * (torch.linalg.norm(gradients, dim=-1) - 1.0) ** 2)
    eik_count = torch.sum(relax_inside)
    gradient_error = eik_sum / (eik_count + 1e-5)
    return {"color": color, "sdf": sdf, "dists": dists, "gradients": gradients,
            "s_val": 1.0 / inv_s, "mid_z_vals": mid_z, "weights": weights, "cdf": prev_cdf,
            "gradient_error": gradient_error, "eik_sum": eik_sum, "eik_count": eik_count,
            "inside_sphere": inside_sphere}


def neus_render(rays_o, rays_d, near, far, *, sdf_fn: Callable, sdf_all_fn: Callable,
                color_fn: Callable, inv_s: torch.Tensor, nerf_fn: Optional[Callable] = None,
                cfg: NeuSRenderConfig = NeuSRenderConfig(),
                generator: Optional[torch.Generator] = None,
                t_rand: Optional[torch.Tensor] = None,
                t_rand_outside: Optional[torch.Tensor] = None,
                background_rgb=None, cos_anneal_ratio: float = 0.0,
                perturb_overwrite: float = -1.0,
                init_z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The full NeuS render of a ray batch; near / far [B, 1] or [B].

    init_z [B, n_samples]: precomputed initial samples (occupancy-guided,
    volume/occupancy.py) in place of the uniform ladder; they take no
    per-ray jitter (they carry their own)."""
    batch_size = rays_o.shape[0]
    dev = rays_o.device
    near = near.reshape(batch_size, 1)
    far = far.reshape(batch_size, 1)
    sample_dist = 2.0 / cfg.n_samples

    if init_z is not None:
        z_vals = init_z
    else:
        z_vals = near + (far - near) * linspace01(cfg.n_samples, dev)[None, :]

    z_vals_outside = None
    if cfg.n_outside > 0:
        z_vals_outside = torch.linspace(1e-3, 1.0 - 1.0 / (cfg.n_outside + 1.0), cfg.n_outside,
                                        device=dev)

    perturb = cfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    if perturb > 0:
        if init_z is None:
            if t_rand is None:
                t_rand = _uniform((batch_size, 1), generator, rays_o) - 0.5
            z_vals = z_vals + t_rand * 2.0 / cfg.n_samples
        if cfg.n_outside > 0:
            mids = 0.5 * (z_vals_outside[1:] + z_vals_outside[:-1])
            upper = torch.cat([mids, z_vals_outside[-1:]])
            lower = torch.cat([z_vals_outside[:1], mids])
            if t_rand_outside is None:
                t_rand_outside = _uniform((batch_size, cfg.n_outside), generator, rays_o)
            z_vals_outside = lower[None, :] + (upper - lower)[None, :] * t_rand_outside

    if cfg.n_outside > 0:
        z_vals_outside = z_vals_outside.expand(batch_size, cfg.n_outside)
        z_vals_outside = far / torch.flip(z_vals_outside, dims=[-1]) + 1.0 / cfg.n_samples

    if cfg.n_importance > 0:
        # importance sampling takes no gradients (renderer.py:389)
        with torch.no_grad():
            pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., :, None]
            sdf = sdf_fn(pts)
            for i in range(cfg.up_sample_steps):
                new_z = up_sample(rays_o, rays_d, z_vals, sdf,
                                  cfg.n_importance // cfg.up_sample_steps, 64 * 2 ** i)
                if i + 1 < cfg.up_sample_steps:
                    new_pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z[..., :, None]
                    z_vals, sdf = cat_z_vals(z_vals, new_z, sdf, sdf_fn(new_pts))
                else:
                    z_vals, _ = cat_z_vals(z_vals, new_z, None, None)

    background_alpha = background_sampled_color = None
    if cfg.n_outside > 0:
        z_feed = torch.sort(torch.cat([z_vals, z_vals_outside], dim=-1), dim=-1).values
        ret_out = render_core_outside(rays_o, rays_d, z_feed, sample_dist, nerf_fn)
        background_sampled_color = ret_out["sampled_color"]
        background_alpha = ret_out["alpha"]

    ret = render_core(rays_o, rays_d, z_vals, sample_dist, sdf_all_fn, color_fn, inv_s,
                      background_alpha=background_alpha,
                      background_sampled_color=background_sampled_color,
                      background_rgb=background_rgb, cos_anneal_ratio=cos_anneal_ratio)
    weights = ret["weights"]
    s_val = ret["s_val"].expand(batch_size, 1)
    return {"color_fine": ret["color"], "s_val": s_val, "cdf_fine": ret["cdf"],
            "weight_sum": torch.sum(weights, dim=-1, keepdim=True),
            "weight_max": torch.max(weights, dim=-1, keepdim=True).values,
            "gradients": ret["gradients"], "weights": weights,
            "gradient_error": ret["gradient_error"], "eik_sum": ret["eik_sum"],
            "eik_count": ret["eik_count"], "inside_sphere": ret["inside_sphere"], "z_vals": z_vals}
