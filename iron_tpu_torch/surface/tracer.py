"""Masked sphere tracer with a dense-sampling fallback and bisection root
refinement (counterpart of iron_tpu/surface/tracer.py).

Every step runs on the full ray set under a live mask, as in the JAX
package, so results match it ray for ray.  The JAX `lax.while_loop`s become
Python loops that stop when no ray is active: one host sync per iteration.
The tracer never needs gradients; callers run it under `torch.no_grad()`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class TracerConfig:
    sdf_threshold: float = 5.0e-5
    sphere_tracing_iters: int = 48
    n_steps: int = 128          # dense fallback samples
    max_bisection_iters: int = 24
    fallback_budget: Optional[int] = 1024
    dense_iters: int = 24
    coarse_threshold: float = 2.0e-2
    refine_iters: int = 2
    coarse_dense_iters: int = 12
    coarse_straggler_iters: int = 28
    fallback_revalidate_margin: float = 2.5e-2
    fallback_coarse: bool = True


def linspace01(n: int, device) -> torch.Tensor:
    """n points over [0, 1] as i * f32(1/(n-1)): the JAX package's linspace
    bit for bit (torch.linspace rounds some entries differently)."""
    return torch.arange(n, dtype=torch.float32, device=device) * np.float32(1.0 / (n - 1))


def budget_select(flat_mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of up to k True entries of flat_mask, spatially interleaved
    by a golden-ratio stride permutation, then a stable sort by mask.

    The permutation is computed as the JAX package computes it, in int32:
    i * stride wraps around 2**31 when n * stride does, which for a size
    that is not a power of two above about 59,000 makes the permutation
    repeat indices.  The wrap is kept so that both packages select the same
    rays."""
    n = flat_mask.shape[0]
    stride = max(int(n * 0.6180339887) | 1, 1)
    while np.gcd(stride, n) != 1:
        stride += 2
    prod = torch.arange(n, dtype=torch.int64, device=flat_mask.device) * stride
    prod = torch.remainder(prod + 2 ** 31, 2 ** 32) - 2 ** 31      # int32 wrap
    perm = torch.remainder(prod, n)
    key = torch.where(flat_mask[perm], 0, 1)
    order = torch.argsort(key, stable=True)
    return perm[order[:k]]


def _trace_loop(sdf_fn, ray_o, ray_d, max_dis, active, acc, s, n_iters, threshold):
    """Masked sphere-trace iterations."""
    for _ in range(n_iters):
        if not bool(active.any()):
            break
        acc = acc + torch.where(active, s, 0.0)
        s = torch.where(active, sdf_fn(ray_o + ray_d * acc[..., None]), s)
        active = active & (s.abs() > threshold) & (acc < max_dis)
    return active, acc, s


def _budgeted_trace(sdf_fn, ray_o, ray_d, max_dis, active, acc_dis, sdf_val,
                    n_iters: int, threshold: float, budget: Optional[int]):
    """Gather up to `budget` active rays, run n_iters masked steps on them,
    scatter back."""
    shape = active.shape
    n_rays = int(np.prod(shape))
    if budget is None or budget >= n_rays:
        return _trace_loop(sdf_fn, ray_o, ray_d, max_dis, active, acc_dis, sdf_val,
                           n_iters, threshold)
    act_f = active.reshape(-1)
    sel = budget_select(act_f, budget)
    valid = act_f[sel]
    md_s = torch.broadcast_to(max_dis, shape).reshape(-1)[sel]
    acc_f, s_f = acc_dis.reshape(-1), sdf_val.reshape(-1)
    a_s, acc_s, s_s = _trace_loop(sdf_fn, ray_o.reshape(-1, 3)[sel],
                                  ray_d.reshape(-1, 3)[sel], md_s, valid,
                                  acc_f[sel], s_f[sel], n_iters, threshold)
    act_f, acc_f, s_f = act_f.clone(), acc_f.clone(), s_f.clone()
    act_f[sel] = torch.where(valid, a_s, valid)
    acc_f[sel] = torch.where(valid, acc_s, acc_f[sel])
    s_f[sel] = torch.where(valid, s_s, s_f[sel])
    return act_f.reshape(shape), acc_f.reshape(shape), s_f.reshape(shape)


def sphere_trace(sdf_fn: Callable, ray_o, ray_d, min_dis, max_dis, work_mask,
                 cfg: TracerConfig = TracerConfig(),
                 coarse_sdf_fn: Optional[Callable] = None,
                 coarse_march_fn: Optional[Callable] = None):
    """Two-phase masked sphere tracing; coarse-to-fine when a coarse
    evaluator is given (the coarse march to cfg.coarse_threshold, then
    accurate re-evaluation and polish).  Returns (convergent, unfinished,
    points, sdf, distance), all full shape."""
    acc_dis = min_dis
    pts = ray_o + ray_d * acc_dis[..., None]

    def unfinished(mask, s, d):
        return mask & (s.abs() > cfg.sdf_threshold) & (d < max_dis)

    if coarse_march_fn is not None or coarse_sdf_fn is not None:
        cd = min(cfg.coarse_dense_iters, cfg.sphere_tracing_iters)
        cs = min(cfg.coarse_straggler_iters, max(cfg.sphere_tracing_iters - cd, 0))
        refine = min(cfg.refine_iters, max(cfg.sphere_tracing_iters - cd, 0))
        if coarse_march_fn is not None:
            _, acc_dis, _ = coarse_march_fn(ray_o, ray_d, acc_dis, work_mask, max_dis, cd + cs)
        else:
            s_c = coarse_sdf_fn(pts)
            active_c = work_mask & (s_c.abs() > cfg.coarse_threshold) & (acc_dis < max_dis)
            active_c, acc_dis, s_c = _trace_loop(coarse_sdf_fn, ray_o, ray_d, max_dis,
                                                 active_c, acc_dis, s_c, cd,
                                                 cfg.coarse_threshold)
            if cs > 0:
                _, acc_dis, _ = _budgeted_trace(coarse_sdf_fn, ray_o, ray_d, max_dis,
                                                active_c, acc_dis, s_c, cs,
                                                cfg.coarse_threshold, cfg.fallback_budget)
        sdf_val = sdf_fn(ray_o + ray_d * acc_dis[..., None])
        active = unfinished(work_mask, sdf_val, acc_dis)
        active, acc_dis, sdf_val = _trace_loop(sdf_fn, ray_o, ray_d, max_dis, active,
                                               acc_dis, sdf_val, refine, cfg.sdf_threshold)
        phase1 = cd + refine
    else:
        sdf_val = sdf_fn(pts)
        active0 = unfinished(work_mask, sdf_val, acc_dis)
        phase1 = min(cfg.dense_iters, cfg.sphere_tracing_iters)
        active, acc_dis, sdf_val = _trace_loop(sdf_fn, ray_o, ray_d, max_dis, active0,
                                               acc_dis, sdf_val, phase1, cfg.sdf_threshold)

    rem = max(cfg.sphere_tracing_iters - phase1, 0)
    if rem > 0:
        active, acc_dis, sdf_val = _budgeted_trace(sdf_fn, ray_o, ray_d, max_dis, active,
                                                   acc_dis, sdf_val, rem, cfg.sdf_threshold,
                                                   cfg.fallback_budget)

    pts = ray_o + ray_d * acc_dis[..., None]
    convergent = (work_mask & ~active & (sdf_val.abs() <= cfg.sdf_threshold)
                  & (acc_dis < max_dis))
    return convergent, active, pts, sdf_val, acc_dis


def _take(a, idx):
    return torch.gather(a, -1, idx[..., None])[..., 0]


def _first_flip(tmp):
    """(min, argmin) over the last axis, first index on ties (as jnp.argmin)."""
    min_val = tmp.min(dim=-1).values
    idx = torch.argmax((tmp == min_val[..., None]).to(torch.int8), dim=-1)
    return min_val, idx


def ray_sampler(sdf_fn: Callable, ray_o, ray_d, min_dis, max_dis, work_mask,
                cfg: TracerConfig = TracerConfig(),
                coarse_sdf_fn: Optional[Callable] = None):
    """Dense fallback sampling and first-sign-flip bracket, then bisection.
    With `coarse_sdf_fn` the sweep runs on the coarse evaluator and the flip
    is re-located in an accurate window (with a second candidate beyond
    it).  Returns (rootfind_mask, points, sdf, distance)."""
    dev = ray_o.device
    t = linspace01(cfg.n_steps, dev)
    intervals = min_dis[..., None] + t * (max_dis - min_dis)[..., None]   # [..., S]
    pts = ray_o[..., None, :] + ray_d[..., None, :] * intervals[..., None]
    sweep_fn = coarse_sdf_fn if coarse_sdf_fn is not None else sdf_fn
    sdf_val = sweep_fn(pts)

    rev = torch.arange(cfg.n_steps, 0, -1, dtype=sdf_val.dtype, device=dev)
    tmp = torch.sign(sdf_val) * rev
    min_val, min_idx = _first_flip(tmp)
    rootfind_mask = work_mask & (min_val < 0.0) & (min_idx >= 1)

    if coarse_sdf_fn is not None:
        Wn = 8
        spacing = (max_dis - min_dis) / (cfg.n_steps - 1)
        margin = torch.clamp(2.0 * spacing, min=cfg.fallback_revalidate_margin)
        tw = linspace01(Wn, dev)
        rev_w = torch.arange(Wn, 0, -1, dtype=torch.float32, device=dev)

        def revalidate(flip_idx):
            z_flip = _take(intervals, torch.clamp(flip_idx, 1, cfg.n_steps - 1))
            z_w = (z_flip - margin)[..., None] + tw * (2.0 * margin)[..., None]
            z_w = torch.minimum(torch.maximum(z_w, min_dis[..., None]), max_dis[..., None])
            p_w = ray_o[..., None, :] + ray_d[..., None, :] * z_w[..., None]
            f_w = sdf_fn(p_w)
            tmp_w = torch.sign(f_w) * rev_w
            w_min, w_min_idx = _first_flip(tmp_w)
            ok = (w_min < 0.0) & (w_min_idx >= 1)
            w_idx = torch.clamp(w_min_idx, 1, Wn - 1)
            return ok, (_take(z_w, w_idx - 1), _take(z_w, w_idx),
                        _take(f_w, w_idx - 1), _take(f_w, w_idx))

        ok1, br1 = revalidate(min_idx)
        margin_idx = torch.ceil(margin / torch.clamp(spacing, min=1e-12)).to(torch.int64)
        beyond = torch.arange(cfg.n_steps, device=dev) > (min_idx + margin_idx)[..., None]
        tmp2 = torch.where(beyond, tmp, torch.inf)
        min2, min_idx2 = _first_flip(tmp2)
        has2 = min2 < 0.0
        ok2, br2 = revalidate(min_idx2)
        ok2 = ok2 & has2
        use2 = (~ok1) & ok2
        rootfind_mask = rootfind_mask & (ok1 | use2)
        z_low, z_high, f_low, f_high = (torch.where(use2, b, a) for a, b in zip(br1, br2))
    else:
        idx = torch.clamp(min_idx, 1, cfg.n_steps - 1)
        z_low, z_high = _take(intervals, idx - 1), _take(intervals, idx)
        f_low, f_high = _take(sdf_val, idx - 1), _take(sdf_val, idx)

    p_pred, z_pred, f_pred = bisection(sdf_fn, f_low, f_high, z_low, z_high,
                                       ray_o, ray_d, rootfind_mask, cfg)
    return rootfind_mask, p_pred, f_pred, z_pred


def bisection(sdf_fn: Callable, f_low, f_high, d_low, d_high, ray_o, ray_d,
              work_mask, cfg: TracerConfig = TracerConfig()):
    """Masked bisection until the bracket is below 2 * sdf_threshold."""
    w = work_mask & (f_low > 0) & (f_high < 0)
    for _ in range(cfg.max_bisection_iters):
        if not bool(w.any()):
            break
        d_mid = 0.5 * (d_low + d_high)
        f_mid = sdf_fn(ray_o + ray_d * d_mid[..., None])
        go_low = f_mid > 0
        d_low = torch.where(w & go_low, d_mid, d_low)
        f_low = torch.where(w & go_low, f_mid, f_low)
        d_high = torch.where(w & ~go_low, d_mid, d_high)
        f_high = torch.where(w & ~go_low, f_mid, f_high)
        w = w & ((d_high - d_low) > 2 * cfg.sdf_threshold)
    d_mid = 0.5 * (d_low + d_high)
    p_mid = ray_o + ray_d * d_mid[..., None]
    return p_mid, d_mid, sdf_fn(p_mid)


def raytrace(sdf_fn: Callable, ray_o, ray_d, min_dis, max_dis, work_mask,
             cfg: TracerConfig = TracerConfig(),
             coarse_sdf_fn: Optional[Callable] = None,
             coarse_march_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Sphere trace, then the dense fallback on up to `fallback_budget`
    unfinished rays.  Returns full-shape convergent_mask / points / sdf /
    distance."""
    convergent, unfinished, pts, sdf_val, acc_dis = sphere_trace(
        sdf_fn, ray_o, ray_d, min_dis, max_dis, work_mask, cfg,
        coarse_sdf_fn=coarse_sdf_fn, coarse_march_fn=coarse_march_fn)

    # overshoot (sdf > 0): search [acc, max]; jumped inside: search [min, acc]
    went_positive = sdf_val > 0.0
    samp_min = torch.where(went_positive, acc_dis, min_dis)
    samp_max = torch.where(went_positive, max_dis, acc_dis)

    K = cfg.fallback_budget
    n_rays = int(np.prod(work_mask.shape))
    fb_coarse = coarse_sdf_fn if cfg.fallback_coarse else None
    if K is None or K >= n_rays:
        s_conv, s_pts, s_sdf, s_dis = ray_sampler(sdf_fn, ray_o, ray_d, samp_min, samp_max,
                                                  unfinished, cfg, coarse_sdf_fn=fb_coarse)
        use = unfinished
        convergent = torch.where(use, s_conv, convergent)
        pts = torch.where(use[..., None], s_pts, pts)
        sdf_val = torch.where(use, s_sdf, sdf_val)
        acc_dis = torch.where(use, s_dis, acc_dis)
    else:
        shape = work_mask.shape
        unf_f = unfinished.reshape(-1)
        sel = budget_select(unf_f, K)
        valid = unf_f[sel]
        s_conv, s_pts, s_sdf, s_dis = ray_sampler(
            sdf_fn, ray_o.reshape(-1, 3)[sel], ray_d.reshape(-1, 3)[sel],
            samp_min.reshape(-1)[sel], samp_max.reshape(-1)[sel], valid, cfg,
            coarse_sdf_fn=fb_coarse)
        conv_f = convergent.reshape(-1).clone()
        pts_f = pts.reshape(-1, 3).clone()
        sdf_f = sdf_val.reshape(-1).clone()
        dis_f = acc_dis.reshape(-1).clone()
        conv_f[sel] = torch.where(valid, s_conv, conv_f[sel])
        pts_f[sel] = torch.where(valid[..., None], s_pts, pts_f[sel])
        sdf_f[sel] = torch.where(valid, s_sdf, sdf_f[sel])
        dis_f[sel] = torch.where(valid, s_dis, dis_f[sel])
        convergent, pts = conv_f.reshape(shape), pts_f.reshape(shape + (3,))
        sdf_val, acc_dis = sdf_f.reshape(shape), dis_f.reshape(shape)

    return {"convergent_mask": convergent, "points": pts, "sdf": sdf_val,
            "distance": acc_dis}
