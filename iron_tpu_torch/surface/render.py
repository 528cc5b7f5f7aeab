"""Surface render: camera trace -> hole filling -> edge location -> shading ->
two-sided edge compositing (counterpart of iron_tpu/surface/render.py, its
evaluation path: `is_training=False`).

As in the JAX package, nothing is compacted by boolean indexing: the tracer
and shader run on the full pixel set under masks, and the edge pipeline runs
on a static budget of K candidates chosen by `budget_select`.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from iron_tpu_torch.core.camera import Camera, camera_origin, get_rays, pixel_grid, project
from iron_tpu_torch.core.rays import intersect_sphere
from iron_tpu_torch.surface.morphology import closing3x3, sobel_magnitude
from iron_tpu_torch.surface.tracer import TracerConfig, budget_select, raytrace


@dataclass(frozen=True)
class SurfaceRenderConfig:
    tracer: TracerConfig = field(default_factory=TracerConfig)
    fill_holes: bool = True
    handle_edges: bool = True
    edge_budget: int = 1024          # static max edge candidates per render
    edge_walk_steps: int = 16
    edge_step_size: float = 1e-3
    # step = max(edge_step_size, edge_step_px * depth / focal); 0 = absolute step
    edge_step_px: float = 0.75
    edge_dot_threshold: float = 5e-2
    depth_edge_threshold: float = 1e-2
    hole_depth_threshold: float = 1e-2
    edge_side_fallback_budget: int = 512
    # static cap on interior pixels shaded; None = always the full tile
    interior_budget: Optional[int] = None


def scale_config_for_resolution(cfg: SurfaceRenderConfig, H: int, W: int,
                                train_patch: int = 128) -> SurfaceRenderConfig:
    """Scale the static edge budget with the image side (silhouettes are
    curves), so a full-image render is not budget-capped."""
    scale = max(1, int(np.ceil((H + W) / (2.0 * train_patch))))
    if scale == 1:
        return cfg
    return dataclasses.replace(cfg, edge_budget=cfg.edge_budget * scale)


def raytrace_pixels(sdf_fn, cam: Camera, uv: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    cfg: SurfaceRenderConfig = SurfaceRenderConfig(),
                    coarse_sdf_fn=None, coarse_march_fn=None) -> Dict:
    """Trace the rays through pixel coordinates uv [..., 2]."""
    ray_o, ray_d, ray_d_norm = get_rays(cam, uv)
    mask_int, min_dis, max_dis = intersect_sphere(ray_o, ray_d, r=1.0)
    work = mask_int if mask is None else (mask_int & mask)
    res = raytrace(sdf_fn, ray_o, ray_d, min_dis, max_dis, work, cfg.tracer,
                   coarse_sdf_fn=coarse_sdf_fn, coarse_march_fn=coarse_march_fn)
    res["depth"] = res["distance"] / ray_d_norm
    res.update({"uv": uv, "ray_o": ray_o, "ray_d": ray_d, "ray_d_norm": ray_d_norm})
    return res


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-10)


def locate_edge_points(sdf_all_fn, cam: Camera, start_points: torch.Tensor,
                       seed_valid: torch.Tensor, cfg: SurfaceRenderConfig) -> Dict:
    """Walk K seed points [K, 3] along the surface to the silhouette, masked
    and fixed-shape.  Returns the found mask, walked points and their
    projections."""
    cam_o = camera_origin(cam)
    focal = 0.5 * (cam.K[0, 0].abs() + cam.K[1, 1].abs())
    pts = start_points
    found = torch.zeros(start_points.shape[:1], dtype=torch.bool, device=pts.device)
    for _ in range(cfg.edge_walk_steps):
        viewdir = cam_o - pts
        dist = torch.linalg.norm(viewdir, dim=-1, keepdim=True)
        viewdir = viewdir / (dist + 1e-10)
        sdf, _, grad = sdf_all_fn(pts)
        normal = _normalize(grad)
        dot = torch.sum(normal * viewdir, dim=-1)
        found = found | (dot.abs() <= cfg.edge_dot_threshold)
        walkdir = _normalize(normal - viewdir / dot[..., None])
        walkdir = walkdir - sdf[..., None] * normal
        if cfg.edge_step_px > 0:
            step_size = torch.clamp(cfg.edge_step_px * dist / focal, min=cfg.edge_step_size)
        else:
            step_size = cfg.edge_step_size
        active = seed_valid & ~found
        pts = torch.where(active[..., None], pts + step_size * walkdir, pts)
    if cfg.edge_step_px > 0:
        # Newton-project the walked points back onto the zero level set
        for _ in range(2):
            p_sdf, _, p_grad = sdf_all_fn(pts)
            pts = pts - p_sdf[..., None] * _normalize(p_grad)
    viewdir = _normalize(cam_o - pts)
    _, _, grad = sdf_all_fn(pts)
    found = found | (torch.sum(_normalize(grad) * viewdir, dim=-1).abs()
                     <= cfg.edge_dot_threshold)
    found = found & seed_valid
    return {"walk_points": pts, "walk_found": found, "walk_uv": project(cam, pts)}


def _dedupe_per_pixel(cam: Camera, walk: Dict) -> Dict:
    """One candidate per pixel, keeping the first: a scatter-min of the
    candidate index with an overflow slot (index H*W) for invalid ones."""
    H, W = cam.H, cam.W
    K = walk["walk_points"].shape[0]
    dev = walk["walk_points"].device
    pix = torch.floor(walk["walk_uv"]).to(torch.int32)
    pid = (pix[:, 1] * W + pix[:, 0]).to(torch.int64)
    valid = walk["walk_found"] & (pid >= 0) & (pid < H * W)
    slot_idx = torch.where(valid, pid, H * W)
    ar = torch.arange(K, dtype=torch.int64, device=dev)
    slots = torch.full((H * W + 1,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                       device=dev)
    slots.scatter_reduce_(0, slot_idx, ar, reduce="amin")
    kept = valid & (slots[slot_idx] == ar)
    edge_mask = torch.zeros((H * W + 1,), dtype=torch.bool, device=dev)
    edge_mask[slot_idx[kept]] = True
    return {"edge_kept": kept, "edge_pid": pid, "edge_mask_flat": edge_mask[:H * W]}


def shade_masked(sdf_all_fn, shade_fn, ray_o, ray_d, points, mask) -> Dict:
    """Fresh SDF forward at the points, user shading, every buffer masked;
    the unnormalised gradient is kept as "raw_grad"."""
    sdf, feature, grad = sdf_all_fn(points)
    out = shade_fn(ray_o, ray_d, points, grad, feature)
    masked = {}
    for k, v in out.items():
        m = mask if v.ndim == mask.ndim else mask[..., None]
        masked[k] = torch.where(m, v, 0.0)
    masked["raw_grad"] = torch.where(mask[..., None], grad, 0.0)
    return masked


def _scatter_rows(img_flat: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                  m: torch.Tensor) -> torch.Tensor:
    """img_flat with rows idx[m] set to vals[m]."""
    out = img_flat.clone()
    out[idx[m]] = vals[m].to(out.dtype)
    return out


def render_camera(sdf_fn, sdf_all_fn, shade_fn, cam: Camera,
                  cfg: SurfaceRenderConfig = SurfaceRenderConfig(),
                  debug: bool = False, trace_sdf_fn=None, trace_sdf_all_fn=None,
                  coarse_sdf_fn=None, coarse_march_fn=None) -> Dict:
    """The evaluation surface render of one camera; [H, W, ...] buffers and
    edge diagnostics.  sdf_fn: pts -> sdf; sdf_all_fn: pts -> (sdf, feat,
    grad); shade_fn: (ray_o, ray_d, points, normals, features) -> buffers.
    trace_sdf_fn / trace_sdf_all_fn serve the trace and the edge walk,
    coarse_sdf_fn / coarse_march_fn the coarse-to-fine march."""
    trace_sdf_fn = trace_sdf_fn or sdf_fn
    trace_sdf_all_fn = trace_sdf_all_fn or sdf_all_fn
    H, W = cam.H, cam.W
    uv = pixel_grid(H, W, device=cam.device)
    res = raytrace_pixels(trace_sdf_fn, cam, uv, cfg=cfg, coarse_sdf_fn=coarse_sdf_fn,
                          coarse_march_fn=coarse_march_fn)
    res["depth"] = res["depth"] * res["convergent_mask"]

    if cfg.fill_holes:
        depth = closing3x3(res["depth"])
        new_conv = depth > cfg.hole_depth_threshold
        update = new_conv & ~res["convergent_mask"]
        res["depth"] = torch.where(update, depth, res["depth"])
        res["convergent_mask"] = res["convergent_mask"] | new_conv
        res["distance"] = torch.where(update, res["depth"] * res["ray_d_norm"], res["distance"])
        res["points"] = torch.where(update[..., None],
                                    res["ray_o"] + res["ray_d"] * res["distance"][..., None],
                                    res["points"])

    # pixel-centre coverage, before edge pixels are carved out below
    res["hit_mask"] = res["convergent_mask"]

    edge = None
    if cfg.handle_edges:
        grad_mag = sobel_magnitude(res["depth"])
        depth_edge_mask = (grad_mag > cfg.depth_edge_threshold) & res["convergent_mask"]
        if debug:
            res["depth_grad_norm"] = grad_mag
            res["depth_edge_mask"] = depth_edge_mask
        n_seeds = depth_edge_mask.sum()
        res["edge_seed_count"] = n_seeds
        res["edge_seeds_dropped"] = torch.clamp(n_seeds - cfg.edge_budget, min=0)
        flat = depth_edge_mask.reshape(-1)
        sel = budget_select(flat, cfg.edge_budget)
        walk = locate_edge_points(trace_sdf_all_fn, cam, res["points"].reshape(-1, 3)[sel],
                                  flat[sel], cfg)
        dd = _dedupe_per_pixel(cam, walk)
        edge = {**walk, **dd}
        res["edge_mask"] = dd["edge_mask_flat"].reshape(H, W)
        res["convergent_mask"] = res["convergent_mask"] & ~res["edge_mask"]
    else:
        res["edge_mask"] = torch.zeros((H, W), dtype=torch.bool, device=cam.device)

    # ---- interior shading ----
    B = cfg.interior_budget
    flat_mask = res["convergent_mask"].reshape(-1)
    if B is not None and B < H * W and int(flat_mask.sum()) <= B:
        sel = budget_select(flat_mask, B)
        valid = flat_mask[sel]
        sh = shade_masked(sdf_all_fn, shade_fn, res["ray_o"].reshape(-1, 3)[sel],
                          res["ray_d"].reshape(-1, 3)[sel], res["points"].reshape(-1, 3)[sel],
                          valid)
        shaded = {}
        for k, v in sh.items():
            buf = v.new_zeros((H * W,) + v.shape[1:])
            shaded[k] = _scatter_rows(buf, sel, v, valid).reshape((H, W) + v.shape[1:])
    else:
        shaded = shade_masked(sdf_all_fn, shade_fn, res["ray_o"], res["ray_d"],
                              res["points"], res["convergent_mask"])
    res.update(shaded)

    # ---- edge pixels: two-sided trace + shade, circle-coverage composite ----
    if cfg.handle_edges:
        kept = edge["edge_kept"]
        epts = edge["walk_points"]
        pid = torch.clamp(edge["edge_pid"], 0, H * W - 1)

        e_sdf, _, e_grad = sdf_all_fn(epts)
        e_normal = _normalize(e_grad)
        edge_uv = edge["walk_uv"]
        pixel_center = torch.floor(edge_uv) + 0.5

        n2d = _normalize((e_normal @ cam.W2C[:3, :3].T)[:, :2])
        pixel_radius = 0.707
        pos_uv = pixel_center - pixel_radius * n2d
        neg_uv = pixel_center + pixel_radius * n2d
        dot2d = torch.sum((edge_uv - pixel_center) * n2d, dim=-1)
        ang = 2.0 * torch.arccos(torch.clamp(dot2d / pixel_radius, 0.0, 1.0 - 1e-6))
        pos_w = 1.0 - (ang - torch.sin(ang)) / (2.0 * math.pi)

        # both sides as one batched [2K] trace + shade; the fallback budget
        # doubles so per-side semantics are unchanged
        side_cfg = dataclasses.replace(cfg, tracer=dataclasses.replace(
            cfg.tracer, fallback_budget=2 * cfg.edge_side_fallback_budget))
        Kn = pos_uv.shape[0]
        kept2 = torch.cat([kept, kept], dim=0)
        r2 = raytrace_pixels(trace_sdf_fn, cam, torch.cat([pos_uv, neg_uv], dim=0),
                             mask=kept2, cfg=side_cfg, coarse_sdf_fn=coarse_sdf_fn,
                             coarse_march_fn=coarse_march_fn)
        s2 = shade_masked(sdf_all_fn, shade_fn, r2["ray_o"], r2["ray_d"], r2["points"],
                          r2["convergent_mask"] & kept2)
        split = lambda d, lo, hi: {k: v[lo:hi] for k, v in d.items()}
        pos_res, neg_res = split(r2, 0, Kn), split(r2, Kn, 2 * Kn)
        pos_shade, neg_shade = split(s2, 0, Kn), split(s2, Kn, 2 * Kn)

        edge_color = (pos_shade["color"] * pos_w[..., None]
                      + neg_shade["color"] * (1.0 - pos_w[..., None]))

        def scatter(img_flat, vals):
            return _scatter_rows(img_flat, pid, vals, kept)

        res["color"] = scatter(res["color"].reshape(H * W, 3), edge_color).reshape(H, W, 3)
        res["normal"] = scatter(res["normal"].reshape(H * W, 3), e_grad).reshape(H, W, 3)
        res["raw_grad"] = scatter(res["raw_grad"].reshape(H * W, 3), e_grad).reshape(H, W, 3)

        res["edge_pos_neg_normal"] = torch.cat([pos_shade["raw_grad"], neg_shade["raw_grad"]])
        res["edge_pos_neg_mask"] = torch.cat([pos_res["convergent_mask"] & kept,
                                              neg_res["convergent_mask"] & kept])
        res["edge_uv"] = edge_uv
        res["edge_points"] = epts
        res["edge_kept"] = kept
        res["edge_pos_weight"] = pos_w

        if debug:
            dev = epts.device
            zero = torch.zeros((H * W,), device=dev)
            zero3 = torch.zeros((H * W, 3), device=dev)
            res["edge_pos_side_weight"] = scatter(zero, pos_w).reshape(H, W)
            res["edge_pos_side_depth"] = scatter(zero, pos_res["depth"]).reshape(H, W)
            res["edge_neg_side_depth"] = scatter(zero, neg_res["depth"]).reshape(H, W)
            res["edge_pos_side_color"] = scatter(zero3, pos_shade["color"]).reshape(H, W, 3)
            res["edge_neg_side_color"] = scatter(zero3, neg_shade["color"]).reshape(H, W, 3)
            dots = torch.sum(e_normal * _normalize(cam.C2W[:3, 3] - epts), dim=-1)
            res["edge_angles"] = scatter(
                zero, torch.rad2deg(torch.arccos(torch.clamp(dots, -1.0, 1.0)))).reshape(H, W)
            res["edge_sdf"] = scatter(zero, e_sdf).reshape(H, W)

    return res
