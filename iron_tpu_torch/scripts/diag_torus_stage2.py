"""Does stage 2 keep genus-1 geometry when it starts from a near-perfect
torus?  (counterpart of scripts/diag_torus_stage2.py, with its positional
arguments and its lines).

    python -m iron_tpu_torch.scripts.diag_torus_stage2 [s2_iters] [segments] [res] [--device cuda]

Fits the SDF network (bias 0.5) to the analytic torus by regression: 4,000
Adam(1e-4) steps on 4,096 points of the cube and 4,096 points within
sigma 0.02 of the GT mesh's vertices.  Starts stage 2 (ggx, crops of
min(res, 128), 1,024 edge candidates) from that SDF on the golden
renderer's 14 views at res x res (default 256; the first 12 trained on),
and runs `s2_iters` steps (default 25,000) in `segments` segments (default
10), each followed by a geometry report (chamfer against the GT mesh,
vertex counts, the SDF along the hole's axis).  Then the recovered light,
the SDF saved as `diag_torus_s2_sdf.npy` in the temporary directory (the
JAX package's pytree of numpy leaves, allow_pickle), and the edge coverage
of view 0 rendered at 256^2 and 512^2 through the trainer's evaluators
with the resolution-scaled edge budget.  Every JSON line carries `device`.

The fitted weights are copied into the trainer's SDF module and the
trainer's optimizer is rebuilt on its parameters (`hand_over`), where the
JAX script swaps the parameter tree and re-initialises optax.  The edge
coverage renders pass the trainer's sdf / sdf_all / shade evaluators and
nothing else, as the JAX script does: an accurate-only trace of the plain
f32 SDF, the edge walk and shading through K3-fwd on a CUDA device.  The
init is drawn from a torch.Generator seeded 0, the regression points from
one seeded 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from iron_tpu_torch import resolve_device
from iron_tpu_torch.fields.sdf import SDFConfig, SDFNetwork, init_sdf, sdf_only
from iron_tpu_torch.surface.render import SurfaceRenderConfig
from iron_tpu_torch.train.stage2 import Stage2Config

FIT_POINTS = 4096       # of each kind, cube and near-surface
FIT_SIGMA = 0.02


def arg_parser() -> argparse.ArgumentParser:
    """The JAX script's positional arguments, and --device."""
    p = argparse.ArgumentParser(description="Stage 2 from an SDF regressed onto the torus.")
    p.add_argument("s2_iters", type=int, nargs="?", default=25000)
    p.add_argument("segments", type=int, nargs="?", default=10)
    p.add_argument("res", type=int, nargs="?", default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    return p


def stage2_config(s2_iters: int, res: int) -> Stage2Config:
    """The JAX script's stage-2 configuration (scripts/diag_torus_stage2.py:88-91)."""
    return Stage2Config(renderer_name="ggx", patch_size=min(res, 128), num_iters=s2_iters,
                        surface=SurfaceRenderConfig(edge_budget=1024), save_freq=10 ** 9)


def fit_points(gen: torch.Generator, gt_verts: torch.Tensor) -> torch.Tensor:
    """[8192, 3]: 4,096 points of U(-1, 1)^3, then 4,096 GT vertices drawn
    with replacement, each moved by N(0, 0.02^2) per axis."""
    dev = gt_verts.device
    x_vol = torch.rand((FIT_POINTS, 3), generator=gen, device=dev) * 2 - 1
    idx = torch.randint(0, gt_verts.shape[0], (FIT_POINTS,), generator=gen, device=dev)
    x_srf = gt_verts[idx] + FIT_SIGMA * torch.randn((FIT_POINTS, 3), generator=gen, device=dev)
    return torch.cat([x_vol, x_srf], 0)


def fit_loss(net: SDFNetwork, gt_sdf: Callable, x: torch.Tensor) -> torch.Tensor:
    """The regression loss (scripts/diag_torus_stage2.py:43-51): the mean
    squared SDF error at the points."""
    return torch.mean((sdf_only(net, x) - gt_sdf(x)) ** 2)


def fit_sdf(cfg: SDFConfig, gt_sdf: Callable, gt_verts: np.ndarray, device,
            steps: int = 4000) -> Tuple[SDFNetwork, float]:
    """The SDF network regressed onto `gt_sdf` by `steps` Adam(1e-4) steps:
    (network, the last step's loss)."""
    dev = resolve_device(device)
    net = init_sdf(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)
    gen = torch.Generator(device=dev).manual_seed(1)
    verts = torch.as_tensor(np.asarray(gt_verts, np.float32), device=dev)
    loss = torch.zeros((), device=dev)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = fit_loss(net, gt_sdf, fit_points(gen, verts))
        loss.backward()
        opt.step()
    return net, float(loss.detach())


def hand_over(trainer, net: SDFNetwork) -> None:
    """Start a Stage2Trainer from `net`: the weights copied into the
    trainer's SDF module, then a fresh optimizer on the trainer's
    parameters (one still holding the replaced parameters would update
    nothing the trainer renders)."""
    from iron_tpu_torch.train.stage2 import make_optimizer
    with torch.no_grad():
        trainer.params["sdf"].load_state_dict(net.state_dict())
    trainer.opt = make_optimizer(trainer.cfg, trainer.params, trainer.trainable)


def geometry_report(net: SDFNetwork, gt_verts: np.ndarray, gt_tris: np.ndarray, tag: str,
                    device, card: str, resolution: int = 128) -> Dict:
    """The chamfer of the largest component against the GT mesh, the vertex
    counts and the SDF at five points along the hole's axis (y) in
    [-0.1, 0.1]; printed as a JSON line."""
    from iron_tpu_torch.eval.metrics import chamfer_distance
    from iron_tpu_torch.export.mesh import extract_geometry, largest_component
    dev = resolve_device(device)
    v, t = extract_geometry(lambda p: -sdf_only(net, p), resolution=resolution, device=dev)
    vl, tl = largest_component(v, t)
    lin = np.linspace(-0.1, 0.1, 5).astype(np.float32)
    probe = torch.as_tensor(np.stack([np.zeros(5, np.float32), lin,
                                      np.zeros(5, np.float32)], -1), device=dev)
    with torch.no_grad():
        at_hole = sdf_only(net, probe).cpu().numpy()
    rep = {"tag": tag, "chamfer": float(chamfer_distance(vl, tl, gt_verts, gt_tris)),
           "verts": int(len(v)), "verts_largest": int(len(vl)),
           "sdf_at_hole": [round(float(s), 4) for s in at_hole],
           "device": card}
    print(json.dumps(rep), flush=True)
    return rep


def edge_coverage(trainer, data: Dict, res: int, side: int, card: str) -> Dict:
    """Edge seeds, drops and pixels of view 0 rendered at side x side
    through the trainer's evaluators, the edge budget scaled for the
    resolution; printed as a JSON line."""
    from iron_tpu_torch.core.camera import make_camera, resize_camera
    from iron_tpu_torch.surface.render import render_camera, scale_config_for_resolution
    from iron_tpu_torch.train.stage2 import build_stage2_fns
    cfg = trainer.cfg
    cam = resize_camera(make_camera(data["Ks"][0], data["W2Cs"][0], res, res,
                                    device=trainer.device), side / res)
    surf_cfg = scale_config_for_resolution(cfg.surface, cam.H, cam.W,
                                           train_patch=cfg.patch_size)
    with torch.no_grad():
        f = build_stage2_fns(trainer.params, trainer.mat_cfgs, cfg)
        out = render_camera(f["sdf_fn"], f["sdf_all_fn"], f["shade_fn"], cam, surf_cfg,
                            is_training=False)
    rec = {"edge_coverage_at": side, "edge_budget": surf_cfg.edge_budget,
           "edge_seed_count": int(out["edge_seed_count"]),
           "edge_seeds_dropped": int(out["edge_seeds_dropped"]),
           "edge_pixels": int(out["edge_mask"].sum()), "device": card}
    print(json.dumps(rec), flush=True)
    return rec


def run(s2_iters: int, segments: int, res: int, device, s2_cfg: Stage2Config = None,
        fit_steps: int = 4000, mesh_resolution: int = 128, sides=(256, 512),
        sdf_path: str = None) -> Dict:
    """The whole diagnostic; prints its lines and returns the records: the
    fit, each geometry report, the light, the edge coverage, the walls.
    The fit's network is the trainer's (s2_cfg.sdf) at bias 0.5: with the
    default configuration the JAX script's SDFConfig(bias=0.5)."""
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset
    from iron_tpu_torch.eval.e2e_validation import device_record
    from iron_tpu_torch.export.mesh import extract_geometry, largest_component
    from iron_tpu_torch.fields.sdf import sdf_to_numpy
    from iron_tpu_torch.train.stage2 import Stage2Trainer

    dev = resolve_device(device)
    card = device_record(dev)
    s2_cfg = s2_cfg or stage2_config(s2_iters, res)
    sdf_path = sdf_path or os.path.join(tempfile.gettempdir(), "diag_torus_s2_sdf.npy")
    data = render_synthetic_dataset("torus", n_views=14, H=res, W=res, light=30.0, device=dev)
    gt_sdf = data["sdf_fn"]
    gt_v, gt_t = largest_component(*extract_geometry(lambda p: -gt_sdf(p),
                                                     resolution=mesh_resolution, device=dev))

    # ---- fit the SDF net to the analytic torus by regression ----
    t0 = time.time()
    net, loss = fit_sdf(dataclasses.replace(s2_cfg.sdf, bias=0.5), gt_sdf, gt_v, dev, fit_steps)
    out = {"fit": {"fit_loss": loss, "fit_s": round(time.time() - t0, 1), "device": card}}
    print(json.dumps(out["fit"]), flush=True)
    out["reports"] = [geometry_report(net, gt_v, gt_t, "fitted_init", dev, card,
                                      mesh_resolution)]

    # ---- stage 2 from the fitted geometry ----
    train_idx = list(range(12))
    s2 = Stage2Trainer(s2_cfg, data["images"][train_idx], data["Ks"][train_idx],
                       data["W2Cs"][train_idx], device=dev)
    hand_over(s2, net)
    seg = s2_iters // segments
    t0 = time.time()
    for s in range(segments):
        m = s2.run(num_iters=seg, seed=s)
        print(f"[stage2 {s2.step}] " + " ".join(f"{k}={v:.4f}" for k, v in m.items()),
              flush=True)
        out["reports"].append(geometry_report(s2.params["sdf"], gt_v, gt_t, f"after_{s2.step}",
                                              dev, card, mesh_resolution))
    out["stage2_wall_s"] = time.time() - t0
    light = float(s2.params["materials"]["point_light_network"].light.detach())
    out["light"] = {"light_recovered": light, "light_gt": 30.0, "device": card}
    print(json.dumps(out["light"]), flush=True)
    np.save(sdf_path, sdf_to_numpy(s2.params["sdf"]), allow_pickle=True)

    # ---- edge coverage at full-image resolutions ----
    out["edge_coverage"] = [edge_coverage(s2, data, res, side, card) for side in sides]
    return out


def main(argv=None) -> Dict:
    args = arg_parser().parse_args(argv)
    return run(args.s2_iters, args.segments, args.res, args.device)


if __name__ == "__main__":
    main()
