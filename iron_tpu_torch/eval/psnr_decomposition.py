"""Decompose the held-out PSNR gap against the independent ground truth
(counterpart of scripts/psnr_decomposition.py, with its flags and its
report's keys).

Renders the held-out views of a run's scene in three nested configurations
through the same surface renderer:

  D  GT analytic SDF + GT constant materials + GT light
       -> the renderer-convention floor: how far the sphere-traced GGX
          render is from the independent BVH + numpy renderer when
          everything is known (no learned parameter: a check of the
          renderer's conventions);
  B  learned SDF + GT materials + GT light
       -> adds the geometry error (D - B = geometry cost);
  A  learned SDF + learned materials + learned light
       -> adds the material error (B - A = material cost);

each with its PSNR inside the GT object mask too.

    python -m iron_tpu_torch.eval.psnr_decomposition --run_dir D --scene sphere \
        --rig ring [--ckpt best|final] [--res 256] [--device cuda]

Writes <run_dir>/psnr_decomposition.json with the JAX script's keys and
`device` (the card's name and power limit, or "cpu").  On the card B and A
trace and shade through the kernels of build_stage2_fns (K1, K2, K3-fwd); D
traces the analytic SDF and runs no kernel.  The work is `decompose(args,
cfg, device)`; `main` builds the JAX script's configuration.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from iron_tpu_torch import resolve_device
from iron_tpu_torch.eval.e2e_validation import SCENES, device_record, heldout_split, rig_kwargs
from iron_tpu_torch.surface.render import SurfaceRenderConfig
from iron_tpu_torch.train.stage2 import Stage2Config

CONFIGS = [("D", "GT sdf + GT materials (convention floor)"),
           ("B", "learned sdf + GT materials (+geometry error)"),
           ("A", "learned sdf + learned materials (full)")]


def arg_parser() -> argparse.ArgumentParser:
    """The JAX script's flags, and --device."""
    p = argparse.ArgumentParser(description="Split a run's held-out PSNR gap into the "
                                            "renderer's floor, geometry and material costs.")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--scene", default="sphere", choices=SCENES)
    p.add_argument("--rig", default="ring", choices=["ring", "hemisphere"])
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--n_views", type=int, default=14)
    p.add_argument("--light", type=float, default=30.0)
    p.add_argument("--ckpt", default="best", choices=["best", "final"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return arg_parser().parse_args(argv)


def choose_checkpoint(run_dir: str, ckpt: str = "best") -> Tuple[str, Dict]:
    """(path, checkpoint) of a run: stage2/ckpt_best.pkl for "best" when it
    exists, else the newest numbered checkpoint of stage2/, else of the run
    directory itself."""
    from iron_tpu_torch.train.checkpoints import latest_checkpoint, load_checkpoint
    s2_dir = os.path.join(run_dir, "stage2")
    path = os.path.join(s2_dir, "ckpt_best.pkl")
    if ckpt == "final" or not os.path.exists(path):
        path = latest_checkpoint(s2_dir) or latest_checkpoint(run_dir)
    if path is None:
        raise FileNotFoundError(f"{run_dir}: no stage-2 checkpoint")
    return path, load_checkpoint(path)


def render_fns(params, cfg: Stage2Config, scene: str, rig: str, light: float,
               surf_cfg: SurfaceRenderConfig, device) -> Dict[str, Callable]:
    """{"D", "B", "A"}: camera -> render buffers of each configuration (see
    the module's docstring); D on the scene's analytic SDF and GT shading."""
    from iron_tpu_torch.data.synthetic import make_ggx_shade_fn, render_synthetic_dataset
    from iron_tpu_torch.shading.materials import renderer_network_configs
    from iron_tpu_torch.surface.render import render_camera
    from iron_tpu_torch.train.stage2 import build_stage2_fns

    # the analytic SDF of the same scene (the golden renderer's geometry)
    gt = render_synthetic_dataset(scene, n_views=1, H=8, W=8, light=light, rig=rig,
                                  rig_kwargs=rig_kwargs(scene, rig), device=device)
    gt_shade = make_ggx_shade_fn(light)
    mat_cfgs = renderer_network_configs(cfg.renderer_name, d_feature=cfg.sdf.d_out - 1)
    with torch.no_grad():
        f = build_stage2_fns(params, mat_cfgs, cfg)

    def learned(shade_fn):
        return lambda cam: render_camera(
            f["sdf_fn"], f["sdf_all_fn"], shade_fn, cam, surf_cfg,
            trace_sdf_fn=f["trace_sdf_fn"], trace_sdf_all_fn=f["trace_sdf_all_fn"],
            coarse_sdf_fn=f["coarse_sdf_fn"], coarse_march_fn=f["coarse_march_fn"])

    return {"D": lambda cam: render_camera(gt["sdf_fn"], gt["sdf_all_fn"], gt_shade, cam,
                                           surf_cfg),
            "B": learned(gt_shade), "A": learned(f["shade_fn"])}


def psnr_in_mask(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> float:
    """PSNR over the pixels of the GT object mask (f32, as the JAX script
    computes it)."""
    return float(-10.0 * np.log10(np.mean((pred[mask] - gt[mask]) ** 2) + 1e-12))


def decompose(args, cfg: Stage2Config, device, data: Optional[Dict] = None,
              gt_mesh_resolution: int = 384) -> Dict:
    """The decomposition of args.run_dir's checkpoint on args.scene's
    held-out views; returns the report (also written as
    <run_dir>/psnr_decomposition.json).  The views are the independent
    renderer's, its GT mesh at `gt_mesh_resolution`, or `data` when given."""
    from iron_tpu_torch.core.camera import make_camera
    from iron_tpu_torch.eval.independent_gt import render_independent_dataset
    from iron_tpu_torch.eval.metrics import psnr_np, ssim_np
    from iron_tpu_torch.surface.render import scale_config_for_resolution
    from iron_tpu_torch.train.checkpoints import params_from_numpy

    dev = resolve_device(device)
    if data is None:
        data = render_independent_dataset(args.scene, n_views=args.n_views, H=args.res,
                                          W=args.res, light=args.light, rig=args.rig,
                                          rig_kwargs=rig_kwargs(args.scene, args.rig),
                                          mesh_resolution=gt_mesh_resolution)
    test_idx, _ = heldout_split(args.rig, args.n_views)
    path, ck = choose_checkpoint(args.run_dir, args.ckpt)
    params = params_from_numpy(ck["params"], dev, cfg.sdf, cfg.renderer_name)
    print(f"[params] {path} (step {ck['step']})", flush=True)
    surf_cfg = scale_config_for_resolution(cfg.surface, args.res, args.res)
    fns = render_fns(params, cfg, args.scene, args.rig, args.light, surf_cfg, dev)

    report = {"scene": args.scene, "rig": args.rig, "res": args.res, "ckpt": path,
              "ckpt_step": int(ck["step"]), "test_views": test_idx, "configs": {},
              "device": device_record(dev)}
    for name, desc in CONFIGS:
        psnrs, psnrs_m, ssims = [], [], []
        for ti in test_idx:
            cam = make_camera(np.asarray(data["Ks"][ti]), np.asarray(data["W2Cs"][ti]),
                              args.res, args.res, device=dev)
            with torch.no_grad():
                res = fns[name](cam)
            pred = np.clip(res["color"].cpu().numpy(), 0, 1)
            gt_img = np.clip(data["images"][ti], 0, 1)
            m = data["masks"][ti][..., 0] > 0.5
            psnrs.append(psnr_np(pred, gt_img))
            ssims.append(ssim_np(pred, gt_img, device=dev))
            psnrs_m.append(psnr_in_mask(pred, gt_img, m))
        report["configs"][name] = {"desc": desc, "psnr": float(np.mean(psnrs)),
                                   "psnr_in_mask": float(np.mean(psnrs_m)),
                                   "ssim": float(np.mean(ssims))}
        print(f"[{name}] {report['configs'][name]}", flush=True)

    c = report["configs"]
    report["attribution_db"] = {"convention_floor_psnr": c["D"]["psnr"],
                                "geometry_cost_db": c["D"]["psnr"] - c["B"]["psnr"],
                                "material_cost_db": c["B"]["psnr"] - c["A"]["psnr"]}
    with open(os.path.join(args.run_dir, "psnr_decomposition.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report["attribution_db"], indent=2), flush=True)
    return report


def main(argv=None) -> Dict:
    args = parse_args(argv)
    cfg = Stage2Config(renderer_name="ggx", surface=SurfaceRenderConfig(edge_budget=1024))
    return decompose(args, cfg, args.device)


if __name__ == "__main__":
    main()
