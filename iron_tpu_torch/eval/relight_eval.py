"""Relit-novel-light PSNR of exported assets (counterpart of
scripts/relight_eval.py, with its flags and its report's keys).

  1. export the mesh, its UV atlas and the baked material maps of a trained
     stage-2 checkpoint (the stage-2 CLI's export path),
  2. render the exported assets under a novel flash (held-out poses, twice
     the training light) with the BVH renderer of eval/relight.py,
  3. render the ground truth at the same poses and light from the analytic
     scene (eval/independent_gt.py),
  4. report the PSNR of each view and their mean.

For a co-located flash only light x albedo is identifiable: the baked
albedos absorb a scale c and the recovered light is ~30 c.  The assets are
relit at `light_recovered * novel_light / train_light`, as a user of the
exported assets would, which cancels c.

    python -m iron_tpu_torch.eval.relight_eval --run_dir D --scene sphere --rig ring \
        [--res 256] [--ckpt best|final] [--export_res 256] [--device cuda]

Writes <run_dir>/relight_eval.json with the JAX script's keys and `device`
(the card's name and power limit, or "cpu"), <run_dir>/relight_mosaic.png
and the assets under <run_dir>/export_relight/.  On the card the bake's SDF
core runs through K3-fwd.  The work is `relight(args, cfg, device)`; `main`
builds the JAX script's configuration.
"""
from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace
from typing import Dict

import numpy as np

from iron_tpu_torch import resolve_device
from iron_tpu_torch.eval.e2e_validation import SCENES, device_record
from iron_tpu_torch.eval.psnr_decomposition import choose_checkpoint
from iron_tpu_torch.train.stage2 import Stage2Config

NOVEL_VIEWS = [2, 4]        # of 5 cameras on the novel rig


def arg_parser() -> argparse.ArgumentParser:
    """The JAX script's flags, and --device."""
    p = argparse.ArgumentParser(description="Relight a run's exported assets under a novel "
                                            "flash and score them against the ground truth.")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--scene", default="sphere", choices=SCENES)
    p.add_argument("--rig", default="ring", choices=["ring", "hemisphere"])
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--train_light", type=float, default=30.0)
    p.add_argument("--novel_light", type=float, default=60.0)
    p.add_argument("--ckpt", default="best", choices=["best", "final"])
    p.add_argument("--export_res", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return arg_parser().parse_args(argv)


def novel_rig(rig: str, res: int):
    """(Ks, W2Cs) of the novel poses: 5 cameras of the run's rig kind (the
    hemisphere drawn from seed 7), away from the 14 training poses."""
    from iron_tpu_torch.data.synthetic import hemisphere_cameras, ring_cameras
    rig_fn = {"ring": ring_cameras, "hemisphere": hemisphere_cameras}[rig]
    kw = {"seed": 7} if rig == "hemisphere" else {}
    return rig_fn(5, H=res, W=res, **kw)


def relight(args, cfg: Stage2Config, device, gt_mesh_resolution: int = 384) -> Dict:
    """The relighting score of args.run_dir's checkpoint; returns the
    report (also written as <run_dir>/relight_eval.json).
    `gt_mesh_resolution` is the analytic scene's marching-cubes grid for
    the ground-truth renders."""
    from iron_tpu_torch.cli.train_surface import export_assets
    from iron_tpu_torch.core.camera import make_camera
    from iron_tpu_torch.data.io import write_image
    from iron_tpu_torch.eval.independent_gt import SCENES_NP, mesh_scene_np, render_view_np
    from iron_tpu_torch.eval.metrics import psnr_np
    from iron_tpu_torch.eval.relight import render_mesh_flash
    from iron_tpu_torch.shading.materials import renderer_network_configs
    from iron_tpu_torch.train.checkpoints import params_from_numpy
    from iron_tpu_torch.utils.logging import concatenate_result

    dev = resolve_device(device)
    path, ck = choose_checkpoint(args.run_dir, args.ckpt)
    light_rec = float(np.asarray(ck["params"]["materials"]["point_light_network"]["light"]))
    print(f"[params] {path} step {ck['step']} light_rec {light_rec:.2f}", flush=True)

    trainer = SimpleNamespace(
        params=params_from_numpy(ck["params"], dev, cfg.sdf, cfg.renderer_name), cfg=cfg,
        mat_cfgs=renderer_network_configs(cfg.renderer_name, d_feature=cfg.sdf.d_out - 1),
        device=dev)
    export_dir = os.path.join(args.run_dir, "export_relight")
    export_assets(trainer, export_dir, resolution=args.export_res)

    Ks, W2Cs = novel_rig(args.rig, args.res)
    sdf_np = SCENES_NP[args.scene]()
    gv, gt_ = mesh_scene_np(sdf_np, resolution=gt_mesh_resolution)
    scale = args.novel_light / args.train_light
    mesh_path = os.path.join(export_dir, "mesh.obj")

    psnrs, mosaics = [], []
    for vi in NOVEL_VIEWS:
        gt = render_view_np(gv, gt_, sdf_np, Ks[vi], W2Cs[vi], args.res, args.res,
                            args.novel_light)
        cam = make_camera(Ks[vi], W2Cs[vi], args.res, args.res, device=dev)
        pred = render_mesh_flash(mesh_path, export_dir, cam, light=light_rec * scale)
        a = np.clip(pred["color"], 0, 1)
        b = np.clip(gt["color"], 0, 1)
        psnrs.append(psnr_np(a, b))
        mosaics += [b, a]
        print(f"[view {vi}] relight PSNR {psnrs[-1]:.2f}", flush=True)

    write_image(os.path.join(args.run_dir, "relight_mosaic.png"),
                concatenate_result(mosaics, 2))
    report = {"scene": args.scene, "ckpt": path, "ckpt_step": int(ck["step"]),
              "light_recovered": light_rec, "novel_light": args.novel_light,
              "relight_psnr": float(np.mean(psnrs)), "per_view": [float(x) for x in psnrs],
              "device": device_record(dev)}
    with open(os.path.join(args.run_dir, "relight_eval.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report), flush=True)
    return report


def main(argv=None) -> Dict:
    args = parse_args(argv)
    return relight(args, Stage2Config(renderer_name="ggx"), args.device)


if __name__ == "__main__":
    main()
