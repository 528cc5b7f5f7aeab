"""Torus stage-2 collapse experiment (counterpart of
scripts/torus_resume_experiment.py, with its flags and its lines).

Resumes stage 2 from a checkpoint (`--from_ckpt`, written by either
package; by default the JAX package's pre-collapse 35k checkpoint, which is
not in the repository) on the independent renderer's torus (14 views at
256x256 on the hemisphere rig looking down the hole, its GT mesh at 384,
the two mid-sequence views held out) and trains `--iters` more steps from
step 35,000 under one arm:

  --arm control   a fresh Adam state, no clipping
  --arm clip      the same and per-group gradient clipping (--clip norm)

saving every 5,000 steps into --out_dir, then prints the chamfer of each
checkpoint there (the SDF meshed at 128 with SDFConfig(), largest
component) against the independent GT torus meshed at 256.

    python -m iron_tpu_torch.scripts.torus_resume_experiment --arm clip --from_ckpt P [--device cuda]

A line `[<arm>] device ...` names the card (its name and power limit) or the
CPU.  The work is `run(args, cfg, device, data=, mesh_resolution=,
gt_mesh_resolution=)`; `main` builds the JAX script's configuration.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List

import numpy as np

from iron_tpu_torch import resolve_device
from iron_tpu_torch.surface.render import SurfaceRenderConfig
from iron_tpu_torch.train.stage2 import Stage2Config

RESUME_STEP = 35000


def arg_parser() -> argparse.ArgumentParser:
    """The JAX script's flags, and --device."""
    p = argparse.ArgumentParser(description="Resume the torus's stage 2 under a control or a "
                                            "gradient-clipping arm.")
    p.add_argument("--arm", choices=["control", "clip"], required=True)
    p.add_argument("--clip", type=float, default=5.0)
    p.add_argument("--iters", type=int, default=15000)
    p.add_argument("--from_ckpt", default="exp_quality_r4_torus/stage2/ckpt_0035000.pkl")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    return p


def stage2_config(arm: str, clip: float) -> Stage2Config:
    """The JAX script's configuration (scripts/torus_resume_experiment.py:42-46)."""
    return Stage2Config(renderer_name="ggx", patch_size=128, num_iters=100000,
                        surface=SurfaceRenderConfig(edge_budget=1024), save_freq=5000,
                        grad_clip=clip if arm == "clip" else 0.0)


def make_data(res: int = 256, mesh_resolution: int = 384) -> Dict:
    """The quality run's torus data (the independent renderer)."""
    from iron_tpu_torch.eval.independent_gt import render_independent_dataset
    return render_independent_dataset("torus", n_views=14, H=res, W=res, light=30.0,
                                      rig="hemisphere", rig_kwargs={"pole": "y"},
                                      mesh_resolution=mesh_resolution)


def resume_trainer(args, cfg: Stage2Config, data: Dict, device, out_dir: str):
    """A Stage2Trainer on the training views with the checkpoint's
    parameters, a fresh optimizer on them, at step 35,000 whatever the
    checkpoint's step."""
    from iron_tpu_torch.train.checkpoints import load_checkpoint, params_from_numpy
    from iron_tpu_torch.train.stage2 import Stage2Trainer, make_optimizer
    test_idx = [14 // 3, (2 * 14) // 3]
    train_idx = [i for i in range(14) if i not in test_idx]
    tr = Stage2Trainer(cfg, data["images"][train_idx], data["Ks"][train_idx],
                       data["W2Cs"][train_idx], out_dir=out_dir, device=device)
    ck = load_checkpoint(args.from_ckpt)
    tr.params = params_from_numpy(ck["params"], tr.device, cfg.sdf, cfg.renderer_name)
    tr.opt = make_optimizer(cfg, tr.params, tr.trainable)
    tr.step = RESUME_STEP
    return tr


def chamfer_list(out_dir: str, arm: str, sdf_cfg, gt_verts: np.ndarray, gt_tris: np.ndarray,
                 device, resolution: int = 128) -> List[Dict]:
    """{"ckpt", "verts", "chamfer"} of every checkpoint in out_dir, in name
    order, each printed as the JAX script prints it."""
    from iron_tpu_torch.eval.e2e_validation import chamfer_of
    from iron_tpu_torch.train.checkpoints import load_checkpoint
    out = []
    for pth in sorted(glob.glob(os.path.join(out_dir, "ckpt_*.pkl"))):
        rec = {"ckpt": os.path.basename(pth),
               **chamfer_of(load_checkpoint(pth)["params"]["sdf"], sdf_cfg, gt_verts, gt_tris,
                            device, resolution)}
        print(f"[{arm}] {rec['ckpt']}: verts={rec['verts']} chamfer={rec['chamfer']:.4f}",
              flush=True)
        out.append(rec)
    return out


def run(args, cfg: Stage2Config, device, data: Dict = None, mesh_resolution: int = 128,
        gt_mesh_resolution: int = 256) -> List[Dict]:
    """Resume, train args.iters steps (logged every 2,500, crops from seed
    args.iters + 7), then score every checkpoint of the run directory.
    Returns the chamfer list."""
    from iron_tpu_torch.eval.e2e_validation import device_record
    from iron_tpu_torch.eval.independent_gt import SCENES_NP, mesh_scene_np
    dev = resolve_device(device)
    out_dir = args.out_dir or f"exp_torus_resume_{args.arm}"
    print(f"[{args.arm}] device {device_record(dev)}", flush=True)
    data = data if data is not None else make_data()
    tr = resume_trainer(args, cfg, data, dev, out_dir)
    # a different crop RNG path than the original run
    tr.run(num_iters=args.iters, log_every=2500, seed=args.iters + 7)
    gt_verts, gt_tris = mesh_scene_np(SCENES_NP["torus"](), resolution=gt_mesh_resolution)
    return chamfer_list(out_dir, args.arm, cfg.sdf, gt_verts, gt_tris, dev, mesh_resolution)


def main(argv=None) -> List[Dict]:
    args = arg_parser().parse_args(argv)
    return run(args, stage2_config(args.arm, args.clip), args.device)


if __name__ == "__main__":
    main()
