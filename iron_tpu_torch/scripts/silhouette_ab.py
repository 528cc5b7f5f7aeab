"""A/B of the silhouette counterweight against the masked-loss shrink bias
(counterpart of scripts/silhouette_ab.py, with its flags and its report's
keys).

Trains ONE shared stage 1 on the golden renderer's scene (12 views at
res x res, its masks supervised), then forks stage 2 (ggx, crops of
min(res, 128), 1,024 edge candidates, the masks given) into a control arm
(silhouette_weight 0, reference parity) and a counterweight arm
(--silhouette_weight), recording at every --ckpt_every steps the chamfer of
the largest component against the GT mesh (both meshed at 128), its vertex
count and the step's mask-miss / mask-excess counts.  Each arm's rays/s
counts only the wall of its training calls, not the meshing between them.
report.json in --out_dir is rewritten after each arm; both stages resume
from their newest checkpoints in --out_dir (stage 1 saves every 10,000
steps, stage 2 every --ckpt_every).

    python -m iron_tpu_torch.scripts.silhouette_ab [--scene sphere] [--res 256] [--device cuda]

The report has the JAX script's keys and `device`.  The JAX script builds
its stage-1 configuration with `num_iters=`, a field the JAX package's
Stage1Config lacks (scripts/silhouette_ab.py:290-294 raises TypeError):
here it sets the schedule's length, `end_iter`, the other fields as the
script gives them.  The work is `run(args, s1_cfg, s2_cfg_of, device,
mesh_resolution=)`; `main` builds the JAX script's configurations.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict

from iron_tpu_torch import resolve_device
from iron_tpu_torch.fields.sdf import SDFConfig
from iron_tpu_torch.surface.render import SurfaceRenderConfig
from iron_tpu_torch.train.stage1 import Stage1Config
from iron_tpu_torch.train.stage2 import Stage2Config
from iron_tpu_torch.volume.integrator import NeuSRenderConfig

N_VIEWS = 12


def arg_parser() -> argparse.ArgumentParser:
    """The JAX script's flags, and --device."""
    p = argparse.ArgumentParser(description="A/B the silhouette counterweight against the "
                                            "masked-loss shrink bias.")
    p.add_argument("--out_dir", default="./exp_silhouette_ab")
    p.add_argument("--scene", default="sphere", choices=["sphere", "blobby", "torus", "genus2"])
    p.add_argument("--rig", default="ring", choices=["ring", "hemisphere"])
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--stage1_iters", type=int, default=15000)
    p.add_argument("--stage2_iters", type=int, default=20000)
    p.add_argument("--ckpt_every", type=int, default=2500)
    p.add_argument("--silhouette_weight", type=float, default=0.3)
    p.add_argument("--arms", nargs="+", default=["control", "silhouette"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    return p


def stage1_config(args) -> Stage1Config:
    """The JAX script's stage-1 configuration, its `num_iters` as
    `end_iter` (the module's docstring)."""
    return Stage1Config(batch_size=512, end_iter=args.stage1_iters, sdf=SDFConfig(bias=0.5),
                        mask_weight=0.1,
                        render=NeuSRenderConfig(n_samples=64, n_importance=64, n_outside=0,
                                                up_sample_steps=4, perturb=1.0))


def stage2_config(args, arm: str) -> Stage2Config:
    """An arm's stage-2 configuration (scripts/silhouette_ab.py:317-323)."""
    w = args.silhouette_weight if arm == "silhouette" else 0.0
    return Stage2Config(renderer_name="ggx", patch_size=min(args.res, 128),
                        num_iters=args.stage2_iters, silhouette_weight=w,
                        surface=SurfaceRenderConfig(edge_budget=1024),
                        save_freq=args.ckpt_every)


def run(args, s1_cfg: Stage1Config, s2_cfg_of: Callable[[str], Stage2Config], device,
        mesh_resolution: int = 128) -> Dict:
    """The A/B into args.out_dir; prints its lines and returns the report
    (also written as report.json).  `s2_cfg_of(arm)` gives each arm's
    stage-2 configuration."""
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset
    from iron_tpu_torch.eval.e2e_validation import chamfer_of, device_record, rig_kwargs
    from iron_tpu_torch.export.mesh import extract_geometry, largest_component
    from iron_tpu_torch.fields.sdf import sdf_to_numpy
    from iron_tpu_torch.train.stage1 import Stage1Trainer, stage1_params_to_numpy
    from iron_tpu_torch.train.stage2 import Stage2Trainer

    dev = resolve_device(device)
    os.makedirs(args.out_dir, exist_ok=True)
    data = render_synthetic_dataset(args.scene, n_views=N_VIEWS, H=args.res, W=args.res,
                                    light=30.0, rig=args.rig,
                                    rig_kwargs=rig_kwargs(args.scene, args.rig), device=dev)
    sdf_fn = data["sdf_fn"]
    gt_verts, gt_tris = largest_component(*extract_geometry(
        lambda q: -sdf_fn(q), resolution=mesh_resolution, device=dev))
    ds = RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"],
                                data["masks"][..., :1], device=dev)
    print(f"[data] {N_VIEWS} views res {args.res}, GT mesh {len(gt_verts)} verts", flush=True)

    t0 = time.time()
    s1 = Stage1Trainer(s1_cfg, ds, out_dir=os.path.join(args.out_dir, "stage1"), device=dev)
    start1 = s1.resume()
    if start1:
        print(f"[stage1] resumed at {start1}", flush=True)
    s1.run(num_iters=args.stage1_iters - start1, log_every=max(args.stage1_iters // 5, 1))
    s1.wait_for_saves()
    print(f"[stage1] {time.time() - t0:.0f}s", flush=True)
    s1_tree = stage1_params_to_numpy(s1.params)

    report = {"scene": args.scene, "rig": args.rig, "res": args.res,
              "stage1_iters": args.stage1_iters, "stage2_iters": args.stage2_iters,
              "silhouette_weight": args.silhouette_weight, "arms": {},
              "device": device_record(dev)}
    for arm in args.arms:
        cfg = s2_cfg_of(arm)
        tr = Stage2Trainer(cfg, data["images"], data["Ks"], data["W2Cs"],
                           stage1_params=s1_tree, masks=data["masks"],
                           out_dir=os.path.join(args.out_dir, f"stage2_{arm}"), device=dev)
        start2 = tr.resume()
        if start2:
            print(f"[{arm}] resumed at {start2}", flush=True)
        traj = {}
        train_s = 0.0   # the training calls' wall only, not the meshing between them
        while tr.step < args.stage2_iters:
            n = min(args.ckpt_every - tr.step % args.ckpt_every, args.stage2_iters - tr.step)
            t1 = time.time()
            m = tr.run(num_iters=n)
            train_s += time.time() - t1
            rec = chamfer_of(sdf_to_numpy(tr.params["sdf"]), cfg.sdf, gt_verts, gt_tris, dev,
                             mesh_resolution)
            rec["mask_miss"] = m.get("mask_miss_count")
            rec["mask_excess"] = m.get("mask_excess_count")
            traj[tr.step] = rec
            print(f"[{arm} {tr.step}] chamfer {rec['chamfer']:.4f} verts {rec['verts']} "
                  f"miss {rec['mask_miss']} excess {rec['mask_excess']}", flush=True)
        rays_s = (args.stage2_iters - start2) * cfg.patch_size ** 2 / max(train_s, 1e-9)
        report["arms"][arm] = {"trajectory": traj, "rays_per_s": round(rays_s, 1)}
        with open(os.path.join(args.out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=2, default=float)

    print(json.dumps(report, indent=2, default=float))
    return report


def main(argv=None) -> Dict:
    args = arg_parser().parse_args(argv)
    return run(args, stage1_config(args), lambda arm: stage2_config(args, arm), args.device)


if __name__ == "__main__":
    main()
