"""End-to-end two-stage validation with quality metrics (counterpart of
scripts/e2e_validation.py, with its flags and its report's keys).

Renders a synthetic co-located-flash dataset of an analytic scene (the
golden renderer, or with --independent_gt the numpy + BVH renderer of
eval/independent_gt.py), trains stage 1, hands its SDF and colour network to
stage 2, trains stage 2 with held-out validation (the best checkpoint kept
as stage2/ckpt_best.pkl), then reports:
  * held-out view PSNR / SSIM against the ground truth,
  * the Chamfer distance of the recovered mesh to the GT mesh, and its
    trajectory over the stage-1 and stage-2 checkpoints,
  * light and material recovery on the recovered and the GT surface,
and writes report.json, testviews.png, recovered_mesh.obj and the final
parameters as ckpt_<stage2_iters>.pkl into --out_dir.

    python -m iron_tpu_torch.eval.e2e_validation [--fast] [--out_dir D] [--device cuda]

Runs on the CUDA device unless --device cpu.  Stage 1 runs as the stage-1
CLI runs it (`Stage1Trainer.run` in chunks of 16 steps: each chunk a
replayed CUDA graph on the card, eager steps on the CPU), stage 2 one step a
call with the crops of the JAX package's host RNG.  A second call with the
same --out_dir resumes each stage from its newest checkpoint, as the JAX
script does (stage 2 saves every 5,000 steps, stage 1 every 10,000 and,
unlike the JAX script, at its end too, with the stage's record: a call cut
in stage 2 resumes there, where the JAX script redoes the steps of stage 1
after its last 10,000-step checkpoint).  So the trajectory's "stage1_final"
row is the end of stage 1, where the JAX script's is its last 10,000-step
checkpoint, and each older stage-1 checkpoint has a row of its own
("stage1_10000" in a 14,000-step run).

The report has the JAX script's keys and one more, `device`: the card's
name and power limit as nvidia-smi gives them, or "cpu", so that every wall
time in it is the card's own.  The work is `run(args, s1_cfg, s2_cfg,
device)`; `main` builds the JAX script's configurations from the flags.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from iron_tpu_torch import resolve_device
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy, sdf_only, sdf_value_feat_grad
from iron_tpu_torch.shading.materials import get_materials
from iron_tpu_torch.surface.render import SurfaceRenderConfig
from iron_tpu_torch.train.stage1 import Stage1Config
from iron_tpu_torch.train.stage2 import Stage2Config
from iron_tpu_torch.volume.integrator import NeuSRenderConfig

N_VIEWS = 14
LIGHT_GT = 30.0
# the GT materials of data/synthetic.py::make_ggx_shade_fn
DIFFUSE_GT = np.asarray([0.6, 0.3, 0.2])
SPECULAR_GT = np.asarray([0.3, 0.3, 0.3])
ROUGHNESS_GT = 0.2
SCENES = ["sphere", "blobby", "torus", "genus2"]
VAL_EVERY = 5000        # stage-2 steps between held-out validations


def device_record(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, or
    "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    lines = out.stdout.strip().splitlines()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return lines[idx] if idx < len(lines) else lines[0]


def rig_kwargs(scene: str, rig: str) -> Optional[Dict]:
    """The torus on the hemisphere rig looks down its hole's axis (y)."""
    return {"pole": "y"} if (rig == "hemisphere" and scene == "torus") else None


def heldout_split(rig: str, n_views: int = N_VIEWS) -> Tuple[List[int], List[int]]:
    """(test, train) view indices: on the hemisphere (a Fibonacci spiral
    ordered by elevation) two mid-sequence views, so that the test
    elevations lie inside the training range; on the ring the last two."""
    if rig == "hemisphere":
        test_idx = [n_views // 3, (2 * n_views) // 3]
    else:
        test_idx = [n_views - 2, n_views - 1]
    return test_idx, [i for i in range(n_views) if i not in test_idx]


def arg_parser() -> argparse.ArgumentParser:
    """The JAX script's flags, and --device."""
    p = argparse.ArgumentParser(description="End-to-end two-stage validation with quality "
                                            "metrics on a synthetic scene.")
    p.add_argument("--out_dir", default="./exp_e2e_validation")
    p.add_argument("--fast", action="store_true", help="tiny iteration counts")
    p.add_argument("--scene", default="blobby", choices=SCENES)
    p.add_argument("--rig", default="ring", choices=["ring", "hemisphere"],
                   help="camera rig; hemisphere is required for genus>0 scenes")
    p.add_argument("--stage1_iters", type=int, default=3000)
    p.add_argument("--stage2_iters", type=int, default=1500)
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--n_samples", type=int, default=48)
    p.add_argument("--n_importance", type=int, default=48)
    p.add_argument("--silhouette_weight", type=float, default=0.0,
                   help="stage-2 silhouette counterweight to the masked-loss shrink bias "
                        "(Stage2Config.silhouette_weight; 0 = reference parity)")
    p.add_argument("--independent_gt", action="store_true",
                   help="train and evaluate against the independent ground-truth renderer "
                        "(native BVH + numpy GGX, eval/independent_gt.py) instead of the "
                        "golden renderer")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The flags; --fast sets 300 + 150 steps at 64x64, as in the JAX
    script."""
    args = arg_parser().parse_args(argv)
    if args.fast:
        args.stage1_iters, args.stage2_iters, args.res = 300, 150, 64
    return args


def stage1_config(args) -> Stage1Config:
    """The JAX script's stage-1 configuration: the geometric-init sphere at
    bias 0.5, mask supervision (the synthetic backgrounds are black and there
    is no background model), no background samples."""
    return Stage1Config(
        end_iter=args.stage1_iters, warm_up_end=max(args.stage1_iters // 20, 10),
        anneal_end=args.stage1_iters // 2, batch_size=512,
        sdf=SDFConfig(bias=0.5), mask_weight=0.1,
        render=NeuSRenderConfig(n_samples=args.n_samples, n_importance=args.n_importance,
                                n_outside=0, up_sample_steps=4, perturb=1.0))


def stage2_config(args) -> Stage2Config:
    """The JAX script's stage-2 configuration: the ggx renderer, crops of
    min(res, 128), an edge budget of 1024, a checkpoint every 5,000 steps."""
    return Stage2Config(renderer_name="ggx", patch_size=min(args.res, 128),
                        num_iters=args.stage2_iters, silhouette_weight=args.silhouette_weight,
                        surface=SurfaceRenderConfig(edge_budget=1024), save_freq=5000)


def make_data(scene: str, rig: str, res: int, independent_gt: bool, device,
              gt_mesh_resolution: Optional[int] = None, fast: bool = False) -> Dict:
    """The 14 views of the scene, from the independent renderer (its GT mesh
    at 192 with --fast, else 384) or the golden one."""
    if independent_gt:
        from iron_tpu_torch.eval.independent_gt import render_independent_dataset
        if gt_mesh_resolution is None:
            gt_mesh_resolution = 192 if fast else 384
        return render_independent_dataset(scene, n_views=N_VIEWS, H=res, W=res, light=LIGHT_GT,
                                          rig=rig, rig_kwargs=rig_kwargs(scene, rig),
                                          mesh_resolution=gt_mesh_resolution)
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset
    return render_synthetic_dataset(scene, n_views=N_VIEWS, H=res, W=res, light=LIGHT_GT,
                                    rig=rig, rig_kwargs=rig_kwargs(scene, rig), device=device)


def mesh_of(sdf_net, device, resolution: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """The largest component of the marching-cubes mesh of an SDF network
    (the plain f32 `sdf_only`)."""
    from iron_tpu_torch.export.mesh import extract_geometry, largest_component
    v, t = extract_geometry(lambda p: -sdf_only(sdf_net, p), resolution=resolution,
                            device=device)
    return largest_component(v, t)


def material_stats(params, mat_cfgs, verts: np.ndarray, light_rec: float,
                   device) -> Dict:
    """Material recovery on up to 4,096 surface points drawn from `verts`
    (numpy's default_rng(0), as the JAX script draws them): means, spreads
    and the errors of the quantities a co-located flash can identify (light
    x albedo products, roughness, albedo chroma), and, for context only,
    the scale-ambiguous raw albedo errors.  The SDF's features and normals
    come from the plain f32 `sdf_value_feat_grad`, the materials from the
    ggx networks."""
    idx = np.random.default_rng(0).choice(len(verts), size=min(4096, len(verts)),
                                          replace=False)
    surf = torch.as_tensor(np.asarray(verts[idx], np.float32), device=device)
    with torch.no_grad():
        _, feat, grad = sdf_value_feat_grad(params["sdf"], surf)
        nrm = grad / (torch.linalg.norm(grad, dim=-1, keepdim=True) + 1e-10)
        mats = get_materials(params["materials"], mat_cfgs, surf, nrm, feat)
    d = mats["diffuse_albedo"].cpu().numpy()
    s = mats["specular_albedo"].cpu().numpy()
    r = mats["specular_roughness"].cpu().numpy()
    d_mean, s_mean, r_mean = d.mean(0), s.mean(0), float(r.mean())
    rel = lambda a, b: float(np.mean(np.abs(a - b) / np.clip(np.abs(b), 1e-9, None)))
    chroma = lambda v: v / max(np.sum(v), 1e-9)
    return {
        "diffuse_albedo_mean": d_mean.tolist(),
        "specular_albedo_mean": s_mean.tolist(),
        "roughness_mean": r_mean,
        "roughness_std": float(r.std()),
        "diffuse_albedo_spatial_std": float(d.std(0).mean()),
        # identifiable
        "roughness_abs_err": abs(r_mean - ROUGHNESS_GT),
        "light_diffuse_product_rel_err": rel(light_rec * d_mean, LIGHT_GT * DIFFUSE_GT),
        "light_specular_product_rel_err": rel(light_rec * s_mean, LIGHT_GT * SPECULAR_GT),
        "diffuse_chroma_l1": float(np.abs(chroma(d_mean) - chroma(DIFFUSE_GT)).sum()),
        # context only (scale-ambiguous)
        "diffuse_albedo_rel_err": rel(d_mean, DIFFUSE_GT),
        "specular_albedo_rel_err": rel(s_mean, SPECULAR_GT),
    }


def chamfer_of(sdf_tree: Dict, sdf_cfg: SDFConfig, gt_verts: np.ndarray,
               gt_tris: np.ndarray, device, resolution: int = 128) -> Dict:
    """{"verts", "chamfer"} of the mesh of an SDF parameter tree (either
    package's checkpoint layout) against the GT mesh."""
    from iron_tpu_torch.eval.metrics import chamfer_distance
    v, t = mesh_of(sdf_from_numpy(sdf_tree, sdf_cfg, device), device, resolution)
    return {"verts": int(len(v)), "chamfer": chamfer_distance(v, t, gt_verts, gt_tris)}


def chamfer_trajectory(run_dir: str, sdf_cfg: SDFConfig, gt_verts: np.ndarray,
                       gt_tris: np.ndarray, device, resolution: int = 128) -> Dict:
    """The geometry over the run, from the checkpoints of a run directory
    written by either package: the newest stage-1 checkpoint
    ("stage1_final", as in the JAX script), each older one
    ("stage1_<step>", which the JAX script leaves out) and every numbered
    stage-2 checkpoint ("stage2_<step>").  A single chamfer at the end of
    the schedule can hide a collapse in the middle of it."""
    from iron_tpu_torch.train.checkpoints import load_checkpoint

    def numbered(stage):
        paths = sorted(glob.glob(os.path.join(run_dir, stage, "ckpt_*.pkl")))
        # ckpt_best.pkl is the report's "best" row
        return [(int(os.path.basename(p)[5:-4]), p) for p in paths
                if os.path.basename(p)[5:-4].isdigit()]

    row = lambda path: chamfer_of(load_checkpoint(path)["params"]["sdf"], sdf_cfg, gt_verts,
                                  gt_tris, device, resolution)
    s1 = numbered("stage1")
    traj = {f"stage1_{step}": row(path) for step, path in s1[:-1]}
    if s1:
        traj["stage1_final"] = row(s1[-1][1])
    traj.update({f"stage2_{step}": row(path) for step, path in numbered("stage2")})
    return traj


def run(args, s1_cfg: Stage1Config, s2_cfg: Stage2Config, device,
        mesh_resolution: int = 128, gt_mesh_resolution: Optional[int] = None) -> Dict:
    """The whole validation into args.out_dir; returns the report (also
    written as report.json).  `mesh_resolution` is the marching-cubes grid
    of every recovered mesh (and of the golden GT mesh),
    `gt_mesh_resolution` the independent renderer's (default 192 with
    args.fast, else 384).  The held-out validation runs every VAL_EVERY
    stage-2 steps."""
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.data.io import write_image
    from iron_tpu_torch.eval.metrics import chamfer_distance, psnr_np, ssim_np
    from iron_tpu_torch.export.mesh import extract_geometry, largest_component, write_obj
    from iron_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
    from iron_tpu_torch.train.stage1 import Stage1Trainer, stage1_params_to_numpy
    from iron_tpu_torch.train.stage2 import Stage2Trainer
    from iron_tpu_torch.utils.logging import concatenate_result

    dev = resolve_device(device)
    os.makedirs(args.out_dir, exist_ok=True)
    t_start = time.time()
    report = {"scene": args.scene, "res": args.res,
              "stage1_iters": args.stage1_iters, "stage2_iters": args.stage2_iters,
              "gt_source": "independent" if args.independent_gt else "golden",
              "device": device_record(dev)}

    # ---- GT data ----
    data = make_data(args.scene, args.rig, args.res, args.independent_gt, dev,
                     gt_mesh_resolution, args.fast)
    test_idx, train_idx = heldout_split(args.rig)
    ds = RayDataset.from_arrays(data["images"][train_idx], data["Ks"][train_idx],
                                data["W2Cs"][train_idx], data["masks"][train_idx][..., :1],
                                device=dev)
    if args.independent_gt:
        gt_verts, gt_tris = data["verts"], data["tris"]
    else:
        sdf_fn = data["sdf_fn"]
        gt_verts, gt_tris = extract_geometry(lambda p: -sdf_fn(p), resolution=mesh_resolution,
                                             device=dev)
    gt_verts, gt_tris = largest_component(gt_verts, gt_tris)
    print(f"[data] {N_VIEWS} views, GT mesh {len(gt_verts)} verts", flush=True)

    # ---- stage 1 (as the stage-1 CLI runs it: chunks of 16 steps), its end
    # saved as a checkpoint with its record, so that a cut run resumes in
    # stage 2 ----
    t0 = time.time()
    s1_dir = os.path.join(args.out_dir, "stage1")
    s1 = Stage1Trainer(s1_cfg, ds, out_dir=s1_dir, device=dev)
    start1 = s1.resume()
    end_record = os.path.join(s1_dir, "stage1_record.json")
    if start1:
        print(f"[stage1] resumed at {start1}", flush=True)
    if start1 >= args.stage1_iters and os.path.exists(end_record):
        with open(end_record) as fh:
            report["stage1"] = {**json.load(fh), "resumed_at": start1}
    else:
        m1 = s1.run(num_iters=args.stage1_iters - start1,
                    log_every=max(args.stage1_iters // 10, 1))
        if s1.step % s1_cfg.save_freq:
            s1.save()
        s1.wait_for_saves()
        report["stage1"] = {**m1, "wall_s": time.time() - t0,
                            "iters_per_s": (args.stage1_iters - start1)
                            / max(time.time() - t0, 1e-9),
                            "resumed_at": start1,
                            "run_mode": ("replayed CUDA graph, chunks of 16 steps"
                                         if dev.type == "cuda" else "eager steps")}
        with open(end_record, "w") as fh:
            json.dump(report["stage1"], fh, indent=2)
    print(f"[stage1] {report['stage1']}", flush=True)

    # ---- stage 2 ----
    t0 = time.time()
    s2 = Stage2Trainer(s2_cfg, data["images"][train_idx], data["Ks"][train_idx],
                       data["W2Cs"][train_idx], stage1_params=stage1_params_to_numpy(s1.params),
                       masks=data["masks"][train_idx],
                       out_dir=os.path.join(args.out_dir, "stage2"), device=dev)
    start2 = s2.resume()
    if start2:
        print(f"[stage2] resumed at {start2}", flush=True)

    # held-out validation at every checkpoint interval, the best parameters
    # kept as stage2/ckpt_best.pkl; renders through a second trainer that
    # holds all views and shares the training trainer's parameters
    s2_val = Stage2Trainer(dataclasses.replace(s2_cfg, silhouette_weight=0.0),
                           data["images"], data["Ks"], data["W2Cs"], device=dev)
    val_time = [0.0]

    def val_fn(tr):
        tv = time.time()
        s2_val.params = tr.params
        ps = []
        for ti in test_idx:
            r = s2_val.render_full(ti, factor=1.0, keys=("color",))
            ps.append(psnr_np(np.clip(r["color"], 0, 1), np.clip(data["images"][ti], 0, 1)))
        val_time[0] += time.time() - tv
        out = {"metric": float(np.mean(ps))}
        print(f"[val {tr.step}] heldout_psnr {out['metric']:.2f}", flush=True)
        return out

    m2 = s2.run(num_iters=args.stage2_iters - start2,
                log_every=max(args.stage2_iters // 10, 1), val_fn=val_fn,
                val_every=VAL_EVERY)
    s2.wait_for_saves()
    train_wall = time.time() - t0 - val_time[0]
    report["stage2"] = {**m2, "wall_s": time.time() - t0, "val_wall_s": val_time[0],
                        "rays_per_s": (args.stage2_iters - start2) * s2_cfg.patch_size ** 2
                        / max(train_wall, 1e-9)}
    report["val_history"] = s2.val_history
    report["best_step"] = s2.best_step
    report["best_heldout_psnr"] = s2.best_metric if s2.val_history else None
    print(f"[stage2] {report['stage2']}", flush=True)

    # ---- the recovered surface: the materials are scored on it, where
    # shading samples them ----
    rec_verts, rec_tris = mesh_of(s2.params["sdf"], dev, mesh_resolution)

    # ---- light and materials: for a co-located flash only light x albedo
    # is identifiable ----
    light_rec = float(s2.params["materials"]["point_light_network"].light.detach())
    report["materials"] = material_stats(s2.params, s2.mat_cfgs, rec_verts, light_rec, dev)
    report["materials_at_gt_surface"] = material_stats(s2.params, s2.mat_cfgs, gt_verts,
                                                       light_rec, dev)
    print(f"[materials] {json.dumps(report['materials'])}", flush=True)
    report["light"] = {"gt": LIGHT_GT, "recovered": light_rec,
                       "rel_err": abs(light_rec - LIGHT_GT) / LIGHT_GT,
                       "light_albedo_product_rel_err":
                           report["materials"]["light_diffuse_product_rel_err"]}

    # ---- held-out view quality ----
    psnrs, ssims, mosaics = [], [], []
    s2_val.params = s2.params
    for ti in test_idx:
        res = s2_val.render_full(ti, factor=1.0)
        pred = np.clip(res["color"], 0, 1)
        gt = np.clip(data["images"][ti], 0, 1)
        psnrs.append(psnr_np(pred, gt))
        ssims.append(ssim_np(pred, gt, device=dev))
        normal = res["normal"]
        normal = normal / (np.linalg.norm(normal, axis=-1, keepdims=True) + 1e-10)
        mosaics += [gt, pred, (normal + 1) / 2]
    write_image(os.path.join(args.out_dir, "testviews.png"), concatenate_result(mosaics, 3))
    report["test_psnr"] = float(np.mean(psnrs))
    report["test_ssim"] = float(np.mean(ssims))
    print(f"[quality] PSNR {report['test_psnr']:.2f}  SSIM {report['test_ssim']:.4f}",
          flush=True)

    # ---- geometry: the final chamfer, its trajectory, the best checkpoint ----
    report["chamfer"] = chamfer_distance(rec_verts, rec_tris, gt_verts, gt_tris)
    traj = chamfer_trajectory(args.out_dir, s2_cfg.sdf, gt_verts, gt_tris, dev,
                              mesh_resolution)
    report["chamfer_trajectory"] = traj
    print(f"[geometry] trajectory {traj}", flush=True)
    best_path = os.path.join(args.out_dir, "stage2", "ckpt_best.pkl")
    if os.path.exists(best_path):
        ck = load_checkpoint(best_path)
        report["best"] = {"step": ck["step"], "heldout_psnr": ck["extra"]["val"]["metric"],
                          **chamfer_of(ck["params"]["sdf"], s2_cfg.sdf, gt_verts, gt_tris,
                                       dev, mesh_resolution),
                          "selection_rule": "max held-out PSNR over 5k checkpoints"}
        print(f"[best] {report['best']}", flush=True)
    write_obj(os.path.join(args.out_dir, "recovered_mesh.obj"), rec_verts, rec_tris)
    save_checkpoint(args.out_dir, args.stage2_iters, s2.params)
    print(f"[geometry] chamfer {report['chamfer']:.5f} ({len(rec_verts)} verts)", flush=True)

    report["total_wall_s"] = time.time() - t_start
    with open(os.path.join(args.out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items()
                      if k in ("test_psnr", "test_ssim", "chamfer", "light")}), flush=True)
    return report


def main(argv=None) -> Dict:
    args = parse_args(argv)
    return run(args, stage1_config(args), stage2_config(args), args.device)


if __name__ == "__main__":
    main()
