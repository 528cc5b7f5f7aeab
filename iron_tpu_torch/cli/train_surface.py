"""Stage-2 CLI — the `render_surface.py` / `render_nir.py` equivalent
(counterpart of iron_tpu/cli/train_surface.py).

Usage:
  python -m iron_tpu_torch.cli.train_surface --data_dir D --out_dir O \
      [--neus_ckpt_fpath ckpt.pkl] [--render_all] [--export_all] [--device cuda]

Flags mirror render_surface.py:42-95; the NIR variant's differences
(roughness hinge 0.1, eta priors in-loss, render_nir.py:535-566) are the
--nir switch.  Runs on the CUDA device unless --device cpu: there the
trace, the shading SDF core and the export's SDF core run through the
port's kernels (K1, K2, K3).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description="Stage 2: surface rendering and material "
                                            "recovery of one scene.")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--folder_name", default="image")
    p.add_argument("--neus_ckpt_fpath", default=None)
    p.add_argument("--renderer_name", default="comp",
                   choices=["ggx", "multi", "comp", "comp2"],
                   help="material flavour")
    p.add_argument("--num_iters", type=int, default=50001)
    p.add_argument("--patch_size", type=int, default=128)
    p.add_argument("--eik_weight", type=float, default=0.1)
    p.add_argument("--ssim_weight", type=float, default=1.0)
    p.add_argument("--roughrange_weight", type=float, default=0.1)
    p.add_argument("--metal_eta_weight", type=float, default=0.1)
    p.add_argument("--metal_k_weight", type=float, default=0.1)
    p.add_argument("--dielectric_eta_weight", type=float, default=0.1)
    p.add_argument("--no_edgesample", action="store_true")
    p.add_argument("--inv_gamma_gt", action="store_true")
    p.add_argument("--gamma_pred", action="store_true")
    p.add_argument("--is_metal", action="store_true")
    p.add_argument("--nir", action="store_true",
                   help="NIR variant: roughness hinge 0.1 + eta priors in loss")
    p.add_argument("--init_light_scale", type=float, default=8.0)
    p.add_argument("--export_all", action="store_true")
    p.add_argument("--export_res", type=int, default=512,
                   help="marching-cubes grid resolution for exports")
    p.add_argument("--skip_final_export", action="store_true",
                   help="do not export mesh+materials after training")
    p.add_argument("--render_all", action="store_true")
    p.add_argument("--use_mask", action="store_true")
    p.add_argument("--silhouette_weight", type=float, default=0.0,
                   help="IDR-style silhouette counterweight to the masked-loss drift "
                        "(needs --use_mask; 0 = reference parity, the reference has no "
                        "stage-2 mask loss); the JAX package recommends 0.3 whenever "
                        "masks exist")
    p.add_argument("--plot_image_name", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sync_ckpt", action="store_true",
                   help="blocking checkpoints instead of the async (background "
                        "thread) pickle saves")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    args = p.parse_args(argv)

    from iron_tpu_torch import resolve_device
    from iron_tpu_torch.data.dataset import load_image_folder
    from iron_tpu_torch.data.io import gamma_correction, write_image
    from iron_tpu_torch.fields.sdf import SDFConfig
    from iron_tpu_torch.surface.render import SurfaceRenderConfig
    from iron_tpu_torch.train.checkpoints import load_any_checkpoint
    from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer
    from iron_tpu_torch.utils.logging import ExperimentDir

    dev = resolve_device(args.device)
    if args.silhouette_weight > 0 and not args.use_mask:
        p.error("--silhouette_weight requires --use_mask (dataset masks)")
    exp = ExperimentDir(args.out_dir, vars(args))
    fpaths, images, Ks, W2Cs, masks = load_image_folder(
        args.data_dir, args.folder_name,
        mask_dir=os.path.join(args.data_dir, "masks") if args.use_mask else None,
        apply_mask=args.use_mask)
    print(f"[stage2] {len(fpaths)} images {images.shape[1:3]}")

    cfg = Stage2Config(
        renderer_name=args.renderer_name,
        num_iters=args.num_iters, patch_size=args.patch_size,
        eik_weight=args.eik_weight, ssim_weight=args.ssim_weight,
        roughrange_weight=args.roughrange_weight,
        roughness_value=0.1 if args.nir else 0.5,
        metal_eta_weight=args.metal_eta_weight,
        metal_k_weight=args.metal_k_weight,
        dielectric_eta_weight=args.dielectric_eta_weight,
        include_eta_priors=args.nir,
        is_metal=args.is_metal, gamma_pred=args.gamma_pred,
        inv_gamma_gt=args.inv_gamma_gt,
        init_light_scale=args.init_light_scale,
        async_ckpt=not args.sync_ckpt,
        silhouette_weight=args.silhouette_weight,
        surface=SurfaceRenderConfig(handle_edges=not args.no_edgesample))

    stage1_params = None
    ck = load_any_checkpoint(args.neus_ckpt_fpath) if args.neus_ckpt_fpath else None
    if ck is not None:
        stage1_params = ck["params"]
        sdf_conf = ck.get("extra", {}).get("sdf_config")
        if sdf_conf:  # adopt the stage-1 SDF architecture
            sdf_conf = {**sdf_conf, "skip_in": tuple(sdf_conf.get("skip_in", ()))}
            cfg = dataclasses.replace(cfg, sdf=SDFConfig(**sdf_conf))

    trainer = Stage2Trainer(cfg, images, Ks, W2Cs, out_dir=args.out_dir,
                            stage1_params=stage1_params,
                            masks=masks if args.use_mask else None, device=dev)
    start = trainer.resume()
    light = trainer.params["materials"]["point_light_network"].light.detach()
    print(f"[stage2] resume step {start}, light={float(light):.2f}")

    if args.render_all:
        render_dir = exp.file(f"render_{os.path.basename(args.data_dir)}_{start}")
        os.makedirs(render_dir, exist_ok=True)
        for i, fp in enumerate(fpaths):
            res = trainer.render_full(i, factor=1.0)
            color = res["color"]
            diffuse = res.get("diffuse_color", color)
            if args.gamma_pred:
                color, diffuse = gamma_correction(color), gamma_correction(diffuse)
                specular = np.clip(color - diffuse, 0.0, None)
            else:
                specular = res.get("specular_color", color)
            stem = os.path.splitext(os.path.basename(fp))[0]
            normal = res["normal"]
            normal = normal / (np.linalg.norm(normal, axis=-1, keepdims=True) + 1e-10)
            write_image(os.path.join(render_dir, stem + ".jpg"), color)
            write_image(os.path.join(render_dir, stem + "_normal.jpg"), (normal + 1) / 2)
            write_image(os.path.join(render_dir, stem + "_diff.jpg"), diffuse)
            write_image(os.path.join(render_dir, stem + "_specular.jpg"), specular)
        return

    if args.export_all:
        export_assets(trainer, exp.file(f"mesh_and_materials_{start}"),
                      resolution=args.export_res)
        return

    while trainer.step < args.num_iters:
        n = min(cfg.val_freq, args.num_iters - trainer.step)
        metrics = trainer.run(num_iters=n, log_every=100, seed=args.seed)
        exp.metrics.add_scalars(trainer.step, metrics, prefix="stage2/")
        if trainer.step % cfg.val_freq == 0:
            idx = trainer.step % len(fpaths)
            write_image(exp.file(f"logim_{trainer.step}.png"),
                        mosaic(trainer, images, idx, gamma_pred=args.gamma_pred))
    trainer.save()
    trainer.wait_for_saves()
    if not args.skip_final_export:
        export_assets(trainer, exp.file(f"mesh_and_materials_{trainer.step}"),
                      resolution=args.export_res)


def mosaic(trainer, images: np.ndarray, idx: int, factor: float = 0.25,
           gamma_pred: bool = False) -> np.ndarray:
    """The validation mosaic of view idx at `factor` of its size: ground
    truth, colour, normal, edge mask, diffuse and specular colour."""
    from iron_tpu_torch.data.io import gamma_correction
    from iron_tpu_torch.utils.logging import concatenate_result
    res = trainer.render_full(idx, factor=factor)
    color = res["color"]
    if gamma_pred:
        color = gamma_correction(color)
    normal = res["normal"]
    normal = normal / (np.linalg.norm(normal, axis=-1, keepdims=True) + 1e-10)
    step = int(1 / factor)
    imgs = [np.asarray(images[idx])[::step, ::step], color, (normal + 1) / 2,
            res["edge_mask"].astype(np.float32),
            res.get("diffuse_color", color), res.get("specular_color", color)]
    return concatenate_result(imgs, 3)


def material_predictor(trainer):
    """points [N, 3] on the trainer's device -> (diffuse albedo [N, 3],
    specular albedo [N, 3], roughness [N, 1]) of the trained materials; the
    SDF features and normals from the shading path's `sdf_all_fn` (K3-fwd on
    a CUDA device, the f32 core with autograd on the CPU)."""
    from iron_tpu_torch.shading.materials import get_materials, get_materials_comp
    from iron_tpu_torch.train.stage2 import build_stage2_fns

    cfg = trainer.cfg
    with torch.no_grad():
        sdf_all = build_stage2_fns(trainer.params, trainer.mat_cfgs, cfg)["sdf_all_fn"]

    def predictor(points):
        _, feats, normals = sdf_all(points)
        normals = normals / (torch.linalg.norm(normals, dim=-1, keepdim=True) + 1e-10)
        if cfg.renderer_name in ("comp", "comp2"):
            res = get_materials_comp(trainer.params["materials"], trainer.mat_cfgs,
                                     points, normals, feats)
        else:
            res = get_materials(trainer.params["materials"], trainer.mat_cfgs,
                                points, normals, feats, is_metal=cfg.is_metal)
        return (res["diffuse_albedo"], res["specular_albedo"],
                res["specular_roughness"])

    return predictor


def export_assets(trainer, export_dir: str, resolution: int = 512):
    """Mesh + UV + baked materials (render_surface.py:418-457): the mesh from
    the f32 `sdf_only` sweep, the materials through material_predictor."""
    from iron_tpu_torch.export.materials import export_materials
    from iron_tpu_torch.export.mesh import export_mesh
    from iron_tpu_torch.export.uv import unwrap_obj
    from iron_tpu_torch.fields.sdf import sdf_only

    os.makedirs(export_dir, exist_ok=True)
    sdf = trainer.params["sdf"]
    mesh_path = os.path.join(export_dir, "mesh.obj")
    export_mesh(lambda p: sdf_only(sdf, p), mesh_path, resolution=resolution,
                device=trainer.device)
    unwrap_obj(mesh_path, mesh_path)
    export_materials(mesh_path, material_predictor(trainer), export_dir, device=trainer.device)
    print(f"[stage2] exported mesh + materials to {export_dir}")


if __name__ == "__main__":
    main()
