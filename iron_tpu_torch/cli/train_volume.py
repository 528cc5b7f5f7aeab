"""Stage-1 CLI — the `render_volume.py` equivalent (counterpart of
iron_tpu/cli/train_volume.py).

Usage:
  python -m iron_tpu_torch.cli.train_volume --mode train \
      --conf iron_tpu_torch/configs/womask_iron.json --case my_scene \
      [--data_dir override] [--out_dir override] [--device cuda]

Modes (render_volume.py:875-902): train, validate_mesh, validate_image.
Checkpoints are saved asynchronously (the `ckpt_<step>.pkl` pickles both
packages read) unless --sync_ckpt.  Runs on the CUDA device unless
--device cpu.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    p = argparse.ArgumentParser(description="Stage 1: NeuS volume training of one scene.")
    p.add_argument("--mode", default="train",
                   choices=["train", "validate_mesh", "validate_image"])
    p.add_argument("--conf", required=True)
    p.add_argument("--case", default="")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--folder_name", default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--num_iters", type=int, default=None)
    p.add_argument("--mcube_resolution", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init_ckpt_dir", default=None,
                   help="warm-start params from another experiment's latest "
                        "checkpoint (env<->flash handoff, model_volume.py:134-159)")
    p.add_argument("--sync_ckpt", action="store_true",
                   help="blocking checkpoints instead of the async (background "
                        "thread) pickle saves")
    p.add_argument("--per_host_shard", action="store_true",
                   help="multi-process: each process loads only its image shard. This "
                        "CLI trains on one process, which loads every image; a run of "
                        "more than one process raises (train with "
                        "iron_tpu_torch.dist.train.make_dp_stage1_step)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    args = p.parse_args(argv)

    from iron_tpu_torch import resolve_device
    from iron_tpu_torch.config import load_config_file, stage1_config_from_dict
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.data.io import write_image
    from iron_tpu_torch.dist.mesh import process_index_count
    from iron_tpu_torch.train.stage1 import Stage1Trainer
    from iron_tpu_torch.utils.logging import ExperimentDir, concatenate_result

    dev = resolve_device(args.device)
    conf = load_config_file(args.conf, case=args.case)
    cfg = stage1_config_from_dict(conf)
    if not args.sync_ckpt:
        cfg = dataclasses.replace(cfg, async_ckpt=True)
    data_dir = args.data_dir or conf.get("dataset", {}).get("data_dir")
    folder = args.folder_name or conf.get("dataset", {}).get("folder_name", "image")
    out_dir = args.out_dir or conf.get("general", {}).get("base_exp_dir", "./exp")

    if args.per_host_shard and process_index_count()[1] > 1:
        # the single-process Stage1Trainer does not reduce gradients over the
        # processes: sharded data would train divergent models racing on one
        # out_dir
        p.error("--per_host_shard requires the distributed dp step; this CLI is "
                "single-process. Use iron_tpu_torch.dist.train.make_dp_stage1_step "
                "for multi-process runs.")
    exp = ExperimentDir(out_dir, vars(args))
    ds = RayDataset.from_folder(data_dir, folder_name=folder,
                                per_host_shard=args.per_host_shard, device=dev)
    trainer = Stage1Trainer(cfg, ds, out_dir=out_dir, device=dev)
    start = trainer.resume()
    if start == 0 and args.init_ckpt_dir:
        from iron_tpu_torch.train.checkpoints import load_any_checkpoint
        ck = load_any_checkpoint(args.init_ckpt_dir)
        if ck is not None:
            trainer.warm_start(ck["params"])
            print(f"[stage1] warm-started from {args.init_ckpt_dir} (step {ck['step']})")
    print(f"[stage1] dataset {ds.n_images} images {ds.hw}; resume step {start}")

    if args.mode == "validate_image":
        out = trainer.render_image(0, resolution_level=4)
        write_image(exp.file(f"val_{trainer.step:07d}.png"),
                    concatenate_result([out["color"], (out["normal"] + 1) / 2], 2))
        return

    if args.mode == "validate_mesh":
        from iron_tpu_torch.export.mesh import extract_geometry, write_obj
        from iron_tpu_torch.fields.sdf import sdf_only
        sdf = trainer.params["sdf"]
        verts, tris = extract_geometry(lambda pts: -sdf_only(sdf, pts),
                                       resolution=args.mcube_resolution, device=dev)
        write_obj(exp.file(f"mesh_{trainer.step:07d}.obj"), verts, tris)
        return

    total = args.num_iters if args.num_iters is not None else cfg.end_iter
    while trainer.step < total:
        n = min(cfg.val_freq, total - trainer.step)
        metrics = trainer.run(num_iters=n, log_every=cfg.report_freq, seed=args.seed)
        exp.metrics.add_scalars(trainer.step, metrics, prefix="stage1/")
        idx = trainer.step % ds.n_images
        out = trainer.render_image(idx, resolution_level=4)
        gt = ds.images[idx].cpu().numpy()[::4, ::4]
        write_image(exp.file(f"val_{trainer.step:07d}.png"),
                    concatenate_result([gt, out["color"], (out["normal"] + 1) / 2], 3))
    trainer.save()
    trainer.wait_for_saves()


if __name__ == "__main__":
    main()
