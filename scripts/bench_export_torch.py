#!/usr/bin/env python3
"""Wall time of the port's default final export on one GPU.

    python3 scripts/bench_export_torch.py [--res 512] [--steps 10]

Writes the synthetic sphere as a scene folder (8 views at 256x256), makes a
stage-1 and a stage-2 checkpoint at the womask_iron width through the port's
CLIs (`--steps` steps each, no export), then times

    python -m iron_tpu_torch.cli.train_surface --data_dir ... --out_dir ... --export_all --export_res 512

as a process of its own (its wall time includes the interpreter's start and
the imports; the kernels are built before), and the same export again in
process with each piece timed: the two SDF sweeps and marching cubes
(export_mesh), the UV unwrap, the material bake.  Prints the card's name and
power limit and one JSON line {"export": {...}}.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512, help="export grid resolution")
    ap.add_argument("--steps", type=int, default=10, help="training steps of each stage")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible: this script measures the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from iron_tpu_torch.cli import train_surface as cli_surface
    from iron_tpu_torch.cli import train_volume as cli_volume
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset, write_scene_dir
    from iron_tpu_torch.export import materials as tmat
    from iron_tpu_torch.export import mesh as tmesh
    from iron_tpu_torch.export import uv as tuv
    from iron_tpu_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    build.build_all()
    conf = os.path.join(HERE, "iron_tpu_torch", "configs", "womask_iron.json")
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        data = render_synthetic_dataset("sphere", n_views=8, H=256, W=256, light=30.0,
                                        device="cuda")
        scene = write_scene_dir(data, os.path.join(tmp, "scene", "train"))
        exp1, exp2 = os.path.join(tmp, "exp1"), os.path.join(tmp, "exp2")
        cli_volume.main(["--mode", "train", "--conf", conf, "--data_dir", scene,
                         "--out_dir", exp1, "--num_iters", str(args.steps)])
        cli_surface.main(["--data_dir", scene, "--out_dir", exp2, "--neus_ckpt_fpath",
                          os.path.join(exp1, f"ckpt_{args.steps:07d}.pkl"),
                          "--num_iters", str(args.steps), "--skip_final_export"])

        cmd = [sys.executable, "-m", "iron_tpu_torch.cli.train_surface", "--data_dir", scene,
               "--out_dir", exp2, "--export_all", "--export_res", str(args.res)]
        t = time.perf_counter()
        subprocess.run(cmd, cwd=HERE, check=True)
        cli_s = time.perf_counter() - t

        pieces = {}

        def timed(mod, name, key):
            fn = getattr(mod, name)

            def call(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                pieces[key] = pieces.get(key, 0.0) + time.perf_counter() - t0
                return out
            setattr(mod, name, call)
            return fn

        saved = [(tmesh, "export_mesh", timed(tmesh, "export_mesh", "export_mesh_s")),
                 (tmesh, "_eval_sdf_grid", timed(tmesh, "_eval_sdf_grid", "sdf_sweeps_s")),
                 (tmesh, "marching_cubes", timed(tmesh, "marching_cubes", "marching_cubes_s")),
                 (tuv, "unwrap_obj", timed(tuv, "unwrap_obj", "uv_unwrap_s")),
                 (tmat, "export_materials", timed(tmat, "export_materials", "bake_s"))]
        t = time.perf_counter()
        try:
            cli_surface.export_assets(
                _trainer(scene, exp2), os.path.join(tmp, "again"),
                resolution=args.res)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        in_process_s = time.perf_counter() - t
        tris = sum(1 for ln in open(os.path.join(tmp, "again", "mesh.obj")) if ln[0] == "f")
    print(card)
    print(json.dumps({"export": {"res": args.res, "cli_wall_s": cli_s,
                                 "in_process_s": in_process_s, **pieces,
                                 "triangles": tris, "card": card}}), flush=True)
    return 0


def _trainer(scene, exp2):
    """The stage-2 trainer of exp2, resumed as --export_all resumes it."""
    from iron_tpu_torch.data.dataset import load_image_folder
    from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer
    _, images, Ks, W2Cs, _ = load_image_folder(scene)
    tr = Stage2Trainer(Stage2Config(), images, Ks, W2Cs, out_dir=exp2, device="cuda")
    tr.resume()
    return tr


if __name__ == "__main__":
    sys.exit(main())
