"""Evaluation CLI — `evaluation/eval_image_folder.py` + `eval_mesh.py`
equivalents (counterpart of iron_tpu/cli/evaluate.py).

  python -m iron_tpu_torch.cli.evaluate images --pred_dir P --gt_dir G [--out metrics.txt]
  python -m iron_tpu_torch.cli.evaluate mesh --mesh1 a.obj --mesh2 b.obj
  python -m iron_tpu_torch.cli.evaluate relight --mesh mesh.obj --materials DIR \
      --cam_dict cams.json --out_dir OUT [--light_pos x y z]

`images` and `relight` run their tensor work on the CUDA device unless
--device cpu; `mesh` is host numpy and the native BVH.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu for a dry run)")
    p = argparse.ArgumentParser(description="Image, mesh and relighting metrics.")
    sub = p.add_subparsers(dest="cmd", required=True)

    ip = sub.add_parser("images", parents=[common])
    ip.add_argument("--pred_dir", required=True)
    ip.add_argument("--gt_dir", required=True)
    ip.add_argument("--out", default=None)

    mp = sub.add_parser("mesh", parents=[common])
    mp.add_argument("--mesh1", required=True)
    mp.add_argument("--mesh2", required=True)

    rp = sub.add_parser("relight", parents=[common])
    rp.add_argument("--mesh", required=True)
    rp.add_argument("--materials", required=True)
    rp.add_argument("--cam_dict", required=True)
    rp.add_argument("--out_dir", required=True)
    rp.add_argument("--light", type=float, default=30.0)
    rp.add_argument("--light_pos", type=float, nargs=3, default=None)

    args = p.parse_args(argv)
    from iron_tpu_torch import resolve_device
    dev = resolve_device(args.device)

    if args.cmd == "images":
        from iron_tpu_torch.eval.metrics import eval_image_folder
        summary = eval_image_folder(args.pred_dir, args.gt_dir, args.out, device=dev)
        print(json.dumps(summary))
    elif args.cmd == "mesh":
        from iron_tpu_torch.eval.metrics import chamfer_distance
        from iron_tpu_torch.export.mesh import read_obj
        v1, t1, _, _ = read_obj(args.mesh1)
        v2, t2, _, _ = read_obj(args.mesh2)
        print(json.dumps({"chamfer": chamfer_distance(v1, t1, v2, t2)}))
    elif args.cmd == "relight":
        from iron_tpu_torch.core.camera import make_camera
        from iron_tpu_torch.data.cameras import load_cam_dict
        from iron_tpu_torch.data.io import write_image
        from iron_tpu_torch.eval.relight import load_assets, render_mesh_flash
        os.makedirs(args.out_dir, exist_ok=True)
        cams = load_cam_dict(args.cam_dict)
        assets = load_assets(args.mesh, args.materials)
        for name, entry in cams.items():
            W, H = entry["img_size"]
            cam = make_camera(entry["K"], entry["W2C"], H, W, device=dev)
            res = render_mesh_flash(args.mesh, args.materials, cam,
                                    light=args.light,
                                    light_pos=None if args.light_pos is None
                                    else np.asarray(args.light_pos), assets=assets)
            stem = os.path.splitext(name)[0]
            write_image(os.path.join(args.out_dir, stem + ".png"), res["color"])
        print(f"rendered {len(cams)} relit views to {args.out_dir}")


if __name__ == "__main__":
    main()
