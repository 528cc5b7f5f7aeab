"""Does stage 1 recover the torus's hole, and does stage 2 keep it?
(counterpart of scripts/diag_torus_stage1.py, with its positional arguments
and its lines).

    python -m iron_tpu_torch.scripts.diag_torus_stage1 [iters] [s2_iters] [--device cuda]

Renders the golden renderer's torus (14 views at 128x128, the first 12
trained on), trains stage 1 for `iters` steps (default 20,000; warm-up
iters / 20, anneal iters / 2, mask supervision, 64 + 64 samples, no
background), then meshes the SDF at resolution 128 and prints V - E + F
of its largest component beside the GT mesh's, the chamfer, and the SDF at
the hole's centre beside the GT value (positive: open; negative: a
membrane).  V - E + F would be the Euler characteristic (2 = sphere,
0 = torus) of a closed mesh; the marching tetrahedra of both packages split
a face that two cells share along different diagonals on its two sides, so
their meshes are cracked and the count is not the genus (-12,336 for the GT
torus at 128).  It is kept as the JAX script computes it; the SDF at the
hole answers the question.  Then stage 2 (ggx, 128^2
crops, 1,024 edge candidates, no masks) for `s2_iters` steps (default
10,000) from that stage 1, and the chamfer, SDF at the hole and vertex count
after it.  Both JSON lines carry `device`.  The work is `run(iters,
s2_iters, device, ...)`; the mesh's resolution and the views' size are
arguments of it.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Tuple

import numpy as np
import torch

from iron_tpu_torch import resolve_device
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_only
from iron_tpu_torch.surface.render import SurfaceRenderConfig
from iron_tpu_torch.train.stage1 import Stage1Config
from iron_tpu_torch.train.stage2 import Stage2Config
from iron_tpu_torch.volume.integrator import NeuSRenderConfig


def arg_parser() -> argparse.ArgumentParser:
    """The JAX script's positional arguments, and --device."""
    p = argparse.ArgumentParser(description="Torus stage 1, its topology, then stage 2 from it.")
    p.add_argument("iters", type=int, nargs="?", default=20000)
    p.add_argument("s2_iters", type=int, nargs="?", default=10000)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    return p


def configs(iters: int, s2_iters: int) -> Tuple[Stage1Config, Stage2Config]:
    """The JAX script's two configurations (scripts/diag_torus_stage1.py:17-20,
    49-54)."""
    s1 = Stage1Config(end_iter=iters, warm_up_end=iters // 20, anneal_end=iters // 2,
                      batch_size=512, sdf=SDFConfig(bias=0.5), mask_weight=0.1,
                      render=NeuSRenderConfig(n_samples=64, n_importance=64, n_outside=0,
                                              up_sample_steps=4, perturb=1.0))
    s2 = Stage2Config(renderer_name="ggx", patch_size=128, num_iters=s2_iters,
                      surface=SurfaceRenderConfig(edge_budget=1024), save_freq=10 ** 9)
    return s1, s2


def euler(verts: np.ndarray, tris: np.ndarray) -> int:
    """V - E + F of a triangle mesh, its edges counted once."""
    t = np.asarray(tris, np.int64)
    e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    return int(len(verts) - len(e) + len(t))


def at_hole(sdf_fn, device) -> float:
    """The SDF at the hole's centre, the origin."""
    with torch.no_grad():
        return float(sdf_fn(torch.zeros((1, 3), device=device))[0])


def mesh(sdf_fn, device, resolution: int = 128):
    from iron_tpu_torch.export.mesh import extract_geometry
    return extract_geometry(lambda p: -sdf_fn(p), resolution=resolution, device=device)


def run(iters: int, s2_iters: int, device, s1_cfg: Stage1Config = None,
        s2_cfg: Stage2Config = None, res: int = 128, mesh_resolution: int = 128) -> Dict:
    """The whole diagnostic; prints its lines and returns both JSON records
    {"stage1": ..., "stage2": ...} and the walls of the two stages."""
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset
    from iron_tpu_torch.eval.e2e_validation import device_record
    from iron_tpu_torch.eval.metrics import chamfer_distance
    from iron_tpu_torch.export.mesh import largest_component
    from iron_tpu_torch.train.stage1 import Stage1Trainer, stage1_params_to_numpy
    from iron_tpu_torch.train.stage2 import Stage2Trainer

    dev = resolve_device(device)
    d1, d2 = configs(iters, s2_iters)
    s1_cfg, s2_cfg = s1_cfg or d1, s2_cfg or d2
    card = device_record(dev)
    data = render_synthetic_dataset("torus", n_views=14, H=res, W=res, light=30.0, device=dev)
    ds = RayDataset.from_arrays(data["images"][:12], data["Ks"][:12], data["W2Cs"][:12],
                                data["masks"][:12][..., :1], device=dev)
    t0 = time.time()
    tr = Stage1Trainer(s1_cfg, ds, device=dev)
    m = tr.run(num_iters=iters, log_every=iters // 4)
    s1_wall = time.time() - t0
    print("final:", {k: round(float(v), 4) for k, v in m.items()}, flush=True)

    gt_v, gt_t = largest_component(*mesh(data["sdf_fn"], dev, mesh_resolution))
    net = tr.params["sdf"]
    net_fn = lambda p: sdf_only(net, p)
    v, t = mesh(net_fn, dev, mesh_resolution)
    vl, tl = largest_component(v, t)
    rec1 = {"verts": len(v), "verts_largest": len(vl),
            "euler_largest": euler(vl, tl),  # 2 = sphere, 0 = torus, were the mesh closed
            "euler_gt": euler(gt_v, gt_t),
            "chamfer": chamfer_distance(vl, tl, gt_v, gt_t),
            # SDF at the hole centre: positive (open) vs negative (membrane)
            "sdf_at_hole": at_hole(net_fn, dev),
            "gt_sdf_at_hole": at_hole(data["sdf_fn"], dev),
            "device": card}
    print(json.dumps(rec1), flush=True)

    # ---- stage 2 from this stage 1: does it keep the hole? ----
    s2 = Stage2Trainer(s2_cfg, data["images"][:12], data["Ks"][:12], data["W2Cs"][:12],
                       stage1_params=stage1_params_to_numpy(tr.params), device=dev)
    t0 = time.time()
    m2 = s2.run(num_iters=s2_iters, log_every=s2_iters // 4)
    s2_wall = time.time() - t0
    print("stage2 final:", {k: round(float(v), 4) for k, v in m2.items()}, flush=True)
    net2 = s2.params["sdf"]
    net2_fn = lambda p: sdf_only(net2, p)
    v2, t2 = largest_component(*mesh(net2_fn, dev, mesh_resolution))
    rec2 = {"post_stage2_chamfer": chamfer_distance(v2, t2, gt_v, gt_t),
            "post_stage2_sdf_at_hole": at_hole(net2_fn, dev),
            "post_stage2_verts": len(v2), "device": card}
    print(json.dumps(rec2), flush=True)
    return {"stage1": rec1, "stage2": rec2, "wall_s": {"stage1": s1_wall, "stage2": s2_wall}}


def main(argv=None) -> Dict:
    args = arg_parser().parse_args(argv)
    return run(args.iters, args.s2_iters, args.device)


if __name__ == "__main__":
    main()
