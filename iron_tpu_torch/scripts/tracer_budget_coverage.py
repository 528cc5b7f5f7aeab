"""How the tracer's fallback budget caps a full-frame render (counterpart of
scripts/tracer_budget_coverage.py, with its flags and its lines).

    python -m iron_tpu_torch.scripts.tracer_budget_coverage [--res 64 128 256] [--device cuda]

Traces every pixel of one view (focal 1.25 x the side, at distance 3 looking
at the origin) of the stage-2 SDF at its geometric init, twice: with the
accurate-only tracer and with the coarse-to-fine tracer, whose coarse
evaluator is here the f32 `sdf_only` itself, as in the JAX script (so no
kernel runs: this measures the tracer's budgets, not K1 or K2).  Prints the
share of pixels each finds convergent, one JSON line a resolution, with
`device`.  The coarse-to-fine path runs only `refine_iters` accurate steps
on every ray and gives the rest to at most `fallback_budget` rays, so its
share falls as the frame grows.  The init is drawn from a torch.Generator
seeded 0 (the JAX script's PRNGKey(0)).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np
import torch

from iron_tpu_torch import resolve_device
from iron_tpu_torch.fields.sdf import SDFNetwork, sdf_only
from iron_tpu_torch.surface.render import SurfaceRenderConfig


def arg_parser() -> argparse.ArgumentParser:
    """The JAX script's flags, and --device."""
    ap = argparse.ArgumentParser(description="How the tracer's fallback budget caps a "
                                             "full-frame render.")
    ap.add_argument("--res", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu for a dry run)")
    return ap


def coverage_camera(res: int):
    """(K, W2C) of the view: focal 1.25 res, principal point at the centre,
    the camera 3 units from the origin looking at it."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 1.25 * res
    K[0, 2] = K[1, 2] = res / 2
    W2C = np.eye(4, dtype=np.float32)
    W2C[:3, :3] = np.diag([1.0, -1.0, -1.0])
    W2C[2, 3] = 3.0
    return K, W2C


def coverage(net: SDFNetwork, surface: SurfaceRenderConfig, res: int, device) -> Dict:
    """{"accurate_only", "coarse_to_fine"}: the convergent share of a
    res x res frame by each tracer."""
    from iron_tpu_torch.core.camera import make_camera, pixel_grid
    from iron_tpu_torch.surface.render import raytrace_pixels
    dev = resolve_device(device)
    f = lambda p: sdf_only(net, p)
    cam = make_camera(*coverage_camera(res), res, res, device=dev)
    uv = pixel_grid(res, res, device=dev)
    share = {}
    with torch.no_grad():
        for name, coarse in (("accurate_only", None), ("coarse_to_fine", f)):
            conv = raytrace_pixels(f, cam, uv, cfg=surface, coarse_sdf_fn=coarse)["convergent_mask"]
            share[name] = float(conv.to(torch.float32).mean())
    return share


def run(res_list: List[int], device, cfg=None) -> List[Dict]:
    """One record a resolution for the stage-2 SDF at its init (cfg, default
    Stage2Config()), each printed as a JSON line."""
    from iron_tpu_torch.eval.e2e_validation import device_record
    from iron_tpu_torch.train.stage2 import Stage2Config, init_stage2_params
    dev = resolve_device(device)
    cfg = cfg if cfg is not None else Stage2Config()
    params, _ = init_stage2_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    card = device_record(dev)
    out = []
    for res in res_list:
        rec = {"res": res, "fallback_budget": cfg.surface.tracer.fallback_budget,
               **coverage(params["sdf"], cfg.surface, res, dev), "device": card}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None) -> List[Dict]:
    args = arg_parser().parse_args(argv)
    return run(args.res, args.device)


if __name__ == "__main__":
    main()
