#!/usr/bin/env python3
"""How the tracer's fallback budget caps a full-frame render (JAX package).

    JAX_PLATFORMS=cpu python scripts/tracer_budget_coverage.py [--res 64 128 256]

Traces every pixel of one view (the graft entry's camera: focal 1.25 x the
side, at distance 3 looking at the origin) of the stage-2 SDF at its
geometric init, twice: with the accurate-only tracer (what a CPU runs) and
with the coarse-to-fine tracer (what a TPU runs, here with the f32 SDF as
the coarse evaluator).  Prints the share of pixels each finds convergent.
The coarse-to-fine path runs only `refine_iters` accurate steps on every
ray and gives the rest to at most `fallback_budget` rays, so its share
falls as the frame grows.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from iron_tpu.core.camera import make_camera, pixel_grid  # noqa: E402
from iron_tpu.fields.sdf import sdf_only  # noqa: E402
from iron_tpu.surface.render import raytrace_pixels  # noqa: E402
from iron_tpu.train.stage2 import Stage2Config, init_stage2_params  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, nargs="+", default=[64, 128, 256])
    args = ap.parse_args(argv)
    cfg = Stage2Config()
    params, _ = init_stage2_params(jax.random.PRNGKey(0), cfg)
    f = lambda p: sdf_only(params["sdf"], p, cfg.sdf)
    for res in args.res:
        K = np.eye(4, dtype=np.float32)
        K[0, 0] = K[1, 1] = 1.25 * res
        K[0, 2] = K[1, 2] = res / 2
        W2C = np.eye(4, dtype=np.float32)
        W2C[:3, :3] = np.diag([1.0, -1.0, -1.0])
        W2C[2, 3] = 3.0
        cam = make_camera(K, W2C, res, res)
        uv = pixel_grid(res, res)
        share = {}
        for name, coarse in (("accurate_only", None), ("coarse_to_fine", f)):
            conv = jax.jit(lambda: raytrace_pixels(f, cam, uv, cfg=cfg.surface,
                                                   coarse_sdf_fn=coarse)["convergent_mask"])()
            share[name] = float(np.asarray(conv).mean())
        print(json.dumps({"res": res, "fallback_budget": cfg.surface.tracer.fallback_budget,
                          **share}), flush=True)


if __name__ == "__main__":
    main()
