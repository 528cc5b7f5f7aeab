#!/usr/bin/env python3
"""Stage-1 (NeuS volume) training throughput of the PyTorch port on one
NVIDIA GPU, the counterpart of scripts/bench_stage1_scaling.py.

    python3 scripts/bench_stage1_torch.py [--iters 96] [--profile-steps 1]

Two configurations at batch 512, each on the bench's data (the synthetic
sphere, 4 views at 256x256) with weights from torch.Generator seed 0:

  * womask: Stage1Config(), the width and sampling of
    iron_tpu/configs/womask_iron.json (SDF, colour net and background NeRF
    8x256; 64 + 64 samples, 32 background samples, 4 up-sample rounds);
  * scaling: bench_stage1_scaling.py's own configuration (n_outside 0,
    mask_weight 0.1).

Each: 32 warm-up steps of Stage1Trainer.run, then 3 windows of `--iters`
steps, each ended by a device synchronise (run's default chunks of 16
steps, each step a replay of the captured CUDA graph); one JSON line with
it/s and rays/s of the best window (the median beside it).  Then
`--profile-steps` eager steps (steps_per_call=1) of each configuration
traced with torch.profiler, reported as
scripts/profile_render_torch.py reports a training step (device time by
group, idle share, host syncs).  Prints the card's name and power limit
first.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_line  # noqa: E402
from iron_tpu_torch.data.dataset import RayDataset  # noqa: E402
from iron_tpu_torch.data.synthetic import render_synthetic_dataset  # noqa: E402
from iron_tpu_torch.train.stage1 import Stage1Config, Stage1Trainer  # noqa: E402
from iron_tpu_torch.volume.integrator import NeuSRenderConfig  # noqa: E402
from profile_render_torch import report  # noqa: E402

CONFIGS = {
    "womask": Stage1Config(),
    "scaling": Stage1Config(mask_weight=0.1, render=NeuSRenderConfig(
        n_samples=64, n_importance=64, n_outside=0, up_sample_steps=4, perturb=1.0)),
}
WARMUP = 32
WINDOWS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=96, help="steps a timed window")
    ap.add_argument("--profile-steps", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    data = render_synthetic_dataset("sphere", n_views=4, H=256, W=256, light=30.0,
                                    device="cuda")
    ds = RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"], data["masks"],
                                device="cuda")
    trainers = {}
    for name, cfg in CONFIGS.items():
        tr = Stage1Trainer(cfg, ds, generator=torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
        tr.run(num_iters=WARMUP)
        torch.cuda.synchronize()
        dts = []
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            m = tr.run(num_iters=args.iters)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        best, median = min(dts), sorted(dts)[len(dts) // 2]
        print(json.dumps({
            "config": name, "batch": cfg.batch_size, "n_outside": cfg.render.n_outside,
            "mask_weight": cfg.mask_weight, "iters": args.iters,
            "it_per_s": args.iters / best, "rays_per_s": cfg.batch_size * args.iters / best,
            "median_it_per_s": args.iters / median, "windows_s": dts,
            "loss": m["loss"], "card": card}), flush=True)
        trainers[name] = tr
    if args.profile_steps > 0:
        for name, tr in trainers.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr.run(num_iters=args.profile_steps, steps_per_call=1)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            report(prof, wall_ms, f"stage 1 ({name}), {args.profile_steps} step(s)",
                   {"batch": tr.cfg.batch_size})
    return 0


if __name__ == "__main__":
    sys.exit(main())
