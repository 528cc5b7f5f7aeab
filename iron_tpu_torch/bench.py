"""The port's benchmark: stage-2 training throughput on one GPU.

    python -m iron_tpu_torch.bench

The workload of the JAX package's bench.py: the synthetic sphere, 4 views at
256x256, the comp renderer at the full default SDF width, 128x128 crops,
edge budget 1024 and interior budget 4096; 8 warm-up steps, then 5 windows
of 30 steps of Stage2Trainer.run, each ended by a device synchronise.
Prints one JSON line with bench.py's keys and metric name
(stage2_train_rays_per_s_per_chip, from the best window; the median window
beside it), and the card's name and power limit on stderr.  There is no
FLOP count on this side (no XLA cost analysis), so achieved_tflops and mfu
are null.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from iron_tpu_torch import resolve_device
from iron_tpu_torch.data.synthetic import render_synthetic_dataset
from iron_tpu_torch.surface.render import SurfaceRenderConfig
from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer

REF_A100_RAYS_S = 50_000.0  # bench.py's engineering estimate of the reference, not a measurement
PATCH = 128
WARMUP = 8
ITERS = 30
WINDOWS = 5


def bench_trainer(device="cuda", seed: int = 0) -> Stage2Trainer:
    """The bench's trainer: the synthetic sphere at 256x256, comp, 128x128
    crops, edge budget 1024, interior budget 4096."""
    dev = resolve_device(device)
    data = render_synthetic_dataset("sphere", n_views=4, H=PATCH * 2, W=PATCH * 2, light=30.0,
                                    device=dev)
    cfg = Stage2Config(renderer_name="comp", patch_size=PATCH,
                       surface=SurfaceRenderConfig(edge_budget=1024, interior_budget=4096))
    return Stage2Trainer(cfg, data["images"], data["Ks"], data["W2Cs"],
                         generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


def main() -> int:
    tr = bench_trainer("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", file=sys.stderr, flush=True)
    tr.run(num_iters=WARMUP)
    torch.cuda.synchronize()
    dts = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        tr.run(num_iters=ITERS)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    rays = PATCH * PATCH * ITERS
    best, median = rays / min(dts), rays / sorted(dts)[len(dts) // 2]
    print(json.dumps({
        "metric": "stage2_train_rays_per_s_per_chip",
        "value": round(best, 1),
        "unit": "rays/s",
        "vs_baseline": round(best / REF_A100_RAYS_S, 3),
        "achieved_tflops": None,
        "mfu": None,
        "median_rays_per_s": round(median, 1),
        "baseline_is_estimate": True,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
