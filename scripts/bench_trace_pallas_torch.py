#!/usr/bin/env python3
"""The trace_pallas A/B of the PyTorch port on one NVIDIA GPU (the
counterpart of scripts/bench_trace_pallas.py).

    python3 scripts/bench_trace_pallas_torch.py

1. Micro-bench: K4, the 3-pass trace evaluator, against the port's f32
   sdf_only, the evaluator it replaces under Stage2Config.trace_pallas: the
   two lines of scripts/bench_sdf_eval_torch.py's sweep (262,144 points).
2. The training-step A/B on the workload of iron_tpu_torch.bench (bench.py's):
   two trainers from the same seed, trace_pallas False and True, WARMUP steps
   each, then WINDOWS windows of ITERS steps of each arm in turns (F, T, T,
   F, F, ...), each window ended by a synchronise; the best and the median
   window of each arm in rays/s and ms a step, and the K4 launches of the
   trace_pallas arm's last window.

Prints the card's name and power limit, then one JSON line per result.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_sdf_eval_torch import sweep  # noqa: E402
from chip_smoke import card_line  # noqa: E402
from iron_tpu_torch import kernels  # noqa: E402
from iron_tpu_torch.bench import ITERS, PATCH, WARMUP, WINDOWS, bench_trainer  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible: this bench runs only on a GPU", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    sweep(("f32 sdf_only", "K4 sdf_only_3pass"))

    trainers = {tp: bench_trainer("cuda", trace_pallas=tp) for tp in (False, True)}
    for tr in trainers.values():
        tr.run(num_iters=WARMUP)
    torch.cuda.synchronize()
    windows = {False: [], True: []}
    k4_launches = 0
    for w in range(WINDOWS):
        for tp in ((False, True) if w % 2 == 0 else (True, False)):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            trainers[tp].run(num_iters=ITERS)
            torch.cuda.synchronize()
            windows[tp].append(time.perf_counter() - t0)
            if tp:
                k4_launches = kernels.launch_counts()["sdf_only_3pass"]
    for tp, dts in windows.items():
        rays = PATCH * PATCH * ITERS
        print(json.dumps({"trace_pallas": tp, "windows": len(dts), "iters": ITERS,
                          "best_rays_per_s": rays / min(dts),
                          "median_rays_per_s": rays / float(np.median(dts)),
                          "best_ms_per_step": min(dts) / ITERS * 1e3,
                          "median_ms_per_step": float(np.median(dts)) / ITERS * 1e3,
                          "window_s": dts,
                          "k4_launches_per_step": k4_launches / ITERS if tp else 0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
