#!/usr/bin/env python3
"""Where the time of a hash-grid NeRF runner step goes, in the PyTorch port
on one NVIDIA GPU.

    python3 scripts/profile_runner_torch.py [--warmup 5] [--steps 20]

HashNeRFTrainer at NeRFRunnerConfig(use_foreground=True, use_envmap=True)
(the default grids: 16 levels of 2^19 rows, 2 features; batch 1024, 64
samples and 32 background samples a ray) on the synthetic sphere, 4 views
at 256x256, weights from torch.Generator seed 0, the warm-up of the
learning rate cut to 5 steps.  After `--warmup` steps:

  * the step median over `--steps` steps (host clock, a synchronise after
    each step) and max_memory_allocated;
  * one step traced with torch.profiler: its device time, the device's idle
    share, the device time by kernel (the 12 largest), and that of the
    hash grid's own kernels: the table gathers (index_elementwise), the
    tables' gradient scatter (indexing_backward) and the index sort it runs
    (DeviceRadixSort); the encoding's elementwise work (floor, clamp, the
    hash, the trilinear weights) shares its kernels with the rest of the
    step and is not counted;
  * every hashgrid_encode call of one step recorded (its grid and points),
    then each run back to back as the step runs it (forward and backward;
    for the SDF's grid the forward, the gradient with create_graph and the
    backward through it, the eikonal term's second order), the CUDA-event
    interval a call: with the card mostly idle, this interval is the
    host's launch time, not device time.

Prints the card's name and power limit first, then one JSON line.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_line, cuda_ms  # noqa: E402
from iron_tpu_torch.data.dataset import RayDataset  # noqa: E402
from iron_tpu_torch.data.synthetic import render_synthetic_dataset  # noqa: E402
from iron_tpu_torch.fields import hashgrid as HG  # noqa: E402
from iron_tpu_torch.train import nerf_runner as NR  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    data = render_synthetic_dataset("sphere", n_views=4, H=256, W=256, light=30.0, device=dev)
    ds = RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"], data["masks"],
                                device=dev)
    cfg = NR.NeRFRunnerConfig(use_foreground=True, use_envmap=True, warm_up_end=5)
    tr = NR.HashNeRFTrainer(cfg, ds, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(args.warmup):
        tr.train_step(tr.draw(gen))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(args.steps):
        d = tr.draw(gen)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.train_step(d)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated(dev)

    d = tr.draw(gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        tr.train_step(d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    grid_kernels = ("index_elementwise_kernel", "indexing_backward_kernel", "DeviceRadixSort")
    grid_ms = sum(v for k, v in kernels.items() if any(g in k for g in grid_kernels))

    # every hashgrid_encode call of one step: its grid and its points
    calls = []
    encode = HG.hashgrid_encode

    def recording(grid, x, gcfg):
        calls.append((grid, x.detach().clone(), gcfg))
        return encode(grid, x, gcfg)

    HG.hashgrid_encode = recording
    try:
        tr.train_step(tr.draw(gen))
    finally:
        HG.hashgrid_encode = encode
    sdf_grid = tr.params["sdf"].grid
    rows = []
    for grid, x, gcfg in calls:
        def fwd_bwd(grid=grid, x=x, gcfg=gcfg):
            if grid is sdf_grid:    # the SDF's: value, its x-gradient with a graph, backward
                xg = x.requires_grad_(True)
                out = encode(grid, xg, gcfg)
                (g,) = torch.autograd.grad(out.sum(), xg, create_graph=True)
                (out.sum() + g.square().sum()).backward()
                x.requires_grad_(False)
            else:
                encode(grid, x, gcfg).sum().backward()
        ms = cuda_ms(fwd_bwd, iters=5)
        rows.append({"grid": "sdf" if grid is sdf_grid else
                     ("color" if grid is tr.params["color"].grid else "nerf"),
                     "points": x.numel() // 3, "call_interval_ms": ms})
    for p in tr.params.parameters():
        p.grad = None
    rec = {"card": card, "step_ms_median": float(np.median(times)) * 1e3,
           "max_memory_allocated_mib": peak / 2**20, "profiled_wall_ms": wall * 1e3,
           "device_ms": device_ms, "device_idle_share": 1.0 - device_ms / (wall * 1e3),
           "top_kernels_ms": [[k[:80], v] for k, v in top],
           "hash_grid_kernels_ms": grid_ms, "hash_grid_kernels_share": grid_ms / device_ms,
           "hash_grid_calls": rows}
    for r in rows:
        print(f"hashgrid_encode {r['grid']} on {r['points']} points: forward + backward back to "
              f"back, {r['call_interval_ms']:.3f} ms a call (CUDA events)", flush=True)
    print(f"runner step: median {rec['step_ms_median']:.2f} ms over {args.steps} steps; "
          f"profiled {wall * 1e3:.2f} ms wall, {device_ms:.2f} ms device (idle share "
          f"{rec['device_idle_share']:.3f}); the hash grid's gather / scatter / sort kernels "
          f"{grid_ms:.2f} ms ({rec['hash_grid_kernels_share']:.1%} of the device time); "
          f"max_memory_allocated {peak / 2**20:.1f} MiB; card {card}", flush=True)
    print(json.dumps({"runner_profile": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
