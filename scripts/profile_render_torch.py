#!/usr/bin/env python3
"""Where the time of the PyTorch port's render and training step goes, on
one NVIDIA GPU.

    python3 scripts/profile_render_torch.py [--res 512 128] [--train-steps 1]

Render: builds the same scene as chip_smoke.py (Stage2Config(), the comp
renderer, weights from torch.Generator seed 0, view 0 of a ring of cameras
at distance 3), warms up, then traces one Stage2Trainer.render_full per
resolution.  Training: the bench's trainer (iron_tpu_torch.bench), 8
warm-up steps, then `--train-steps` steps of Stage2Trainer.run traced
(0 skips it).  Each trace, taken with torch.profiler, prints: the wall time,
the device time summed over all kernels, the device idle share, the device
time by group (the port's kernels, cuBLAS products, everything else), the
host syncs (item / nonzero calls), the top kernels, and one JSON line.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_line, ring_cameras  # noqa: E402
from iron_tpu_torch.bench import bench_trainer  # noqa: E402
from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer  # noqa: E402

GROUPS = (("K1 coarse_march", "coarse_march_kernel"),
          ("K2 sdf_only_bf16", "sdf_only_bf16_kernel"),
          ("K3 sdf_grad_fwd", "sdf_grad_fwd_kernel"),
          ("K3 sdf_grad_bwd", ("sdf_grad_bwd_kernel", "reduce_partials_kernel")),
          ("cuBLAS products", ("gemm", "gemv", "xmma", "cutlass")))


def group_of(name: str) -> str:
    for g, keys in GROUPS:
        keys = (keys,) if isinstance(keys, str) else keys
        if any(k in name for k in keys):
            return g
    return "other kernels"


def report(prof, wall_ms: float, label: str, extra: dict) -> None:
    dev_us, by_group, kernels, syncs = 0.0, {}, [], 0
    for ev in prof.key_averages():
        if ev.key == "aten::_local_scalar_dense":   # .item() / bool(): a host sync
            syncs = ev.count
        # device kernels and copies only: a user annotation's range on the
        # device (e.g. Optimizer.step#Adam.step) spans kernels counted apart
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        d = ev.self_device_time_total
        dev_us += d
        g = group_of(ev.key)
        by_group[g] = by_group.get(g, 0.0) + d / 1e3
        kernels.append((d / 1e3, ev.count, ev.key[:90]))
    dev_ms = dev_us / 1e3
    print(f"\n{label}: wall {wall_ms:.1f} ms, device {dev_ms:.1f} ms, idle share "
          f"{1 - dev_ms / wall_ms:.3f}, host syncs {syncs}, "
          + ", ".join(f"{k} {v}" for k, v in extra.items()), flush=True)
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:18s} {ms:9.2f} ms  {ms / dev_ms:6.1%} of device time")
    for ms, cnt, name in sorted(kernels, reverse=True)[:12]:
        print(f"    {ms:9.2f} ms x{cnt:<5d} {name}")
    print(json.dumps({"what": label, "wall_ms": wall_ms, "device_ms": dev_ms,
                      "idle_share": 1 - dev_ms / wall_ms, "host_syncs": syncs,
                      "by_group_ms": by_group, **extra}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, nargs="*", default=[512, 128])
    ap.add_argument("--train-steps", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    for res in args.res:
        Ks, W2Cs = ring_cameras(1, res)
        gen = torch.Generator(device="cuda").manual_seed(0)
        tr = Stage2Trainer(Stage2Config(), np.zeros((1, res, res, 3), np.float32), Ks, W2Cs,
                           generator=gen, device="cuda")
        for _ in range(2):
            tr.render_full(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = tr.render_full(0)
            wall_ms = (time.perf_counter() - t0) * 1e3
        report(prof, wall_ms, f"render_full {res}x{res}",
               {"coverage": round(float(out["hit_mask"].mean()), 4)})
    if args.train_steps > 0:
        tr = bench_trainer("cuda")
        tr.run(num_iters=8)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            m = tr.run(num_iters=args.train_steps)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        report(prof, wall_ms, f"training, {args.train_steps} step(s) after 8 warm-up",
               {"mask_frac": round(m["mask_frac"], 4)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
