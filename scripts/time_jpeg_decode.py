#!/usr/bin/env python3
"""The port's baseline JPEG decode time, at a photograph's size, for one or
more checkouts of the repository (to compare a change with its parent).

    python3 scripts/time_jpeg_decode.py [--size 1600 1200] [--rounds 4] [ROOT ...]

Writes one baseline 4:2:0 JPEG at quality 95 with the port's encoder
(iron_tpu_torch.data.jpeg.encode_jpeg) from a smooth, noisy image made
from a seed, then decodes it with `decode_jpeg` of each ROOT (a directory
holding iron_tpu_torch/; this checkout by default), `--rounds` times each,
the roots taking turns so that a load on the host falls on all of them.
Prints each root's best and median seconds and whether every root decoded
the same pixels.  Runs on the CPU; reads no card.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _decoder(root: str):
    """decode_jpeg of the iron_tpu_torch package under `root`."""
    for name in [m for m in sys.modules if m.split(".")[0] == "iron_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        return importlib.import_module("iron_tpu_torch.data.jpeg")
    finally:
        sys.path.pop(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[HERE])
    ap.add_argument("--size", type=int, nargs=2, default=(1600, 1200), metavar=("W", "H"))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    W, H = args.size
    y, x = np.mgrid[0:H, 0:W]
    img = np.stack([128 + 100 * np.sin(x / 37.0 + c) * np.cos(y / 53.0 - c) for c in range(3)],
                   -1)
    img += np.random.default_rng(args.seed).normal(0, 12, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    mods = [_decoder(os.path.abspath(r)) for r in args.roots]
    data = mods[0].encode_jpeg(img, quality=95)
    times = [[] for _ in mods]
    outs = [None] * len(mods)
    for r in range(args.rounds):
        order = range(len(mods)) if r % 2 == 0 else reversed(range(len(mods)))
        for i in order:
            t = time.perf_counter()
            outs[i] = mods[i].decode_jpeg(data)
            times[i].append(time.perf_counter() - t)
    print(f"baseline 4:2:0 JPEG, {W}x{H}, quality 95, {len(data)} bytes")
    for root, ts in zip(args.roots, times):
        print(f"{root}: best {min(ts):.3f} s, median {float(np.median(ts)):.3f} s "
              f"({args.rounds} decodes)")
    print(f"same pixels from every root: {all(np.array_equal(outs[0], o) for o in outs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
