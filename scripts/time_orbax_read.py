"""Time the port's orbax reader on a full-width stage-1 save, on the CPU.

    JAX_PLATFORMS=cpu python scripts/time_orbax_read.py [--repeats 3]

Saves a stage-1 tree at Stage1Config()'s shapes (SDF, colour net and NeRF
8x256; 1,777,983 parameters) with an optax Adam state of random leaves
(N(0, 0.05) moments, as a trained run holds), through the JAX package's
AsyncCheckpointer (orbax: zarr v2 with zstd level 1 in OCDBT), into a
temporary directory; then reads it with
iron_tpu_torch.train.checkpoints.read_orbax_checkpoint (numpy OCDBT, zarr
and zstd) `--repeats` times, checks every leaf bit-equal to orbax's restore,
and prints one JSON line: the bytes on disk, each read's seconds, and the
rate.  The JAX package is used only to write the save.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import jax
    import numpy as np
    import optax
    import torch

    from iron_tpu.train.checkpoints import AsyncCheckpointer
    from iron_tpu_torch.train.checkpoints import read_orbax_checkpoint
    from iron_tpu_torch.train.stage1 import (Stage1Config, init_stage1_params,
                                             stage1_params_to_numpy)

    params = stage1_params_to_numpy(init_stage1_params(Stage1Config(),
                                                       torch.Generator().manual_seed(0), "cpu"))
    g = np.random.default_rng(0)
    rand = lambda scale: jax.tree_util.tree_map(
        lambda x: np.asarray(scale * g.normal(size=x.shape), np.float32), params)
    opt = (optax.ScaleByAdamState(count=np.array(100, np.int32), mu=rand(0.05),
                                  nu=jax.tree_util.tree_map(lambda x: np.asarray(x * x),
                                                            rand(0.05))),
           optax.ScaleByScheduleState(count=np.array(100, np.int32)))
    with tempfile.TemporaryDirectory() as tmp:
        ckptr = AsyncCheckpointer(tmp)
        ckptr.save(100, params, opt)
        ckptr.wait()
        ref = ckptr.restore(target={"params": params, "opt_state": opt})
        step_dir = os.path.join(tmp, "orbax", "0000100")
        disk = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(step_dir)
                   for f in fs)
        seconds = []
        for _ in range(args.repeats):
            t = time.perf_counter()
            got = read_orbax_checkpoint(step_dir)
            seconds.append(time.perf_counter() - t)
    a = jax.tree_util.tree_leaves([got["params"], [s._asdict() for s in got["opt_state"]]])
    b = jax.tree_util.tree_leaves([ref["params"], [s._asdict() for s in ref["opt_state"]]])
    equal = len(a) == len(b) and all(np.array_equal(np.asarray(x), np.asarray(y))
                                     for x, y in zip(a, b))
    values = sum(np.asarray(x).nbytes for x in a)
    print(json.dumps({"parameters": sum(x.size for x in jax.tree_util.tree_leaves(params)),
                      "array_bytes": values, "bytes_on_disk": disk, "read_s": seconds,
                      "MB_per_s": values / 1e6 / min(seconds), "bit_equal": equal,
                      "cpu_threads": os.cpu_count()}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
