#!/usr/bin/env python3
"""Where the time of K4 and K3-bwd goes inside a tile, on one NVIDIA GPU.

    python3 scripts/trace_kernels_torch.py

1. Device time a call (torch.profiler) of K4 (sdf_only_3pass) on 1,024,
   1,852 and 262,144 points and of K3-bwd on the training step's 1,024,
   2,048 and 4,096 points, full default SDF width, random weights.
2. A copy of csrc/ with clock64() written at phase boundaries is built and
   run: per hidden layer of K4 the k-tile loop (the tensor-core products),
   the epilogue (softplus and the hi/lo split), the spread of the CTA's
   columns to the cluster and the cluster barrier; for K3-bwd the six steps
   of a tile.  Cycles are the SM's clock; the first CTA of the grid is
   reported, alone (one tile) and in the first wave of a full grid.

The edits are inserted at marked lines of the kernels' sources and the
script stops if a marker is missing.  The built kernels are not changed.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMP = '''
__device__ unsigned long long iron_trace[64];
__device__ __forceinline__ void IRON_TS(int i) {
  if (threadIdx.x == 0 && blockIdx.x == 0) iron_trace[i] = clock64();
}
extern "C" int iron_trace_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, iron_trace, sizeof(iron_trace));
}
extern "C" int iron_trace_clear() {
  static const unsigned long long zeros[64] = {};
  return (int)cudaMemcpyToSymbol(iron_trace, zeros, sizeof(zeros));
}
'''
EDITS = {
    "fused_sdf": [
        ('#include "split3.cuh"\n', '#include "split3.cuh"\n' + STAMP),
        ("  if (CS > 1) cluster_sync();   // every CTA of the cluster runs, the PE tile is ready\n"
         "  else __syncthreads();\n",
         "  IRON_TS(0);\n  if (CS > 1) cluster_sync();   // every CTA of the cluster runs, the PE "
         "tile is ready\n  else __syncthreads();\n  IRON_TS(1);\n"),
        ("    // z = acc * post + b; softplus, split, into act[nxt], then spread to\n",
         "    IRON_TS(2 + 4 * l);\n    // z = acc * post + b; softplus, split, into act[nxt], "
         "then spread to\n"),
        ("    if (CS > 1) {\n      __syncthreads();\n",
         "    IRON_TS(3 + 4 * l);\n    if (CS > 1) {\n      __syncthreads();\n"),
        ("      cluster_sync();\n    } else {\n",
         "      IRON_TS(4 + 4 * l);\n      cluster_sync();\n    } else {\n"),
        ("    cur = nxt;\n  }\n\n  // final layer",
         "    IRON_TS(5 + 4 * l);\n    cur = nxt;\n  }\n\n  // final layer"),
    ],
    "fused_sdf_grad": [
        ("using namespace iron;\n", "using namespace iron;\n" + STAMP),
        ("    // ---- 1. forward chain of the hidden layers",
         "    IRON_TS(1);\n    // ---- 1. forward chain of the hidden layers"),
        ("    // ---- 2. u-chain:", "    IRON_TS(2);\n    // ---- 2. u-chain:"),
        ("    // ---- 3. output stage (CTA 0)", "    IRON_TS(3);\n    // ---- 3. output stage (CTA 0)"),
        ("    // ---- 4. adjoint of the u-chain, forward order ----\n",
         "    IRON_TS(4);\n    // ---- 4. adjoint of the u-chain, forward order ----\n"),
        ("    // ---- 5. adjoint of the primal chain, reverse order ----\n",
         "    IRON_TS(5);\n    // ---- 5. adjoint of the primal chain, reverse order ----\n"),
        ("    // ---- 6. dx (CTA 0) ----\n", "    IRON_TS(6);\n    // ---- 6. dx (CTA 0) ----\n"),
        ("    // ---- 0. inputs, PE and bar_a0cot panels ----\n",
         "    IRON_TS(0);\n    // ---- 0. inputs, PE and bar_a0cot panels ----\n"),
        ("    cluster_sync();   // every CTA is done with this tile's shared memory\n",
         "    IRON_TS(7);\n    cluster_sync();   // every CTA is done with this tile's shared "
         "memory\n"),
    ],
}
K3B_STEPS = ["inputs and PE", "forward chain", "u-chain", "output stage", "adjoint of the u-chain",
             "adjoint of the primal chain", "dx"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from torch.profiler import ProfilerActivity, profile
    from iron_tpu_torch.fields.sdf import SDFConfig, init_sdf
    from iron_tpu_torch.kernels import build
    from iron_tpu_torch.kernels import fused_sdf as K
    from iron_tpu_torch.kernels import fused_sdf_grad as K3

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    net = init_sdf(SDFConfig(), torch.Generator(device=dev).manual_seed(0), device=dev)
    w3, w4 = K3.prepare_grad_weights(net), K.prepare_3pass_weights(net)
    rng = np.random.default_rng(1)

    def pts(n):
        return torch.as_tensor((rng.normal(size=(n, 3)) * 0.4).astype(np.float32), device=dev)

    def cots(n):
        return [torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev)
                for s in ((n,), (n, w3.d_out - 1), (n, 3))]

    cases = {f"K4 {n} points": (lambda x=pts(n): K.sdf_only_3pass(w4, x)) for n in (1024, 1852, 262144)}
    for n in (1024, 2048, 4096):
        cases[f"K3-bwd {n} points"] = lambda x=pts(n), c=cots(n): K3.sdf_value_feat_grad_bwd(w3, x, *c)
    for name, fn in cases.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        dev_us = {e.key: e.device_time_total / e.count for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0) > 0}
        main_us = max(dev_us.values())
        print(f"{name}: device time {main_us:.1f} us a call (torch.profiler, the largest kernel "
              f"of the call; all: {', '.join(f'{k[:40]} {v:.1f}' for k, v in dev_us.items())})",
              flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "csrc")
        shutil.copytree(build.CSRC, src)
        procs = []
        for stem, edits in EDITS.items():
            path = os.path.join(src, f"{stem}.cu")
            text = open(path).read()
            for a, b in edits:
                if a not in text:
                    raise SystemExit(f"marker not found in {stem}.cu: {a[:60]!r}")
                text = text.replace(a, b)
            open(path, "w").write(text)
            procs.append((stem, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(tmp, f"lib{stem}.so"), path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for stem, p in procs:
            log, _ = p.communicate()
            if p.returncode:
                raise SystemExit(f"nvcc failed for the traced {stem}.cu:\n{log}")
        buf = (ctypes.c_ulonglong * 64)()
        for stem in EDITS:
            lib = ctypes.CDLL(os.path.join(tmp, f"lib{stem}.so"))
            build._LIBS[stem] = lib
            runs = ([(f"K4 {n} points", lambda n=n: K.sdf_only_3pass(w4, pts(n)))
                     for n in (64, 262144)] if stem == "fused_sdf" else
                    [(f"K3-bwd {n} points", lambda n=n: K3.sdf_value_feat_grad_bwd(
                        w3, pts(n), *cots(n))) for n in (1024, 4096)])
            for label, fn in runs:
                fn()
                torch.cuda.synchronize()
                if lib.iron_trace_clear() != 0:
                    raise SystemExit("cudaMemcpyToSymbol failed")
                fn()
                torch.cuda.synchronize()
                if lib.iron_trace_read(buf) != 0:
                    raise SystemExit("cudaMemcpyFromSymbol failed")
                t = np.array(buf[:], dtype=np.int64)
                if stem == "fused_sdf":
                    # a width-1 CTA has no spread: its barrier follows the epilogue
                    layers = [(int(t[2 + 4 * l] - t[1 + 4 * l]),
                               int(t[3 + 4 * l] - t[2 + 4 * l]),
                               int(t[4 + 4 * l] - t[3 + 4 * l]) if t[4 + 4 * l] else 0,
                               int(t[5 + 4 * l] - (t[4 + 4 * l] if t[4 + 4 * l] else t[3 + 4 * l])))
                              for l in range(8)]
                    width = K.k4_width(int(label.split()[1]),
                                       torch.cuda.get_device_properties(dev).multi_processor_count)
                    print(f"{label} (cluster width {width}), CTA 0, cycles a hidden layer "
                          f"(k-tile loop / epilogue / spread / barrier): "
                          + "; ".join(f"{a} / {b} / {c} / {d}" for a, b, c, d in layers)
                          + f"; tile {int(t[5 + 4 * 7] - t[0])}", flush=True)
                else:
                    steps = [int(t[i + 1] - t[i]) for i in range(7)]
                    print(f"{label} ({K3.bwd_tiling(int(label.split()[1]), K3._lib().iron_grad_bwd_clusters())[0]}"
                          f"-row tiles), CTA 0, cycles of its first tile: "
                          + ", ".join(f"{n} {c}" for n, c in zip(K3B_STEPS, steps))
                          + f"; tile {int(t[7] - t[0])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
