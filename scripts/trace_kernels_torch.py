#!/usr/bin/env python3
"""Where the time of K1, K2, K3-fwd, K3-bwd and K4 goes inside a launch, on
one NVIDIA GPU.

    python3 scripts/trace_kernels_torch.py

1. Device time a call (torch.profiler) of K4 (sdf_only_3pass) on 1,024,
   1,852 and 262,144 points and of K3-bwd on the training step's 1,024,
   2,048 and 4,096 points, full default SDF width, random weights; of K1
   (coarse_march) and K3-fwd (sdf_value_feat_grad_fwd) on the calls of a
   training step and of a 512x512 render of view 0, and of K2
   (sdf_only_bf16) on the view's fallback sweep
   (scripts/torch_main_path_calls.py).
2. A copy of csrc/ with clock64() read at phase boundaries is built and
   run: per hidden layer of K4 the k-tile loop (the tensor-core products),
   the epilogue (softplus and the hi/lo split), the spread of the CTA's
   columns to the cluster and the cluster barrier; for K3-bwd the six steps
   of a tile; the SM of each of K1's CTAs (%smid).  For K1 and K3-fwd the
   cycles of each phase are summed over
   the whole launch: K1's evaluations, their PE, k-tile loops, epilogues
   and final layer, the rows' loads and their update and append to the
   next list, and the waits at the grid barrier; K2's (warpgroup 0) inputs
   and PE, waits for its turn at the tensor cores, products issued (with the
   waits for the ring), the wait for the last products, epilogues and final
   layer; K3-fwd's inputs, forward products and
   epilogues, final layer, u-chain products and epilogues, the spreads and
   barriers, the PE cotangent and the gradient.  Cycles are the SM's clock
   of the grid's first CTA (thread 0).

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
__device__ unsigned long long iron_acc[64];
#define IRON_ON (threadIdx.x == 0 && blockIdx.x == 0)
__device__ __forceinline__ void IRON_ADD(int i, long long& t) {
  if (IRON_ON) {
    const long long now = clock64();
    iron_acc[i] += now - t;
    t = now;
  }
}
extern "C" int iron_acc_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, iron_acc, sizeof(iron_acc));
}
__device__ int iron_smid[1024];
extern "C" int iron_smid_read(int* out) {
  return (int)cudaMemcpyFromSymbol(out, iron_smid, sizeof(iron_smid));
}
extern "C" int iron_acc_clear() {
  static const unsigned long long zeros[64] = {};
  return (int)cudaMemcpyToSymbol(iron_acc, zeros, sizeof(zeros));
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
        ("    cur = nxt;\n  }\n\n  // final layer, sdf column",
         "    IRON_TS(5 + 4 * l);\n    cur = nxt;\n  }\n\n  // final layer, sdf column"),
        # K1: cycles summed over the launch
        ("  uint2 bh[PF][NTW];\n  auto fetch = [&](int c, uint2 (&h)[NTW]) {",
         "  long long iron_t = clock64();\n  if (IRON_ON) iron_acc[40] += 1;\n"
         "  uint2 bh[PF][NTW];\n  auto fetch = [&](int c, uint2 (&h)[NTW]) {"),
        ("  fill_pe_sincos(sm.pe, sm.y, ROWS, p.d_embed, tid, THREADS);\n  __syncthreads();\n",
         "  fill_pe_sincos(sm.pe, sm.y, ROWS, p.d_embed, tid, THREADS);\n  __syncthreads();\n"
         "  IRON_ADD(0, iron_t);\n"),
        ("    const float post = (l == p.skip) ? INV_SQRT2 : 1.0f;\n",
         "    IRON_ADD(1, iron_t);\n    const float post = (l == p.skip) ? INV_SQRT2 : 1.0f;\n"),
        ("                     sm.act[nxt] + (m * 16 + g + 8 * half) * H_STRIDE + col);\n"
         "    }\n    __syncthreads();\n",
         "                     sm.act[nxt] + (m * 16 + g + 8 * half) * H_STRIDE + col);\n"
         "    }\n    __syncthreads();\n    IRON_ADD(2, iron_t);\n"),
        ("    if (q == 0) sm.out[r] = s + __ldg(p.bias + (p.n_layers - 1) * HID);\n  }\n",
         "    if (q == 0) sm.out[r] = s + __ldg(p.bias + (p.n_layers - 1) * HID);\n  }\n"
         "  IRON_ADD(3, iron_t);\n"),
        ("  for (int tile = block; tile < tiles; tile += gridDim.x) {\n",
         "  for (int tile = block; tile < tiles; tile += gridDim.x) {\n"
         "    long long iron_u = clock64();\n"),
        ("    __syncthreads();\n    eval_tile(sm, p);\n",
         "    __syncthreads();\n    IRON_ADD(4, iron_u);\n    eval_tile(sm, p);\n"
         "    iron_u = clock64();\n"),
        ("    __syncthreads();   // sm.ray, sm.acc and sm.out are read before the next tile's loads\n",
         "    __syncthreads();   // sm.ray, sm.acc and sm.out are read before the next tile's loads\n"
         "    IRON_ADD(5, iron_u);\n"),
        ("      grid_sync(p.barrier, (unsigned)(it + 1) * gridDim.x);\n",
         "      long long iron_g = clock64();\n      grid_sync(p.barrier, (unsigned)(it + 1) * gridDim.x);\n"
         "      IRON_ADD(6, iron_g);\n      if (IRON_ON) iron_acc[7] += 1;\n"),
        ("  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);\n  int m = p.n;\n",
         "  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);\n  int m = p.n;\n  long long iron_k = clock64();\n"),
        ("                    p.lists + (size_t)((it + 1) & 1) * p.n, p.counts + it + 1);\n  }\n}\n",
         "                    p.lists + (size_t)((it + 1) & 1) * p.n, p.counts + it + 1);\n  }\n"
         "  IRON_ADD(8, iron_k);\n}\n"),
        # K1: the SM of each CTA
        ('    asm volatile("mov.u32 %0, %%smid;\\n" : "=r"(smid));\n',
         '    asm volatile("mov.u32 %0, %%smid;\\n" : "=r"(smid));\n'
         '    if (blockIdx.x < 1024) iron_smid[blockIdx.x] = (int)smid;\n'),
        # K2: cycles summed over the launch, thread 0 (warpgroup 0) of CTA 0
        ("      const int row0 = tile * TILE + wgi * WG_ROWS;\n",
         "      const int row0 = tile * TILE + wgi * WG_ROWS;\n      long long iron_t = clock64();\n"
         "      if (IRON_ON) iron_acc[27] += 1;\n"),
        ("      named_sync(1 + wgi, 128);\n\n      for (int l = 0; l < n_layers - 1; ++l) {\n",
         "      named_sync(1 + wgi, 128);\n      IRON_ADD(26, iron_t);\n\n"
         "      for (int l = 0; l < n_layers - 1; ++l) {\n"),
        ("        named_sync(3 + wgi, 256);   // this warpgroup's turn\n",
         "        named_sync(3 + wgi, 256);   // this warpgroup's turn\n        IRON_ADD(21, iron_t);\n"),
        ("        named_arrive(4 - wgi, 256);   // the other warpgroup's turn\n",
         "        IRON_ADD(22, iron_t);\n        named_arrive(4 - wgi, 256);   // the other warpgroup's turn\n"),
        ("        // z = acc * post + b; softplus; bf16: the next layer's A fragments.\n",
         "        IRON_ADD(23, iron_t);\n        // z = acc * post + b; softplus; bf16: the next layer's A fragments.\n"),
        ("        }\n      }\n\n      // final layer, the sdf column of rows g and g + 8",
         "        }\n        IRON_ADD(24, iron_t);\n      }\n\n      // final layer, the sdf column of rows g and g + 8"),
        ("      if (t == 0 && r + 8 < n) out[r + 8] = (s1 + b_last) * inv_scale;\n",
         "      if (t == 0 && r + 8 < n) out[r + 8] = (s1 + b_last) * inv_scale;\n      IRON_ADD(25, iron_t);\n"),
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
        # K3-fwd: cycles summed over the launch
        ("    const int row0 = tile * R;\n    // ---- inputs: PE, dPE/dy ----\n",
         "    const int row0 = tile * R;\n    long long iron_t = clock64();\n"
         "    if (IRON_ON) iron_acc[11] += 1;\n    // ---- inputs: PE, dPE/dy ----\n"),
        ("    // ---- forward chain: a_{l+1}", "    IRON_ADD(0, iron_t);\n    // ---- forward chain: a_{l+1}"),
        ("#pragma unroll\n      for (int j = 0; j < NJ; ++j) {\n        const int col = 8 * (j0 + j) + 2 * t;\n"
         "        const float b0 = __ldg(bias + l * HID + col)",
         "      IRON_ADD(1, iron_t);\n#pragma unroll\n      for (int j = 0; j < NJ; ++j) {\n"
         "        const int col = 8 * (j0 + j) + 2 * t;\n        const float b0 = __ldg(bias + l * HID + col)"),
        ("      share(wb);\n      rb = wb;\n      wb ^= 1;\n    }\n\n    // ---- final layer",
         "      IRON_ADD(2, iron_t);\n      share(wb);\n      IRON_ADD(3, iron_t);\n      rb = wb;\n"
         "      wb ^= 1;\n    }\n\n    // ---- final layer"),
        ("    // ---- u-chain: u_{L-2}", "    IRON_ADD(4, iron_t);\n    // ---- u-chain: u_{L-2}"),
        ("          put(wb, j, m, h, w0 * s.x, w1 * s.y);\n        }\n    }\n    share(wb);\n",
         "          put(wb, j, m, h, w0 * s.x, w1 * s.y);\n        }\n    }\n    IRON_ADD(5, iron_t);\n"
         "    share(wb);\n    IRON_ADD(3, iron_t);\n"),
        ("        k3b::add_panel(acc[0], sm.a0cot);\n      }\n",
         "        k3b::add_panel(acc[0], sm.a0cot);\n      }\n      IRON_ADD(6, iron_t);\n"),
        ("#pragma unroll\n      for (int j = 0; j < NJ; ++j)\n#pragma unroll\n        for (int m = 0; m < MT; ++m)\n"
         "#pragma unroll\n          for (int h = 0; h < 2; ++h) {\n            const float2 s = sp[si(l - 1, j, m, h)];",
         "      IRON_ADD(7, iron_t);\n#pragma unroll\n      for (int j = 0; j < NJ; ++j)\n#pragma unroll\n"
         "        for (int m = 0; m < MT; ++m)\n#pragma unroll\n          for (int h = 0; h < 2; ++h) {\n"
         "            const float2 s = sp[si(l - 1, j, m, h)];"),
        ("            put(wb, j, m, h, acc[j][m][2 * h] * s.x, acc[j][m][2 * h + 1] * s.y);\n          }\n"
         "      share(wb);\n",
         "            put(wb, j, m, h, acc[j][m][2 * h] * s.x, acc[j][m][2 * h + 1] * s.y);\n          }\n"
         "      IRON_ADD(5, iron_t);\n      share(wb);\n      IRON_ADD(3, iron_t);\n"),
        ("    // ---- grad (CTA 0) ----\n", "    IRON_ADD(6, iron_t);\n    // ---- grad (CTA 0) ----\n"),
        ("    // every CTA is done with this tile's shared memory before the next\n",
         "    IRON_ADD(8, iron_t);\n    // every CTA is done with this tile's shared memory before the next\n"),
    ],
}
K3B_STEPS = ["inputs and PE", "forward chain", "u-chain", "output stage", "adjoint of the u-chain",
             "adjoint of the primal chain", "dx"]
K1_PHASES = ["PE", "k-tile loops", "epilogues", "final layer", "rows' loads",
             "update and append", "grid barrier waits"]
K2_PHASES = {26: "inputs and PE", 21: "turn waits", 22: "products issued (ring waits)",
             23: "last products' wait", 24: "epilogues", 25: "final layer"}
K3F_PHASES = ["inputs", "forward products", "forward epilogues", "spreads and barriers",
              "final layer", "u-chain epilogues", "PE cotangent and gradient (CTA 0)",
              "u-chain products", "end of tile"]


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
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from torch_main_path_calls import main_path_calls
    mp = main_path_calls()
    k1_calls = [(f"K1 step call {i} ({c[1].numel() // 3} rays)", c)
                for i, c in enumerate(mp["step"]["coarse_march"])]
    k1_calls.append((f"K1 512x512 view call 0 ({mp['view']['coarse_march'][0][1].numel() // 3} "
                     f"rays)", mp["view"]["coarse_march"][0]))
    k3f_calls = [(f"K3-fwd step call {i} ({c[1].numel() // 3} points)", c)
                 for i, c in enumerate(mp["step"]["sdf_value_feat_grad_fwd"])]
    big = max(mp["view"]["sdf_value_feat_grad_fwd"], key=lambda c: c[1].numel())
    k3f_calls.append((f"K3-fwd 512x512 view, largest call ({big[1].numel() // 3} points)", big))
    k2_calls = [(f"K2 512x512 view call {i} ({c[1].numel() // 3} points)", c)
                for i, c in enumerate(mp["view"]["sdf_only_bf16"][:1])]
    for label, c in k1_calls + k2_calls:
        cases[label] = lambda c=c, f=(K.sdf_only_bf16 if label.startswith("K2") else
                                      K.coarse_march): f(*c)
    for label, c in k3f_calls:
        cases[label] = lambda c=c: K3.sdf_value_feat_grad_fwd(*c)
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
            runs += [(label, cases[label]) for label, _ in
                     (k1_calls + k2_calls if stem == "fused_sdf" else k3f_calls)]
            for label, fn in runs:
                fn()
                torch.cuda.synchronize()
                if lib.iron_trace_clear() != 0 or lib.iron_acc_clear() != 0:
                    raise SystemExit("cudaMemcpyToSymbol failed")
                fn()
                torch.cuda.synchronize()
                if lib.iron_trace_read(buf) != 0:
                    raise SystemExit("cudaMemcpyFromSymbol failed")
                t = np.array(buf[:], dtype=np.int64)
                if lib.iron_acc_read(buf) != 0:
                    raise SystemExit("cudaMemcpyFromSymbol failed")
                acc = np.array(buf[:], dtype=np.int64)
                if label.startswith("K1"):
                    smid = (ctypes.c_int * 1024)()
                    if lib.iron_smid_read(smid) != 0:
                        raise SystemExit("cudaMemcpyFromSymbol failed")
                    sm48 = list(smid[:48])
                    print(f"{label}: SMs of CTAs 0-15 {list(smid[:16])}; CTAs 0-47 on "
                          f"{len(set(sm48))} SMs", flush=True)
                    n_ev = max(int(acc[40]), 1)
                    print(f"{label}, CTA 0: {int(acc[40])} evaluations, "
                          + ", ".join(f"{n} {int(acc[i])}" for i, n in enumerate(K1_PHASES))
                          + f" cycles summed; {int(acc[7])} grid barriers; launch {int(acc[8])} "
                          f"cycles; an evaluation {int(sum(acc[:4]) / n_ev)} cycles: PE "
                          f"{int(acc[0] / n_ev)}, k-tile loops {int(acc[1] / n_ev)}, epilogues "
                          f"{int(acc[2] / n_ev)}, final layer {int(acc[3] / n_ev)}", flush=True)
                    continue
                if label.startswith("K2"):
                    tiles = max(int(acc[27]), 1)
                    print(f"{label}, CTA 0, warpgroup 0: {int(acc[27])} tiles, "
                          + ", ".join(f"{n} {int(acc[i])}" for i, n in K2_PHASES.items())
                          + f" cycles summed; a tile {int(sum(acc[i] for i in K2_PHASES) / tiles)} "
                          f"cycles", flush=True)
                    continue
                if label.startswith("K3-fwd"):
                    tiles = max(int(acc[11]), 1)
                    print(f"{label}, CTA 0: {int(acc[11])} tiles, "
                          + ", ".join(f"{n} {int(acc[i])}" for i, n in enumerate(K3F_PHASES))
                          + f" cycles summed; a tile {int(sum(acc[:9]) / tiles)} cycles", flush=True)
                    continue
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
