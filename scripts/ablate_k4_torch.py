#!/usr/bin/env python3
"""The measurements behind K4's weight path and K3-bwd's tiling, on one
NVIDIA GPU.

    python3 scripts/ablate_k4_torch.py [--parent DIR]

1. K4 variants, each built from an edited copy of csrc/, held against K4's
   plain version (5e-5) and timed by CUDA events in turns (three rounds) on
   1,024, 1,852 and 262,144 points at the full default SDF width (random
   weights): the source as it is; its B prefetch depth (k4::PF, 4) at 2
   and 8; the precise libm softplus in place of the SFU's; and, with --parent, the K4 of another checkout (the parent commit
   unpacked with `git archive`), called on the same packed weights.  Each
   variant's ptxas report (registers, spills) is printed.
2. K3-bwd on the training step's 1,024-point call at the tiling of
   `bwd_tiling` (48-row tiles on 22 clusters of an H100) against 32-row
   tiles on every cluster the card holds and 64-row tiles on 16, in turns,
   each held against its plain version (1e-4 of each leaf's largest entry).
3. The rate at which a CTA streams data from L2 (a 2 MB buffer, 512 KB a
   CTA, 4, 132 and 264 CTAs of 256 threads): __ldg with eight 16-byte
   loads in flight a thread against cp.async into shared rings of 8 and 11
   stages that wait a stage at a time.

Prints the card's name and power limit, then one JSON line per reading.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PF_LINE = "constexpr int PF = 4;                    // k-tiles of B fragments in flight\n"
PRECISE_SOFTPLUS = """// softplus(100 z) / 100 with precise libm calls
__device__ __forceinline__ float softplus100(float z) {
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)))) / 100.0f;
}

"""
VARIANTS = {
    "as built": [],
    "PF 2": [(PF_LINE, PF_LINE.replace("PF = 4", "PF = 2"))],
    "PF 8": [(PF_LINE, PF_LINE.replace("PF = 4", "PF = 8"))],
    "precise softplus": [("          store_split_bf16(softplus100_fast(acc[m][j][2 * half] * post + b0),\n"
                          "                           softplus100_fast(",
                          "          store_split_bf16(softplus100(acc[m][j][2 * half] * post + b0),\n"
                          "                           softplus100("),
                         ("namespace k4 {\n", PRECISE_SOFTPLUS + "namespace k4 {\n")],
}

L2_BENCH = r'''
#include <cstdint>
#include <cuda_runtime.h>
__global__ void ldg_kernel(const uint4* __restrict__ p, size_t nvec, size_t per, unsigned* out) {
  const size_t base = (size_t)blockIdx.x * 4096;
  uint32_t acc = 0;
  for (size_t i = threadIdx.x; i < per; i += 8 * blockDim.x) {
    uint4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(p + (base + i + k * blockDim.x) % nvec);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc ^= v[k].x ^ v[k].w;
  }
  if (acc == 0x12345) out[0] = acc;
}
template <int NS>
__global__ void cpa_kernel(const uint4* __restrict__ p, size_t nvec, size_t per, unsigned* out) {
  __shared__ uint4 ring[NS][256];
  const size_t base = (size_t)blockIdx.x * 4096, steps = per / 256;
  uint32_t acc = 0;
  for (size_t s = 0; s < NS - 1 && s < steps; ++s) {
    const uint4* src = p + (base + s * 256 + threadIdx.x) % nvec;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
        (unsigned)__cvta_generic_to_shared(&ring[s % NS][threadIdx.x])), "l"(src));
    asm volatile("cp.async.commit_group;\n");
  }
  for (size_t s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2));
    __syncthreads();
    const size_t nx = s + NS - 1;
    if (nx < steps) {
      const uint4* src = p + (base + nx * 256 + threadIdx.x) % nvec;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(&ring[nx % NS][threadIdx.x])), "l"(src));
    }
    asm volatile("cp.async.commit_group;\n");
    acc ^= ring[s % NS][(threadIdx.x * 7) % 256].y;
  }
  if (acc == 0x12345) out[0] = acc;
}
// mean ms of 10 launches of `kind` (0 __ldg, 1 cp.async 8 stages, 2 cp.async
// 11 stages) on `grid` CTAs, each reading per_bytes of a buf_bytes buffer
extern "C" float l2_stream_ms(int kind, int grid, size_t buf_bytes, size_t per_bytes) {
  unsigned* out;
  uint4* p;
  cudaMalloc(&out, 4);
  cudaMalloc(&p, buf_bytes);
  cudaMemset(p, 1, buf_bytes);
  const size_t nvec = buf_bytes / 16, per = per_bytes / 16;
  auto run = [&]() {
    if (kind == 0) ldg_kernel<<<grid, 256>>>(p, nvec, per, out);
    else if (kind == 1) cpa_kernel<8><<<grid, 256>>>(p, nvec, per, out);
    else cpa_kernel<11><<<grid, 256>>>(p, nvec, per, out);
  };
  run();
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int i = 0; i < 10; ++i) run();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = -1.0f;
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, a, b);
  cudaFree(p);
  cudaFree(out);
  return ms / 10;
}
'''


def _ptxas(log: str):
    """{kernel: 'N registers[, spills]'} from nvcc -Xptxas -v output."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and "registers" in ln:
            out[name] = ln.split(":", 1)[-1].strip()
        elif name and "spill" in ln:
            out[name + " spills"] = ln.strip()
    return {k: v for k, v in out.items() if "3pass" in k}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout whose K4 is timed beside this one's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible: this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import card_line, cuda_ms
    from iron_tpu_torch.fields.sdf import SDFConfig, init_sdf
    from iron_tpu_torch.kernels import build
    from iron_tpu_torch.kernels import fused_sdf as K
    from iron_tpu_torch.kernels import fused_sdf_grad as K3

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tmp = tempfile.mkdtemp()
    try:
        procs = []
        for name, edits in VARIANTS.items():
            src = os.path.join(tmp, f"v{len(procs)}")
            shutil.copytree(build.CSRC, src)
            path = os.path.join(src, "fused_sdf.cu")
            text = open(path).read()
            for a, b in edits:
                if a not in text:
                    raise SystemExit(f"marker not found in fused_sdf.cu: {a[:60]!r}")
                text = text.replace(a, b)
            open(path, "w").write(text)
            procs.append((name, path))
        if args.parent:
            procs.append(("parent", os.path.join(args.parent, "iron_tpu_torch", "kernels", "csrc",
                                                 "fused_sdf.cu")))
        l2_src = os.path.join(tmp, "l2_stream.cu")
        open(l2_src, "w").write(L2_BENCH)
        procs.append(("l2", l2_src))
        running = [(name, path, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for name, path in procs]
        libs = {}
        for name, path, p in running:
            log, _ = p.communicate()
            if p.returncode:
                raise SystemExit(f"nvcc failed for {name}:\n{log}")
            libs[name] = ctypes.CDLL(path[:-3] + ".so")
            if name != "l2":
                print(json.dumps({"variant": name, "ptxas": _ptxas(log)}), flush=True)

        # ---- 1. K4 variants ----
        net = init_sdf(SDFConfig(), torch.Generator(device=dev).manual_seed(0), device=dev)
        w4 = K.prepare_3pass_weights(net)
        hi, lo = w4.hi, w4.lo
        n_kt = hi.wpack.numel() // (16 * K.HID)
        rng = np.random.default_rng(1)
        calls = {}
        for name, lib in libs.items():
            if name == "l2":
                continue
            f = lib.iron_sdf_only_3pass
            f.restype = I
            if name == "parent":
                f.argtypes = [P, I, P, P, P, P, P, I, I, I, F, P, P]
                calls[name] = lambda x, out, f=f: f(
                    x.data_ptr(), x.shape[0], hi.wpack.data_ptr(), lo.wpack.data_ptr(),
                    hi.bias_flat.data_ptr(), hi.wlast.data_ptr(), lo.wlast.data_ptr(),
                    hi.n_layers, hi.skip, hi.d_embed, hi.scale, out.data_ptr(), None)
            else:
                f.argtypes = [P, I, P, P, I, P, P, P, I, I, I, F, P, I, P]
                calls[name] = lambda x, out, f=f: f(
                    x.data_ptr(), x.shape[0], hi.wpack.data_ptr(), lo.wpack.data_ptr(), n_kt,
                    hi.bias_flat.data_ptr(), hi.wlast.data_ptr(), lo.wlast.data_ptr(),
                    hi.n_layers, hi.skip, hi.d_embed, hi.scale, out.data_ptr(),
                    K.k4_width(x.shape[0], sms), None)
        for n in (1024, 1852, 262144):
            x = torch.as_tensor((rng.normal(size=(n, 3)) * 0.4).astype(np.float32), device=dev)
            ref = K.sdf_only_3pass_plain(w4, x)
            out = torch.empty(n, device=dev)
            times = {name: [] for name in calls}
            errs = {}
            for name, call in calls.items():
                out.fill_(float("nan"))
                if call(x, out) != 0:
                    raise SystemExit(f"K4 {name}: launch failed")
                torch.cuda.synchronize()
                errs[name] = float((out - ref).abs().max())
                if not errs[name] <= 5e-5:
                    raise SystemExit(f"K4 {name} on {n} points: {errs[name]} from plain")
            for _ in range(3):
                for name, call in calls.items():
                    times[name].append(cuda_ms(lambda: call(x, out), iters=20 if n < 10000 else 5))
            for name in calls:
                print(json.dumps({"kernel": "K4", "variant": name, "points": n,
                                  "width": K.k4_width(n, sms) if name != "parent" else 1,
                                  "ms": times[name], "max_abs_err_vs_plain": errs[name]}),
                      flush=True)

        # ---- 2. K3-bwd tilings on the step's 1,024-point call ----
        w3 = K3.prepare_grad_weights(net)
        n = 1024
        x = torch.as_tensor((rng.normal(size=(n, 3)) * 0.4).astype(np.float32), device=dev)
        cots = [torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev)
                for s in ((n,), (n, w3.d_out - 1), (n, 3))]
        ref = K3.sdf_value_feat_grad_bwd_plain(w3, x, *cots)
        flat = lambda r: [r[2]] + list(r[0]) + list(r[1])
        chosen = K3.bwd_tiling
        cl = K3._lib().iron_grad_bwd_clusters()
        tilings = [chosen(n, cl), (32, cl), (64, -(-n // 64))]
        times = {t: [] for t in tilings}
        try:
            for t in tilings:
                K3.bwd_tiling = lambda n_, c_, t=t: t
                got = K3.sdf_value_feat_grad_bwd(w3, x, *cots)
                rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                          for a, b in zip(flat(got), flat(ref)))
                if not rel <= 1e-4:
                    raise SystemExit(f"K3-bwd at {t}: {rel} from plain")
            for _ in range(3):
                for t in tilings:
                    K3.bwd_tiling = lambda n_, c_, t=t: t
                    times[t].append(cuda_ms(lambda: K3.sdf_value_feat_grad_bwd(w3, x, *cots),
                                            iters=10))
        finally:
            K3.bwd_tiling = chosen
        for t in tilings:
            print(json.dumps({"kernel": "K3-bwd", "points": n, "rows": t[0], "clusters": t[1],
                              "ctas": 4 * t[1], "ms": times[t]}), flush=True)

        # ---- 3. L2 -> SM stream rate ----
        l2 = libs["l2"].l2_stream_ms
        l2.restype, l2.argtypes = F, [I, I, ctypes.c_size_t, ctypes.c_size_t]
        per = 512 << 10
        for grid in (4, 132, 264):
            for kind, label in enumerate(("__ldg x8", "cp.async 8 stages", "cp.async 11 stages")):
                ms = l2(kind, grid, 2 << 20, per)
                print(json.dumps({"l2_stream": label, "ctas": grid, "ms": ms,
                                  "gb_per_s_a_cta": per / ms / 1e6,
                                  "gb_per_s": grid * per / ms / 1e6}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
