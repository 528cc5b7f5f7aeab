#!/usr/bin/env python3
"""The measurements behind K2's and K5's designs, on one NVIDIA GPU.

    python3 scripts/ablate_k2_k5_torch.py [--parent DIR]

Full default SDF width, random weights from the seed, every variant held
against its plain version and timed by CUDA events in turns (three rounds):

1. K2 (sdf_only_bf16) on the calls that a 512x512 render of view 0 and a
   training step hand it (scripts/torch_main_path_calls.py): as built (two
   consumer warpgroups of 64 rows and a producer warpgroup an SM, wgmma on
   a ring of bulk-copied k-tiles, the warpgroups taking turns at the
   tensor cores, one product in flight behind the one issued); copies of
   its kernel, edited, in a copy of csrc/fused_sdf.cu: the warpgroups in
   lockstep (no turns); 2 and 4 products in flight; a 2-CTA cluster that
   multicasts each k-tile into both CTAs' rings (256 rows a weight read),
   with turns and in lockstep; a 2-CTA cluster without multicast (each CTA
   its own stream); no weight stream past the first ring (the products run
   on stale k-tiles: wrong values, not held, the time of everything but
   the stream); each CTA reading one of 8 copies of the weights (fewer
   SMs on each L2 line); K2 on K1's evaluation (k1::eval_tile: mma.sync,
   ldmatrix, the register B stream, two 64-row CTAs an SM), a kernel added
   to that copy; and, with --parent, the K2 of another checkout (the
   parent commit unpacked with `git archive`).  Held: within 5e-3 of
   sdf_only_bf16_plain (chip_smoke.py's BF16_REORDER_TOL).
2. K5 (sdf_full) on the sweep's 262,144 points uniform in [-1, 1]^3: as
   built (96-row tiles), at 64 and 128 rows (a copy of
   csrc/fused_sdf_grad.cu that builds those heights too), and, with
   --parent, the parent's K5.  Held: within 2e-5 of sdf_full_plain
   (K5_TOL).
3. With --parent, K1 (coarse_march) on the same recorded marches as the
   parent's K1: the outputs bit for bit, and both times.

Prints the card's name and power limit, each build's ptxas registers and
spills, then one JSON line per reading.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- the multicast variant of K2: a copy of the kernel, edited ----
K2_BEGIN = "// wg: the swizzled k-tiles of the hidden layers in layer order (n_ktiles of\n"
K2_END = "// ---------------------------------------------------------------------------\n// K1, the coarse march."
MC_HELPERS = r'''
// Arrive on the barrier at the address of *bar in block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(bar)),
               "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}
// One bulk copy into the same offset of every block of the cluster in mask.
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src, unsigned bytes,
                                                    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}
'''
MC_EDITS = [
    ("  const int tiles = (n + TILE - 1) / TILE;\n",
     "  const int tiles = (n + TILE - 1) / TILE;\n"
     "  const int rank = cluster_rank(), groups = (tiles + 1) / 2;\n"),
    ("      mbar_init(&sm.empty[s], CONSUMERS);   // a thread of each consumer warpgroup\n",
     "      mbar_init(&sm.empty[s], 2 * CONSUMERS);\n"),
    ("    mbar_init_fence();\n  }\n  __syncthreads();\n",
     "    mbar_init_fence();\n  }\n  cluster_sync();\n"),
    ("      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n        for (int k = 0;",
     "      for (int grp = blockIdx.x / 2; grp < groups; grp += gridDim.x / 2) {\n"
     "        for (int k = 0;"),
    ("          bulk_load(sm.ring[s], wg + (size_t)k * KT_BYTES, KT_BYTES, &sm.full[s]);\n",
     "          if (k % 2 == rank)\n"
     "            bulk_load_multicast(sm.ring[s], wg + (size_t)k * KT_BYTES, KT_BYTES, &sm.full[s], 3);\n"),
    ("    }\n  } else {\n    // ---- a consumer warpgroup",
     "    }\n    cluster_sync();\n  } else {\n    // ---- a consumer warpgroup"),
    ("      if (wtid == 0) mbar_arrive(&sm.empty[ck % STAGES]);\n",
     "      if (wtid % 64 == 0) mbar_arrive_cluster(&sm.empty[ck % STAGES], wtid / 64);\n"),
    ("    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n      const int row0",
     "    for (int grp = blockIdx.x / 2; grp < groups; grp += gridDim.x / 2) {\n"
     "      const int tile = 2 * grp + rank;\n      const int row0"),
    ("      if (t == 0 && r + 8 < n) out[r + 8] = (s1 + b_last) * inv_scale;\n    }\n  }\n}\n",
     "      if (t == 0 && r + 8 < n) out[r + 8] = (s1 + b_last) * inv_scale;\n    }\n"
     "    cluster_sync();\n  }\n}\n"),
]
# the warpgroups in lockstep: no turns at the tensor cores
LOCKSTEP_EDITS = [
    ("    if (wgi == 1) named_arrive(3, 256);\n", ""),
    ("        named_sync(3 + wgi, 256);   // this warpgroup's turn\n", ""),
    ("        named_arrive(4 - wgi, 256);   // the other warpgroup's turn\n", ""),
]
INFLIGHT = "    constexpr int INFLIGHT = 1;   // products in flight behind the one issued\n"
K2_VARIANTS = {"mc": MC_EDITS, "lockstep": LOCKSTEP_EDITS,   # kernel suffix: edits
               "inflight2": [(INFLIGHT, INFLIGHT.replace("= 1", "= 2"))],
               "inflight4": [(INFLIGHT, INFLIGHT.replace("= 1", "= 4"))],
               "mclock": MC_EDITS + LOCKSTEP_EDITS, "cl2": [],
               # no weight stream past the first ring: the products run on
               # stale k-tiles (wrong values, unchecked): the time of all but
               # the stream
               "nostream": [("          mbar_arrive_expect_tx(&sm.full[s], KT_BYTES);\n"
                             "          bulk_load(sm.ring[s], wg + (size_t)k * KT_BYTES, KT_BYTES, &sm.full[s]);\n",
                             "          if (c >= STAGES) {\n            mbar_arrive(&sm.full[s]);\n"
                             "            continue;\n          }\n"
                             "          mbar_arrive_expect_tx(&sm.full[s], KT_BYTES);\n"
                             "          bulk_load(sm.ring[s], wg + (size_t)k * KT_BYTES, KT_BYTES, &sm.full[s]);\n")],
               # each CTA reads copy blockIdx % 8 of the weights
               "spread": [("          bulk_load(sm.ring[s], wg + (size_t)k * KT_BYTES, KT_BYTES, &sm.full[s]);\n",
                           "          bulk_load(sm.ring[s], wg + ((size_t)(blockIdx.x % 8) * n_ktiles + k) * KT_BYTES,\n"
                           "                    KT_BYTES, &sm.full[s]);\n")]}
# ---- K2 on K1's evaluation, and the launchers of the variants ----
NS_END = "\n}  // namespace\n\nextern \"C\" {\n"
K1BODY = r'''
__global__ void __launch_bounds__(THREADS, 2)
k2_k1body_kernel(const float* __restrict__ x, int n, const __grid_constant__ k1::Args p,
                 float* __restrict__ out) {
  using namespace k1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  for (int tile = blockIdx.x; tile * ROWS < n; tile += gridDim.x) {
    const int row0 = tile * ROWS;
    for (int i = threadIdx.x; i < ROWS * 3; i += THREADS) {
      const int r = i / 3, j = i % 3;
      sm.y[r][j] = (row0 + r < n) ? x[(size_t)(row0 + r) * 3 + j] * p.scale : 0.0f;
    }
    __syncthreads();
    eval_tile(sm, p);
    if (threadIdx.x < ROWS && row0 + (int)threadIdx.x < n)
      out[row0 + threadIdx.x] = sm.out[threadIdx.x] * p.inv_scale;
    __syncthreads();
  }
}
'''
LAUNCHER = r'''
extern "C" int iron_k2_SUFFIX_clusters() {
  const int smem = (int)sizeof(k2::Smem) + 1024;
  if (cudaFuncSetAttribute(sdf_only_bf16_SUFFIX_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(k2::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int held = 0;
  if (cudaOccupancyMaxActiveClusters(&held, sdf_only_bf16_SUFFIX_kernel, &cfg) != cudaSuccess)
    return -1;
  return held;
}
extern "C" int iron_k2_SUFFIX(const float* x, int n, const void* wg, int n_ktiles,
                              const float* bias, const void* wlast, int n_layers, int skip,
                              int d_embed, float scale, float* out, int clusters, void* stream) {
  const int smem = (int)sizeof(k2::Smem) + 1024;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(CL * clusters, 1, 1);
  cfg.blockDim = dim3(k2::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, sdf_only_bf16_SUFFIX_kernel, x, n,
                                     (const unsigned char*)wg, n_ktiles, bias,
                                     (const __nv_bfloat16*)wlast, n_layers, skip, d_embed, scale,
                                     1.0f / scale, out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
'''
K1BODY_LAUNCHER = r'''
extern "C" int iron_k2_k1body(const float* x, int n, const void* wpack, int n_ktiles,
                              const float* bias, const void* wlast, int n_layers, int skip,
                              int d_embed, float scale, float* out, int ctas, void* stream) {
  const int smem = (int)sizeof(k1::Smem);
  cudaError_t e = cudaFuncSetAttribute(k2_k1body_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const k1::Args p = {nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0.0f,
                      (const uint2*)wpack, n_ktiles, bias, (const __nv_bfloat16*)wlast,
                      n_layers, skip, d_embed, scale, 1.0f / scale, nullptr, nullptr, nullptr,
                      nullptr, nullptr, nullptr};
  k2_k1body_kernel<<<ctas, THREADS, smem, (cudaStream_t)stream>>>(x, n, p, out);
  return (int)cudaGetLastError();
}
'''
CLUSTER_OF = {"mc": 2, "lockstep": 1, "inflight2": 1, "inflight4": 1, "mclock": 2, "cl2": 2,
              "nostream": 1, "spread": 1}
# K5 at the tile heights it is not built for: 64 and 128 rows
K5_HEIGHTS = ("  if (rows == 96) IRON_FULL(6);\n",
              "  if (rows == 96) IRON_FULL(6);\n  if (rows == 64) IRON_FULL(4);\n"
              "  if (rows == 128) IRON_FULL(8);\n")
BF16_REORDER_TOL = 5e-3
K5_TOL = 2e-5


def variant_source(text: str) -> str:
    """csrc/fused_sdf.cu with K2's variants (copies of its kernel, edited
    and renamed) and K2 on K1's evaluation added; the built kernels are
    unchanged."""
    if text.count(K2_BEGIN) != 1 or text.count(K2_END) != 1 or text.count(NS_END) != 1:
        raise SystemExit("K2's or K1's markers not found in fused_sdf.cu")
    kernel = text[text.index(K2_BEGIN):text.index(K2_END)]
    copies, launchers = MC_HELPERS, K1BODY_LAUNCHER
    for suffix, edits in K2_VARIANTS.items():
        k = kernel.replace("sdf_only_bf16_kernel(", f"sdf_only_bf16_{suffix}_kernel(")
        for a, b in edits:
            if k.count(a) != 1:
                raise SystemExit(f"marker not found once in K2: {a[:60]!r}")
            k = k.replace(a, b)
        copies += k
        launchers += LAUNCHER.replace("SUFFIX", suffix).replace("CL", str(CLUSTER_OF[suffix]))
    text = text.replace(K2_END, copies + K2_END)
    return text.replace(NS_END, "\n" + K1BODY + "\n}  // namespace\n" + launchers
                        + '\nextern "C" {\n')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout whose K1, K2 and K5 are timed beside this one's")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible: this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from chip_smoke import card_line, cuda_ms
    from iron_tpu_torch.fields.sdf import SDFConfig, init_sdf
    from iron_tpu_torch.kernels import build
    from iron_tpu_torch.kernels import fused_sdf as K
    from iron_tpu_torch.kernels import fused_sdf_grad as K3
    from torch_main_path_calls import main_path_calls

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tmp = tempfile.mkdtemp()
    try:
        srcs = [("variants", os.path.join(tmp, "variants", "fused_sdf.cu"))]
        shutil.copytree(build.CSRC, os.path.dirname(srcs[0][1]))
        with open(srcs[0][1]) as f:
            text = variant_source(f.read())
        with open(srcs[0][1], "w") as f:
            f.write(text)
        path = os.path.join(tmp, "variants", "fused_sdf_grad.cu")
        with open(path) as f:
            text = f.read()
        if text.count(K5_HEIGHTS[0]) != 1:
            raise SystemExit("K5's dispatch not found in fused_sdf_grad.cu")
        with open(path, "w") as f:
            f.write(text.replace(*K5_HEIGHTS))
        srcs.append(("K5 heights", path))
        if args.parent:
            pc = os.path.join(args.parent, "iron_tpu_torch", "kernels", "csrc")
            srcs += [("parent", os.path.join(pc, "fused_sdf.cu")),
                     ("parent K5", os.path.join(pc, "fused_sdf_grad.cu"))]
        running = [(name, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(tmp, f"lib{i}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for i, (name, path) in enumerate(srcs)]
        built = build.build_all()
        print(json.dumps({"built": built}), flush=True)
        for line in build.ptxas_reports():
            if "sdf_only_bf16" in line or "ELi1ELb0E" in line:
                print(json.dumps({"ptxas": line}), flush=True)
        libs = {}
        for i, (name, p) in enumerate(running):
            log, _ = p.communicate()
            if p.returncode:
                raise SystemExit(f"nvcc failed for {name}:\n{log}")
            libs[name] = ctypes.CDLL(os.path.join(tmp, f"lib{i}.so"))
            for ln in build.ptxas_lines(log):
                if "sdf_only_bf16" in ln or "ELi1ELb0E" in ln:   # K2's copies, K5's heights
                    print(json.dumps({"ptxas": f"{name}: {ln}"}), flush=True)

        mp = main_path_calls()
        v = libs["variants"]
        held = {}
        for suffix, cl in CLUSTER_OF.items():
            getattr(v, f"iron_k2_{suffix}_clusters").restype = I
            f = getattr(v, f"iron_k2_{suffix}")
            f.argtypes, f.restype = [P, I, P, I, P, P, I, I, I, F, P, I, P], I
            held[suffix] = getattr(v, f"iron_k2_{suffix}_clusters")()
        v.iron_k2_k1body.argtypes = [P, I, P, I, P, P, I, I, I, F, P, I, P]
        v.iron_k2_k1body.restype = I
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        print(json.dumps({"K2 variants, clusters held": held}), flush=True)

        def k2_variants(w):
            nkt = w.wgpack.numel() // (16 * K.HID)

            def copy_of(suffix):
                f, cl = getattr(v, f"iron_k2_{suffix}"), CLUSTER_OF[suffix]
                wgp = w.wgpack.repeat(8) if suffix == "spread" else w.wgpack

                def run(x):
                    out = torch.empty(x.shape[0], device=dev)
                    clusters = max(1, min(held[suffix], -(-x.shape[0] // (K.K2_ROWS * cl))))
                    code = f(x.data_ptr(), x.shape[0], wgp.data_ptr(), nkt,
                             w.bias_flat.data_ptr(), w.wlast.data_ptr(), w.n_layers, w.skip,
                             w.d_embed, w.scale, out.data_ptr(), clusters, None)
                    if code:
                        raise SystemExit(f"K2 {suffix}: launch failed ({code})")
                    return out
                return run

            def k1body(x):
                out = torch.empty(x.shape[0], device=dev)
                code = v.iron_k2_k1body(x.data_ptr(), x.shape[0], w.wpack.data_ptr(),
                                        w.wpack.numel() // (16 * K.HID), w.bias_flat.data_ptr(),
                                        w.wlast.data_ptr(), w.n_layers, w.skip, w.d_embed,
                                        w.scale, out.data_ptr(), 2 * sms, None)
                if code:
                    raise SystemExit(f"K2 on K1's body: launch failed ({code})")
                return out

            out = {"as built": lambda x: K.sdf_only_bf16(w, x),
                   "warpgroups in lockstep (no turns)": copy_of("lockstep"),
                   "2 products in flight": copy_of("inflight2"),
                   "4 products in flight": copy_of("inflight4"),
                   "multicast, 2-CTA clusters": copy_of("mc"),
                   "multicast, 2-CTA clusters, lockstep": copy_of("mclock"),
                   "2-CTA clusters, no multicast": copy_of("cl2"),
                   "no weight stream (stale k-tiles, unchecked)": copy_of("nostream"),
                   "8 copies of the weights": copy_of("spread"),
                   "on K1's evaluation, 2 CTAs an SM": k1body}
            if "parent" in libs:
                f = libs["parent"].iron_sdf_only_bf16
                f.argtypes, f.restype = [P, I, P, P, P, I, I, I, F, P, P], I

                def parent(x):
                    o = torch.empty(x.shape[0], device=dev)
                    code = f(x.data_ptr(), x.shape[0], w.wpack.data_ptr(), w.bias_flat.data_ptr(),
                             w.wlast.data_ptr(), w.n_layers, w.skip, w.d_embed, w.scale,
                             o.data_ptr(), None)
                    if code:
                        raise SystemExit(f"parent K2: launch failed ({code})")
                    return o
                out["parent"] = parent
            return out

        # ---- 1. K2 ----
        k2_inputs = [(f"512x512 view call {i}", c)
                     for i, c in enumerate(mp["view"]["sdf_only_bf16"])]
        k2_inputs += [(f"step call {i}", c) for i, c in enumerate(mp["step"]["sdf_only_bf16"])]
        for label, (w, x) in k2_inputs:
            x = x.reshape(-1, 3).contiguous()
            ref = K.sdf_only_bf16_plain(w, x)
            variants = k2_variants(w)
            errs = {}
            for name, run in variants.items():
                got = run(x)
                torch.cuda.synchronize()
                errs[name] = float((got - ref).abs().max())
                if not errs[name] <= BF16_REORDER_TOL and "unchecked" not in name:
                    raise SystemExit(f"K2 {name} on {label}: error {errs[name]}")
            times = {name: [] for name in variants}
            for _ in range(3):
                for name, run in variants.items():
                    times[name].append(cuda_ms(lambda: run(x), iters=20))
            for name in variants:
                print(json.dumps({"kernel": "K2", "call": label, "points": x.shape[0],
                                  "variant": name, "ms": times[name],
                                  "max_abs_err": errs[name]}), flush=True)

        # ---- 2. K5 ----
        net = init_sdf(SDFConfig(), torch.Generator(device=dev).manual_seed(0), device=dev)
        w3 = K3.prepare_grad_weights(net)
        x = torch.as_tensor(np.random.default_rng(7).uniform(-1, 1, size=(262144, 3))
                            .astype(np.float32), device=dev)
        ref = K3.sdf_full_plain(w3, x)
        chosen = K3.K5_ROWS

        lib5 = libs["K5 heights"]

        def k5_at(rows):
            def run():
                built, built_held = build._LIBS["fused_sdf_grad"], K3._K5_HELD
                build._LIBS["fused_sdf_grad"], K3._K5_HELD, K3.K5_ROWS = lib5, {}, rows
                try:
                    return K3.sdf_full(w3, x)
                finally:
                    build._LIBS["fused_sdf_grad"], K3._K5_HELD = built, built_held
                    K3.K5_ROWS = chosen
            return run

        variants = {f"{chosen}-row tiles (as built)": lambda: K3.sdf_full(w3, x)}
        variants.update({f"{rows}-row tiles": k5_at(rows) for rows in (64, 128)})
        if "parent K5" in libs:
            f5 = libs["parent K5"].iron_sdf_full
            f5.argtypes, f5.restype = [P, I, P, P, I, I, I, I, F, P, P], I

            def parent5():
                o = torch.empty((x.shape[0], w3.d_out), device=dev)
                code = f5(x.data_ptr(), x.shape[0], w3.wfwd.data_ptr(), w3.bias_flat.data_ptr(),
                          w3.n_layers, w3.skip, w3.d_embed, w3.d_out, w3.scale, o.data_ptr(), None)
                if code:
                    raise SystemExit(f"parent K5: launch failed ({code})")
                return o
            variants["parent"] = parent5
        errs = {}
        for name, run in variants.items():
            got = run()
            torch.cuda.synchronize()
            errs[name] = float((got - ref).abs().max())
            if not errs[name] <= K5_TOL:
                raise SystemExit(f"K5 {name}: error {errs[name]}")
        times = {name: [] for name in variants}
        for _ in range(3):
            for name, run in variants.items():
                times[name].append(cuda_ms(run, iters=5))
        for name in variants:
            print(json.dumps({"kernel": "K5", "points": x.shape[0], "variant": name,
                              "chosen": f"{chosen}-row tiles", "ms": times[name],
                              "max_abs_err": errs[name]}), flush=True)

        # ---- 3. K1 against the parent's, bit for bit ----
        if "parent" in libs:
            f1 = libs["parent"].iron_coarse_march_bf16
            f1.argtypes = [P, P, P, P, P, I, I, F, P, I, P, P, I, I, I, F, P, P, P, P, P, I, P]
            f1.restype = I
            lp = libs["parent"]
            lp.iron_coarse_march_ctas.restype = I
            card = lp.iron_coarse_march_ctas()
            k1_inputs = [(f"step call {i}", c) for i, c in enumerate(mp["step"]["coarse_march"])]
            k1_inputs.append(("512x512 view call 0", mp["view"]["coarse_march"][0]))
            for label, c in k1_inputs:
                w, (ro, rd, acc0, work, max_dis, n_iters), thr = c[0], c[1:-1], c[-1]
                ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
                n = ro.shape[0]
                a0 = acc0.reshape(-1).contiguous()
                md = torch.broadcast_to(max_dis, work.shape).reshape(-1).contiguous()
                wk = work.reshape(-1).to(torch.uint8).contiguous()

                def parent1():
                    acc, s = torch.empty(n, device=dev), torch.empty(n, device=dev)
                    act = torch.empty(n, device=dev, dtype=torch.uint8)
                    lists = torch.empty(2 * n, device=dev, dtype=torch.int32)
                    counts = torch.zeros(n_iters + 2, device=dev, dtype=torch.int32)
                    code = f1(ro.data_ptr(), rd.data_ptr(), a0.data_ptr(), wk.data_ptr(),
                              md.data_ptr(), n, n_iters, thr, w.wpack.data_ptr(),
                              w.wpack.numel() // (16 * K.HID), w.bias_flat.data_ptr(),
                              w.wlast.data_ptr(), w.n_layers, w.skip, w.d_embed, w.scale,
                              acc.data_ptr(), s.data_ptr(), act.data_ptr(), lists.data_ptr(),
                              counts.data_ptr(), K.k1_ctas(n, card), None)
                    if code:
                        raise SystemExit(f"parent K1: launch failed ({code})")
                    return act.bool(), acc, s

                def built1():
                    return K.coarse_march(w, ro, rd, a0, work.reshape(-1), md, n_iters, thr)

                a, b = parent1(), built1()
                torch.cuda.synchronize()
                same = all(torch.equal(p.reshape(-1), q.reshape(-1)) for p, q in zip(a, b))
                times = {"parent": [], "as built": []}
                for _ in range(3):
                    times["parent"].append(cuda_ms(parent1, iters=5))
                    times["as built"].append(cuda_ms(built1, iters=5))
                print(json.dumps({"kernel": "K1", "call": label, "rays": n,
                                  "bit_equal_to_parent": same, "ms": times}), flush=True)
                if not same:
                    raise SystemExit(f"K1 on {label}: outputs differ from the parent's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
