#!/usr/bin/env python3
"""The measurements behind K1's and K3-fwd's designs, on one NVIDIA GPU.

    python3 scripts/ablate_k1_k3_torch.py [--parent DIR]

On the inputs that a training step and a 512x512 render of view 0 hand the
two kernels (scripts/torch_main_path_calls.py), full default SDF width,
random weights from the seed, each variant held against its plain version
and timed by CUDA events in turns (three rounds):

1. K1 (coarse_march), built from edited copies of csrc/fused_sdf.cu: the
   source as it is; a degree-7 polynomial on the FMA pipe in place of the
   SFU's log in the softplus; the precise libm softplus; B fragments 2 and
   8 k-tiles ahead (4 as built);
   one CTA an SM (__launch_bounds__(256, 1), in place of two); and, with
   --parent, the K1
   of another checkout (the parent commit unpacked with `git archive`): one
   64-ray block a tile that marches until its slowest ray stops, no
   compaction.  Held: the active masks agree with the plain version's on
   99.9% of the rays.
2. K3-fwd (sdf_value_feat_grad_fwd): every (rows, width) that the kernel
   is built for on each step call; from edited copies of
   csrc/fused_sdf_grad.cu, sigmoid(100 z) always in the global scratch (as
   built, in shared memory where it fits), a B prefetch of 4 k-steps at width 1 (2 as
   built), no L2 prefetch of the sigmoid store before the u-chain's
   products, and every pass summed into one accumulator (as built, each
   k-step's three passes go to a fresh accumulator added by an f32 add);
   and, with --parent, the parent's K3-fwd (f32 on the CUDA cores).  Held:
   value, features and gradient within 1e-5 + 1e-5 x the largest |plain|
   of each (the kernel as built must hold; each variant's largest error
   over that tolerance is printed).

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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SP_FAST = ("          store_pair(k4::softplus100_fast(acc[m][j][2 * half] * post + b0),\n"
           "                     k4::softplus100_fast(acc[m][j][2 * half + 1] * post + b1),")
EVAL_NOTE = "// sm.out[r] = sdf(sm.y[r]) * scale for the tile's 64 rows;"
LOG1P_POLY = """// log(1 + e), e in [0, 1]: degree 7, within 3e-7 (least squares on Chebyshev nodes)
__device__ __forceinline__ float softplus100_poly(float z) {
  const float t = 100.0f * z, e = __expf(-fabsf(t));
  float r = 0.010243828408420086f;
  r = fmaf(r, e, -0.053267478942871094f);
  r = fmaf(r, e, 0.13198965787887573f);
  r = fmaf(r, e, -0.22396689653396606f);
  r = fmaf(r, e, 0.327511727809906f);
  r = fmaf(r, e, -0.4993339478969574f);
  r = fmaf(r, e, 0.9999702572822571f);
  return (fmaxf(t, 0.0f) + fmaf(r, e, 2.2159764512252877e-07f)) * 0.01f;
}
"""
PRECISE_SOFTPLUS = """// softplus(100 z) / 100 with precise libm calls
__device__ __forceinline__ float softplus100(float z) {
  const float t = 100.0f * z;
  return (fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)))) / 100.0f;
}

"""
PF_LINE = "constexpr int PF = 4;   // k-tiles of B fragments in flight\n"
BOUNDS = "__global__ void __launch_bounds__(THREADS, 2)\ncoarse_march_kernel("
K1_VARIANTS = {
    "as built": [],
    "polynomial log1p": [(SP_FAST, SP_FAST.replace("k4::softplus100_fast(", "softplus100_poly(")),
                         (EVAL_NOTE, LOG1P_POLY + EVAL_NOTE)],
    "precise softplus": [(SP_FAST, SP_FAST.replace("k4::softplus100_fast(", "softplus100(")),
                         ("namespace k4 {\n", PRECISE_SOFTPLUS + "namespace k4 {\n")],
    "PF 2": [(PF_LINE, PF_LINE.replace("PF = 4", "PF = 2"))],
    "PF 8": [(PF_LINE, PF_LINE.replace("PF = 4", "PF = 8"))],
    "1 CTA an SM": [(BOUNDS, BOUNDS.replace("(THREADS, 2)", "(THREADS, 1)"))],
    "PF 8, 1 CTA an SM": [(PF_LINE, PF_LINE.replace("PF = 4", "PF = 8")),
                          (BOUNDS, BOUNDS.replace("(THREADS, 2)", "(THREADS, 1)"))],
    "PF 16, 1 CTA an SM": [(PF_LINE, PF_LINE.replace("PF = 4", "PF = 16")),
                           (BOUNDS, BOUNDS.replace("(THREADS, 2)", "(THREADS, 1)"))],
}
K3F_BUILDS = [(64, 1), (32, 2), (48, 2), (64, 2), (16, 4), (32, 4), (48, 4), (64, 4)]
K3F_PF = "  constexpr int PF = NJ >= 4 ? 2 : 8;\n"
K3F_FITS = "  return fwd_smem(rows / 16, width, n_layers, true) <= (size_t)optin ? 1 : 0;\n"
K3F_L2 = "      if (!sp_on_chip) {\n#pragma unroll\n        for (int j = 0; j < NJ; ++j)\n"
K3F_PART = ("          float part[MT][4] = {};\n          mma3_tf32(part, ah, al, bb);\n#pragma unroll\n"
            "          for (int m = 0; m < MT; ++m)\n#pragma unroll\n"
            "            for (int e = 0; e < 4; ++e) acc[j][m][e] += part[m][e];\n")
K3F_VARIANTS = {
    "prefetch 4 at width 1": [(K3F_PF, K3F_PF.replace("? 2 :", "? 4 :"))],
    "no L2 prefetch of the sigmoid store": [(K3F_L2, K3F_L2.replace("!sp_on_chip", "false"))],
    "sigmoid in global scratch": [(K3F_FITS, "  return 0;\n")],
    "one accumulator": [(K3F_PART, "          mma3_tf32(acc[j], ah, al, bb);\n")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout whose K1 and K3-fwd are timed beside this one's")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible: this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from chip_smoke import card_line, cuda_ms
    from iron_tpu_torch.kernels import build
    from iron_tpu_torch.kernels import fused_sdf as K
    from iron_tpu_torch.kernels import fused_sdf_grad as K3
    from torch_main_path_calls import main_path_calls

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    thr = 2e-2
    mp = main_path_calls()
    tmp = tempfile.mkdtemp()
    try:
        procs = []
        for name, edits in K1_VARIANTS.items():
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
        for name, edits in K3F_VARIANTS.items():
            src = os.path.join(tmp, f"v{len(procs)}")
            shutil.copytree(build.CSRC, src)
            path = os.path.join(src, "fused_sdf_grad.cu")
            text = open(path).read()
            for a, b in edits:
                if a not in text:
                    raise SystemExit(f"marker not found in fused_sdf_grad.cu: {a[:60]!r}")
                text = text.replace(a, b)
            open(path, "w").write(text)
            procs.append((f"K3-fwd {name}", path))
        if args.parent:
            pc = os.path.join(args.parent, "iron_tpu_torch", "kernels", "csrc")
            procs += [("parent", os.path.join(pc, "fused_sdf.cu")),
                      ("parent K3", os.path.join(pc, "fused_sdf_grad.cu"))]
        running = [(name, path, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(tmp, f"lib{i}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for i, (name, path) in enumerate(procs)]
        libs = {}
        for i, (name, path, p) in enumerate(running):
            log, _ = p.communicate()
            if p.returncode:
                raise SystemExit(f"nvcc failed for {name}:\n{log}")
            libs[name] = ctypes.CDLL(os.path.join(tmp, f"lib{i}.so"))
            regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "registers" in ln]
            print(json.dumps({"variant": name, "ptxas": regs[-8:]}), flush=True)

        # ---- 1. K1 ----
        def k1_call(name, lib):
            f = lib.iron_coarse_march_bf16
            f.restype = I
            if name == "parent":
                f.argtypes = [P, P, P, P, P, I, I, F, P, P, P, I, I, I, F, P, P, P, P]
            else:
                f.argtypes = [P, P, P, P, P, I, I, F, P, I, P, P, I, I, I, F, P, P, P, P, P, I, P]
                lib.iron_coarse_march_ctas.restype = I
                card = lib.iron_coarse_march_ctas()

            def run(w, ro, rd, acc0, work, max_dis, n_iters):
                ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
                n = ro.shape[0]
                a0 = acc0.reshape(-1).contiguous()
                md = torch.broadcast_to(max_dis, work.shape).reshape(-1).contiguous()
                wk = work.reshape(-1).to(torch.uint8).contiguous()
                acc, s = torch.empty(n, device=dev), torch.empty(n, device=dev)
                act = torch.empty(n, device=dev, dtype=torch.uint8)
                if name == "parent":
                    code = f(ro.data_ptr(), rd.data_ptr(), a0.data_ptr(), wk.data_ptr(),
                             md.data_ptr(), n, n_iters, thr, w.wpack.data_ptr(),
                             w.bias_flat.data_ptr(), w.wlast.data_ptr(), w.n_layers, w.skip,
                             w.d_embed, w.scale, acc.data_ptr(), s.data_ptr(), act.data_ptr(),
                             None)
                else:
                    lists = torch.empty(2 * n, device=dev, dtype=torch.int32)
                    lib.iron_coarse_march_places.restype = I
                    counts = torch.zeros(n_iters + 2 + lib.iron_coarse_march_places(), device=dev,
                                         dtype=torch.int32)
                    code = f(ro.data_ptr(), rd.data_ptr(), a0.data_ptr(), wk.data_ptr(),
                             md.data_ptr(), n, n_iters, thr, w.wpack.data_ptr(),
                             w.wpack.numel() // (16 * K.HID), w.bias_flat.data_ptr(),
                             w.wlast.data_ptr(), w.n_layers, w.skip, w.d_embed, w.scale,
                             acc.data_ptr(), s.data_ptr(), act.data_ptr(), lists.data_ptr(),
                             counts.data_ptr(), K.k1_ctas(n, card), None)
                if code != 0:
                    raise SystemExit(f"K1 {name}: launch failed ({code})")
                return act.bool(), acc, s
            return run

        k1 = {name: k1_call(name, lib) for name, lib in libs.items()
              if name != "parent K3" and not name.startswith("K3-fwd")}
        k1_inputs = [(f"step call {i}", c) for i, c in enumerate(mp["step"]["coarse_march"])]
        k1_inputs.append(("512x512 view call 0", mp["view"]["coarse_march"][0]))
        for label, c in k1_inputs:
            w, margs = c[0], c[1:-1]   # the recorded call ends with the threshold
            ref = K.coarse_march_plain(w, *margs, thr)
            *_, st = K.coarse_march_schedule(w, *margs, thr)
            agree = {}
            for name, run in k1.items():
                got = run(w, *margs)
                torch.cuda.synchronize()
                agree[name] = float((got[0].reshape(-1) == ref[0].reshape(-1)).float().mean())
                if agree[name] < 0.999:
                    raise SystemExit(f"K1 {name} on {label}: active masks agree on {agree[name]}")
            times = {name: [] for name in k1}
            for _ in range(3):
                for name, run in k1.items():
                    times[name].append(cuda_ms(lambda: run(w, *margs), iters=5))
            for name in k1:
                print(json.dumps({"kernel": "K1", "call": label, "variant": name,
                                  "rays": st["rays"], "evaluations": st["evaluations"],
                                  "iterations": st["iterations"], "tile_evals": st["tile_evals"],
                                  "ms": times[name], "masks_agree": agree[name]}), flush=True)

        # ---- 2. K3-fwd ----
        def hold(got, ref, what):
            """The largest error over its tolerance; the kernel as built
            must hold."""
            worst = max(float((a - b).abs().max()) / (1e-5 + 1e-5 * float(b.abs().max()))
                        for a, b in zip(got, ref))
            if what.startswith("as built") and not worst <= 1.0:
                raise SystemExit(f"K3-fwd {what}: error {worst} of the tolerance")
            return worst

        parent3 = None
        if "parent K3" in libs:
            f3 = libs["parent K3"].iron_sdf_value_feat_grad
            f3.restype = I
            f3.argtypes = [P, I, P, P, P, P, I, I, I, I, F, P, P, P, P, I, P]
            blocks = libs["parent K3"].iron_grad_blocks
            blocks.restype, blocks.argtypes = I, [I]

            def parent3(w, x):
                n = x.shape[0]
                wt = torch.cat([m.T.contiguous().reshape(-1) for m in w.mats[:-1]])
                out = (torch.empty(n, device=dev), torch.empty((n, w.d_out - 1), device=dev),
                       torch.empty((n, 3), device=dev))
                grid = max(1, min(-(-n // 64), blocks(sms)))
                scratch = torch.empty(grid * (w.n_layers - 1) * 64 * K.HID, device=dev)
                code = f3(x.data_ptr(), n, w.wfwd.data_ptr(), wt.data_ptr(),
                          w.bias_flat.data_ptr(), w.wlast0.data_ptr(), w.n_layers, w.skip,
                          w.d_embed, w.d_out, w.scale, out[0].data_ptr(), out[1].data_ptr(),
                          out[2].data_ptr(), scratch.data_ptr(), grid, None)
                if code != 0:
                    raise SystemExit(f"parent K3-fwd: launch failed ({code})")
                return out

        chosen = K3.fwd_tiling
        k3_inputs = [(f"step call {i}", c) for i, c in enumerate(mp["step"]["sdf_value_feat_grad_fwd"])]
        k3_inputs.append(("512x512 view, largest call",
                          max(mp["view"]["sdf_value_feat_grad_fwd"], key=lambda c: c[1].numel())))
        lib3 = K3._lib()
        places_of = {vname: {} for vname in K3F_VARIANTS}
        for label, (w, x) in k3_inputs:
            x = x.reshape(-1, 3).contiguous()
            n = x.shape[0]
            ref = K3.sdf_value_feat_grad_plain(w, x)
            variants = {"as built": lambda: K3.sdf_value_feat_grad_fwd(w, x)}
            pick = chosen(n, lambda cs: K3._fwd_place(lib3, dev, 64, cs, w.n_layers, False)[1])
            if n < 64 * sms:   # the step's calls: every built tiling
                for rows, width in K3F_BUILDS:
                    if (rows, width) == pick[:2]:
                        continue
                    held = K3._fwd_place(lib3, dev, rows, width, w.n_layers)[1]
                    til = (rows, width, max(1, min(-(-n // rows), held)))

                    def run(til=til):
                        K3.fwd_tiling = lambda *a: til
                        try:
                            return K3.sdf_value_feat_grad_fwd(w, x)
                        finally:
                            K3.fwd_tiling = chosen
                    variants[f"tiling {til}"] = run
            for vname in K3F_VARIANTS:
                # the variant's library, and its own cache of placements
                def run(vlib=libs[f"K3-fwd {vname}"], places=places_of[vname]):
                    built, built_places = build._LIBS["fused_sdf_grad"], K3._FWD_PLACES
                    build._LIBS["fused_sdf_grad"], K3._FWD_PLACES = vlib, places
                    try:
                        return K3.sdf_value_feat_grad_fwd(w, x)
                    finally:
                        build._LIBS["fused_sdf_grad"], K3._FWD_PLACES = built, built_places
                variants[vname] = run
            if parent3:
                variants["parent"] = lambda: parent3(w, x)
            errs = {}
            for name, run in variants.items():
                got = run()
                torch.cuda.synchronize()
                errs[name] = hold(got, ref, f"{name} on {label}")
            times = {name: [] for name in variants}
            for _ in range(3):
                for name, run in variants.items():
                    times[name].append(cuda_ms(run, iters=5))
            for name in variants:
                print(json.dumps({"kernel": "K3-fwd", "call": label, "points": n,
                                  "chosen_tiling": pick, "variant": name, "ms": times[name],
                                  "max_err_over_tol": errs[name]}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
