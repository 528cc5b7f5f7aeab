#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the full run: 4 views at 512x512, 3 x 38 training steps
    python3 chip_smoke.py --only-8h    # the build, then phase 8h alone (no result line)
    python3 chip_smoke.py --only-8i    # the build, then phase 8i alone (no result line)
    python3 chip_smoke.py --only-8j    # the build, then phase 8j alone (no result line)
    python3 chip_smoke.py --only-8k    # the build, then phase 8k alone (no result line)
    python3 chip_smoke.py --only-8l    # the build, then phase 8l alone (no result line)
    python3 chip_smoke.py --only-8m    # the build, then phase 8m alone (no result line)
    python3 chip_smoke.py --only-8n    # the build, then phase 8n alone (no result line)
    python3 chip_smoke.py --only-8o    # the build, then phase 8o alone (no result line)
    python3 chip_smoke.py --only-8p    # the build, then phase 8p alone (no result line)
    python3 chip_smoke.py --only-8q    # the build, then phase 8q alone (no result line)
    python3 chip_smoke.py --only-8r    # the build, then phase 8r alone (no result line)
    python3 chip_smoke.py --only-8s    # the build, then phase 8s alone (no result line)
    python3 chip_smoke.py --only-8t    # the build, then phase 8t alone (no result line)

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, and drives the port's main
paths at the full default SDF width with random weights from a seed, each
with the launch counts set to 0 just before it and read just after:

  * the stage-2 surface render (Stage2Trainer.render_full, comp renderer):
    it shows that the render launched every kernel of its path, checks the
    render against the same render through the plain versions, and holds
    every kernel against its plain version again on the very inputs the
    render gives it;
  * the same render with Stage2Config.trace_pallas, every accurate trace
    evaluation through K4: its launches, K4 against its plain version on
    every call of a view, the render against the same render through K4's
    plain version and against the render without trace_pallas (128x128);
  * the stage-2 training step at the bench configuration (synthetic sphere,
    4 views at 256x256, 128x128 crops, comp): one step through the kernels
    against the same step through the plain versions (loss and every
    gradient), K3-bwd against its plain version on the inputs that step
    gives it, K1, K2 and K3-fwd against their plain versions on every call
    of a step (with K1's schedule: rays, evaluations, the slowest ray's
    iterations, tile-evaluations), K1's cooperative launch (a grid one CTA
    larger than the card holds is refused, and the step's and the view's
    marches launched beside another stream's ~50 ms kernels give the
    outputs of the same marches alone, bit for bit), then 8 + 30 steps of
    Stage2Trainer.run
    with every kernel of the path launched at every step, finite and
    falling losses, and no plain version reached by a CUDA tensor;
  * the same training with trace_pallas, the dataset's masks and
    silhouette_weight 0.3 (the silhouette sweep runs on K4 too): one step
    against the same step through K4's plain version, then 8 + 30 steps;
  * the SDF sweep of iron_tpu_torch.kernels.make_sdf_fn (K5) on 262,144
    points, held against its plain version and the f32 sdf_apply (also on
    262,144 uniform points in phase 4b);
  * stage 1 (phase 8d, `stage1_phase`): NeuS volume training at the width of
    iron_tpu/configs/womask_iron.json on the same data: one step through K3
    against the same step through its plain versions (loss, metrics, every
    gradient), K3-fwd and K3-bwd on that step's inputs, 8 + 30 steps of
    Stage1Trainer.run (K3-fwd and K3-bwd once a step and nothing else, a
    falling loss, the host syncs of each step), upsample_pallas (K2 four
    times a step, each call held), render_image through K3-fwd alone
    against its plain version, and a stage-1 checkpoint warm-starting a
    Stage2Trainer for one step;
  * the user's run through the CLIs (phase 8e, `cli_phase`), in process
    with --device cuda on the synthetic sphere written as a scene folder (8
    views at 256x256): train_volume with iron_tpu_torch/configs/
    womask_iron.json (40 steps, async checkpoints), validate_mesh at 256,
    train_surface from that checkpoint (40 steps, then the mesh, UV and
    material export at 256), --render_all and evaluate images / mesh /
    relight: each call's kernels launched (every step, view and export),
    no plain version reached by a CUDA tensor, the async checkpoints read
    back bit for bit, the stage-1 SDF adopted bit for bit, the products
    (mesh, atlases, JPEG renders) decoded, PSNR and chamfer finite;
  * the research paths (phase 8f, `research_phase`) on the same data: the
    `multi` and `disney` flavours (a step through the kernels against the
    same step through the plain versions, 20 steps with every kernel of the
    path at every step and a falling loss, a 256x256 render with the
    flavour's buffers), the rgb -> refrac -> env curriculum (10 steps a
    phase, frozen leaves bit-equal, the env phase on env_light_network),
    RGB + NIR stage 1 (20 + 20 steps at the womask_iron width, K3-fwd and
    K3-bwd once a step, 0 host syncs, the idle NIR nets bit-equal through
    the RGB phase, the checkpoint hand-off bit for bit) and the hash-grid
    NeRF runner (30 steps at the default grids, plain PyTorch, a falling
    loss, its memory);
  * data-parallel training and rendering (phase 8g, `dp_phase`,
    iron_tpu_torch/dist/): NCCL at a world of 1 (3 dp steps of each stage
    bit-equal to the single-device trainers'), then two ranks on the one
    card over gloo, subprocesses of this script (`--dp-worker`): 10 stage-1
    steps at Stage1Config()'s width (512 rays split 256 a rank; the first
    step's gradients against the single-device step on the whole batch),
    10 stage-2 steps at the training cell's configuration (the first on one
    crop on both ranks, against the single-device step), the parameters
    bit-equal on both ranks after every step, every kernel of each path
    launched at every step; the dp stage-1 render against render_image and
    the dp band render against render_full;
  * the last slice's paths (phase 8h, `graph_phase`): Stage1Trainer.run in
    chunks, each step of a chunk a replay of the step captured as a CUDA
    graph (8 replays bit-equal to 8 eager steps from the same state with the
    learning rate and the anneal changing on every step, the draws differing
    between replays; a 16-step chunk with the occupancy grid and a chunk
    with upsample_pallas, bit-equal to their eager loops), Stage2Trainer.run
    in chunks of 4 with the crops drawn on the device, the JAX package's
    orbax checkpoints (the committed fixture read by the port's own OCDBT,
    zarr and zstd readers, as this machine has no tensorstore, and
    train_surface warm-started from it), the interpolation video (mp4v in
    an AVI: its structure, and the encoder's reconstruction against the
    frames) and tp = 2 on two gloo ranks of the card, bit-equal to one
    device;
  * a stage-1 run from the image formats the JAX package reads through
    OpenCV (phase 8i, `formats_phase`): tests/data_formats/ (CMYK, lossless
    and arithmetic-coded JPEG views; BMP, TIFF and PGM masks) decoded by the
    port bit-equal to OpenCV's decode recorded beside it, loaded by
    RayDataset.from_folder with its masks, and 8 steps of Stage1Trainer at
    Stage1Config()'s width with K3-fwd and K3-bwd once a step and a falling
    loss on a fixed batch;
  * the same run from WebP and PAM files (phase 8j, `webp_phase`):
    tests/data_webp/ (lossy VP8, VP8X with ALPH and lossless VP8L views
    named .jpg / .png; lossless WebP, PAM and lossy WebP masks) decoded by
    the port bit-equal to OpenCV's decode recorded beside it, then the same
    8 stage-1 steps;
  * the same run from JPEG 2000 files (phase 8k, `jp2_phase`):
    tests/data_jp2/ (an OpenCV .jp2, a tiled 5/3 RCT .jp2 with 3 quality
    layers and a 9/7 ICT raw codestream cut by its rate, named .jpg / .png;
    8- and 16-bit lossless and 8-bit lossy gray masks) decoded by the port
    bit-equal to OpenCV's decode recorded beside it, then the same 8
    stage-1 steps;
  * the same run from TIFF files (phase 8l, `tiff_phase`): tests/data_tiff/
    (YCbCr JPEG-in-TIFF tiles, a BigTIFF float32 view with the
    floating-point predictor and a CMYK LZW view, named .jpg / .png; Group 4,
    Group 3 2D FillOrder 2 and float64 masks) decoded by the port bit-equal
    to OpenCV's decode recorded beside it, then the same 8 stage-1 steps;
  * the image writers and `preprocess` (phase 8m, `writers_phase`):
    preprocess make-masks and apply-alpha on tests/data_preprocess/ (files
    named .png of other contents) leave the JAX package's arrays; the
    images of tests/data_writers/ through every writer give OpenCV's bytes
    or decode to the recorded arrays, or are refused where OpenCV writes
    nothing readable; a 512^2 render of the card through K1, K2 and K3-fwd
    written to every extension and read back, the lossless ones exactly;
  * the .jp2 writer (phase 8n, `writers2_phase`): tests/data_jp2w/ through
    write_image('.jp2') at OpenCV's bytes, and a 512^2 render written as
    .jp2 and read back;
  * a stage-1 run from damaged files (phase 8o, `damaged_phase`):
    tests/data_damaged/ (a baseline JPEG cut in its scan, a progressive one
    cut in a later scan, one with a corrupt restart interval and no EOI)
    decoded by the port bit-equal to OpenCV's decode recorded beside it,
    the damaged files of every other format that OpenCV reads no image
    from refused (NoImage) and skipped by preprocess make-masks, view0's
    cut tail at 128/255 on the card, then the same 8 stage-1 steps;
  * a stage-1 run from the TIFF corners (phase 8p, `tiff_wide_phase`):
    tests/data_tiff_wide/ (12-bit RGB LZW strips, big-endian 10-bit RGB
    Deflate tiles and LogLuv32 views; 16-bit gray of 3 samples, 14-bit
    PackBits and 12-bit FillOrder 2 masks) decoded by the port bit-equal to
    OpenCV's decode recorded beside it, then the same 8 stage-1 steps, and
    both plots (cameras, Fresnel) drawn without matplotlib and read back;
  * a stage-1 run from damaged headers (phase 8q, `header_phase`):
    tests/data_header/ (a JPEG whose JFIF segment is damaged, a lossless
    WebP whose chunk size is short, a Deflate TIFF whose one strip's byte
    count is 0; masks of a short uncompressed strip and a Group 3 strip
    that lost its last EOL) decoded by the port bit-equal to OpenCV's
    decode recorded beside it, a header-damaged file of every format that
    OpenCV refuses raising NoImage and skipped by preprocess make-masks,
    the views and masks on the card bit for bit the host's, then the same
    8 stage-1 steps;
  * a stage-1 run from the JPEG 2000 corners (phase 8r,
    `jp2_corners_phase`): tests/data_jp2_corners/ (views of code-block
    style 0x3F with a POC and tile-parts, 9/7 with RGN and PPM, sYCC; masks
    of BYPASS + TERMALL, a palette and PPT) decoded by the port bit-equal
    to OpenCV's decode recorded beside it, the views and masks on the card
    bit for bit the host's, then the same 8 stage-1 steps;
  * the quality path (phase 8s, `quality_phase`), through its three entry
    points in process: `python -m iron_tpu_torch.eval.e2e_validation --fast
    --independent_gt --silhouette_weight 0.3` on the blobby scene (300 + 150
    steps at 64x64, the held-out views, the materials and the recovered
    mesh against the GT mesh), then `psnr_decomposition --res 64` and
    `relight_eval --res 64 --export_res 64` on its run directory: every
    number of the three reports finite, each stage's loss lower at its last
    logged step than at its first, K1, K2, K3-fwd and K3-bwd launched;
  * the research scripts (phase 8t, `scripts_phase`), through the six
    entry points of iron_tpu_torch/scripts/ in process:
    `singleview_demo --iters 64 --patch 64` (the SDF fitted to the photo of
    tests/data_singleview/), `tracer_budget_coverage --res 64 128`,
    `diag_torus_stage1 200 40`, `diag_torus_stage2 40 2 64` (its regression
    fit cut to 1,000 steps), `silhouette_ab --res 64` with 200 + 40 steps
    and a checkpoint every 20, and `torus_resume_experiment --arm clip
    --iters 20` from the A/B's last checkpoint (its independent-GT torus
    cut to 128x128 views and meshes at 192): every number finite, the
    files written, K1, K2, K3-fwd and K3-bwd launched;

then times each kernel beside its plain version and its bound, and prints:

  * the card's name and power limit (nvidia-smi);
  * one JSON line {"stage1": {...}}: the stage-1 step median, rays/s, host
    syncs a step, and K3-fwd, K3-bwd and K2 at the stage-1 shapes;
  * one JSON line {"cli": {...}}: each CLI call's wall time and launches,
    both trainers' steps/s, the render time a view, the export time at 256,
    PSNR, SSIM and chamfer, and the cuts (40 steps and an export at 256
    instead of 100,001 / 50,001 steps and 512);
  * one JSON line {"research": {...}}: phase 8f's step medians, launches,
    render times, the runner's memory, and its cuts;
  * one JSON line {"dp": {...}}: phase 8g's bit-equality, the step medians
    a rank beside the single-device steps of this call, the all-reduce time
    a step, the launches a rank a step (two processes time-slicing one
    card, gloo through the host: not a multi-GPU speed figure);
  * one JSON line {"graph": {...}}: phase 8h's bit-equality, the eager and
    replayed stage-1 step medians, the kernels a replay ran (counted in
    torch.profiler's device trace: a replay runs no wrapper), the video,
    orbax and tp records;
  * one JSON line {"formats": {...}}: phase 8i's decode times, step times,
    losses and launches, beside the card's name and power limit;
  * one JSON line {"webp": {...}}: the same record of phase 8j;
  * one JSON line {"jp2": {...}}: the same record of phase 8k;
  * one JSON line {"tiff": {...}}: the same record of phase 8l;
  * one JSON line {"writers": {...}}: phase 8m's holds, sizes, the render's
    launches and each extension's write and read times on the host;
  * one JSON line {"writers2": {...}}: phase 8n's holds, the render's
    launches, size, exactness and its .jp2 write and read times on the host;
  * one JSON line {"damaged": {...}}: phase 8o's decode times (the views,
    the refused files), step times, losses and launches;
  * one JSON line {"tiff_wide": {...}}: phase 8p's decode times, step
    times, losses, launches and the plots' sizes and write times;
  * one JSON line {"header": {...}}: phase 8q's decode times (the views and
    masks, the refused files), step times, losses, launches and wall time;
  * one JSON line {"jp2_corners": {...}}: phase 8r's decode times, step
    times, losses, launches and wall time;
  * one JSON line {"quality": {...}}: phase 8s's headline numbers of the
    three reports (held-out PSNR and SSIM, chamfer, light and materials; D,
    B and A; the relit PSNR), the logged losses, the launches of each entry
    point, the walls and the card;
  * one JSON line {"scripts": {...}}: phase 8t's headline numbers of each
    module (the IoU, the coverage shares, the torus diagnostics, the A/B
    trajectories, the resumed chamfers), each module's wall and launches,
    the cuts and the card;
  * one JSON line {"kernels": [...]} on the six kernels (launches: K1-K3
    from the default training run, K4 from the trace_pallas training run,
    K5 from the sweep; beside them each kernel's launches on phase 8f's
    paths, a rank's on phase 8g's and a step's on phase 8h's, a stage-1
    replay's from the device trace, and phases 8j's to 8t's);
  * last, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any failed phase raises, so the script exits non-zero and prints no result.
It imports nothing of JAX.  Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of an H100 SXM at its 700 W limit (dense): HBM bytes/s,
# bf16 and tf32 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
# K2's tolerance against its plain version: the same bf16 arithmetic in
# another f32 sum order, where a sum on a bf16 rounding boundary rounds an
# activation one unit apart, moves the sdf by a few 1e-3 at most.
BF16_REORDER_TOL = 5e-3
# K4's tolerance against its plain version: the same split operands and
# exact bf16 products, f32 sums in another order (tensor-core accumulation
# against cuBLAS), where a sum on a bf16 rounding boundary rounds an
# activation's hi half the other way and its lo half takes the rest up to
# 2^-18 of it: held at the CPU test's tolerance against the JAX kernel.
K4_PLAIN_TOL = 5e-5
# K5's tolerance against its plain version and the f32 sdf_apply: the JAX
# package's hold on its K5 (tests/test_kernels.py), f32 sums in another order.
K5_TOL = 2e-5


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float, flop_rate: float, transcendentals: float):
    """(ms, 'bytes' or 'operations'): the larger of the memory time and the
    operation time; each transcendental counts as one f32 operation."""
    t_bytes = bytes_moved / HBM_BPS
    t_ops = flops / flop_rate + transcendentals / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def sdf_work(sdf_cfg) -> dict:
    """What one point of the SDF needs, from the unpadded layer shapes of
    `sdf_cfg` (the kernels' padding is not counted):

      value:       MACs of the chain to the sdf column alone (K1 / K2; K4
                   does three products of each);
      value_all:   MACs of the chain to all d_out columns (K5);
      value_grad:  value_all plus the reverse sweep u @ W^T through every
                   hidden layer (K3-fwd);
      weights:     weight and bias entries of the value-only chain, and of
                   the full chain;
      transc:      transcendentals: exp and log1p of every hidden unit's
                   softplus (sigmoid(100 z) reuses the exp), sin and cos of
                   the positional encoding."""
    dims = sdf_cfg.dims
    n = len(dims) - 1
    shapes = [(dims[l], dims[l + 1] - dims[0] if (l + 1) in sdf_cfg.skip_in else dims[l + 1])
              for l in range(n)]
    hidden = sum(a * b for a, b in shapes[:-1])
    units = sum(b for _, b in shapes[:-1])
    return {"value": hidden + dims[-2],
            "value_all": hidden + dims[-2] * dims[-1],
            "value_grad": hidden + dims[-2] * dims[-1] + hidden,
            "weights_value": hidden + dims[-2] + units + 1,
            "weights_all": hidden + dims[-2] * dims[-1] + units + dims[-1],
            "transc": 2 * units + 2 * sdf_cfg.multires * sdf_cfg.d_in}


def bwd_work(sdf_cfg) -> dict:
    """What K3-bwd needs a point, on the unpadded chain of `sdf_cfg`: the
    hidden forward and the u-chain recomputed (2 H MACs, H the hidden
    layers' MACs), the adjoint of the u-chain (bar_u_l = bar_vh_l W_l and
    dW_l += bar_vh_l^T u_l: 2 H, plus the final layer's sdf column), and the
    adjoint of the primal chain through every layer (dW_l += a_l^T bz_l and
    bar_a_l = bz_l W_l^T: 2 (H + F), F the final layer's MACs);
    transcendentals as sdf_work counts them."""
    w = sdf_work(sdf_cfg)
    hidden = w["value"] - sdf_cfg.dims[-2]
    final = sdf_cfg.dims[-2] * sdf_cfg.dims[-1]
    return {"macs": 6 * hidden + 2 * final + sdf_cfg.dims[-2], "transc": w["transc"],
            "weights_all": w["weights_all"]}


def ring_cameras(n: int, res: int, dist: float = 3.0):
    """n cameras on a ring at `dist`, slightly raised, looking at the origin
    (OpenCV axes: x right, y down, z forward)."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 1.25 * res
    K[0, 2] = K[1, 2] = res / 2
    Ks, W2Cs = [], []
    for i in range(n):
        th = 2 * np.pi * i / n
        C = dist * np.array([np.sin(th), 0.3, np.cos(th)]) / np.sqrt(1.09)
        z = -C / np.linalg.norm(C)
        down = np.array([0.0, -1.0, 0.0])
        y = down - down.dot(z) * z
        y /= np.linalg.norm(y)
        x = np.cross(y, z)
        R = np.stack([x, y, z])
        W2C = np.eye(4)
        W2C[:3, :3], W2C[:3, 3] = R, -R @ C
        Ks.append(K)
        W2Cs.append(W2C.astype(np.float32))
    return np.stack(Ks), np.stack(W2Cs)


def rays_at_targets(rng, n: int, radius: float, spread: float):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro = (radius * d).astype(np.float32)
    rd = spread * rng.normal(size=(n, 3)) - ro
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


def mask_diff(a: dict, b: dict, key: str):
    """(pixels where two renders' `key` masks differ, pixels set in either)."""
    return int((a[key] != b[key]).sum()), int((a[key] | b[key]).sum())


def on_silhouette(hit: np.ndarray) -> np.ndarray:
    """Pixels whose 3x3 neighbourhood holds both hit and missed pixels."""
    H, W = hit.shape
    p = np.pad(hit, 1, mode="edge")
    win = np.stack([p[i:i + H, j:j + W] for i in range(3) for j in range(3)])
    return win.any(0) & ~win.all(0)


def k2_plain_f64_sums(K12, w, x):
    """K2's plain version with its sums in f64: the same bf16 operands and
    bf16-rounded activations, another sum order and precision."""
    import torch
    pe = K12._pe_bf16(w, x * w.scale).double()
    mats, biases = [m.double() for m in w.mats], [b.double() for b in w.biases]
    h, mi = pe, 0
    for l in range(w.n_layers - 1):
        acc = h @ mats[mi]
        mi += 1
        if l == w.skip:
            acc = (acc + pe @ mats[mi]) * K12.INV_SQRT2
            mi += 1
        h = K12._bf16(K12.softplus100((acc + biases[l]).to(torch.float32))).double()
    return ((h @ mats[-1][:, 0] + biases[-1][0]) / w.scale).to(torch.float32)


class count_syncs:
    """Counts the host syncs of the code inside it, as
    torch.cuda.set_sync_debug_mode('warn') reports them: `n`, and the
    Python lines that made them in `sites`."""

    def __enter__(self):
        import torch
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        hits = [w for w in self._caught if "synchroniz" in str(w.message)]
        self.n = len(hits)
        self.sites = [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in hits]
        return False


def stage1_phase(args, dev, card, data, kernels, K12, K3, PlainCore, leaf_errs, check_k3,
                 check_k3_bwd, refuse, plain_names, tcfg, crop, eik) -> dict:
    """Phase 8d, the stage-1 path at the full width of
    iron_tpu/configs/womask_iron.json (Stage1Config's defaults), the
    warm-up cut to 8 steps so that 38 steps train at the working learning
    rate:

      * one step through the kernels (K3-fwd and K3-bwd once each) against
        the same step, on the same draws, through K3's plain versions: the
        loss and every metric, every gradient leaf of the SDF, colour net,
        variance and NeRF;
      * K3-fwd and K3-bwd against their plain versions on that step's own
        inputs (65,536 points), at phases 4 and 7's holds;
      * Stage1Trainer.run, 8 + args.train_steps steps: finite losses, a
        falling loss, K3-fwd and K3-bwd launched once a step and no other
        kernel, no plain version reached by a CUDA tensor, the host syncs of
        each step (torch.cuda.set_sync_debug_mode);
      * the kernel step again with remat_core (the colour net recomputed
        in the backward): loss, metrics and gradients as in (a);
      * upsample_pallas: 3 steps with K2 launched 4 times a step (the
        up-sample sweeps), each K2 call held against its plain version and
        the f32 SDF at phase 3's holds after dividing by max(1, |x|),
        reported in the stage-1 line beside the plain version with f64
        sums;
      * render_image(0, resolution_level=4): K3-fwd alone, 4 chunks of 1,024
        rays x 128 samples, against the same render through its plain
        version;
      * the hand-off: a stage-1 checkpoint warm-starts a Stage2Trainer that
        takes one finite step.

    Returns what phase 9 times: the recorded calls, the step median, the
    syncs."""
    import tempfile
    import torch
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.fields.sdf import sdf_only
    from iron_tpu_torch.train.checkpoints import latest_checkpoint, load_checkpoint
    from iron_tpu_torch.train.schedules import cos_anneal_ratio
    from iron_tpu_torch.train import stage1 as S1
    from iron_tpu_torch.train.stage1 import Stage1Config, Stage1Trainer, stage1_loss
    from iron_tpu_torch.train.stage2 import Stage2Trainer

    t0 = time.perf_counter()
    cfg = dataclasses.replace(Stage1Config(), warm_up_end=8)
    ds = RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"], data["masks"],
                                device=dev)
    new_trainer = lambda c: Stage1Trainer(
        c, ds, generator=torch.Generator(device=dev).manual_seed(args.seed + 3), device=dev)
    tr = new_trainer(cfg)
    B = cfg.batch_size
    n_pts = B * (cfg.render.n_samples + cfg.render.n_importance)
    n_params = sum(p.numel() for p in tr.params.parameters())
    log(f"stage 1: womask_iron width (SDF {cfg.sdf.n_layers}x{cfg.sdf.d_hidden}, colour "
        f"{cfg.color.n_layers}x{cfg.color.d_hidden}, NeRF {cfg.nerf.D}x{cfg.nerf.W}; "
        f"{n_params} parameters), {B} rays x ({cfg.render.n_samples} + "
        f"{cfg.render.n_importance}) samples = {n_pts} points a step, {cfg.render.n_outside} "
        f"background samples, {cfg.render.up_sample_steps} up-sample rounds, perturb "
        f"{cfg.render.perturb}")

    # (a) one step through the kernels against the same step, on the same
    # draws, through K3's plain versions (the up-sample sweeps are the f32
    # sdf_only in both)
    draws = tr.draw(torch.Generator(device=dev).manual_seed(args.seed + 4))
    batch = ds.gen_random_rays(draws.img_idx, B, px=draws.px, py=draws.py)
    anneal = cos_anneal_ratio(1000, cfg.anneal_end)
    sdf = tr.params["sdf"]
    fwd_calls, bwd_calls = [], []

    def s1_step(fns=None, c=cfg):
        named = list(tr.params.named_parameters())
        for _, p in named:
            p.grad = None
        loss, m = stage1_loss(tr.params, c, batch, anneal, t_rand=draws.t_rand,
                              t_rand_outside=draws.t_rand_outside, fns=fns)
        loss.backward()
        grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                 for n, p in named}
        return float(loss.detach()), {k: float(v.detach()) for k, v in m.items()}, grads

    core = K3.make_fused_sdf_grad_fn(sdf)
    kernel_fns = {"sdf_fn": lambda p: sdf_only(sdf, p),
                  "sdf_all_fn": lambda x: fwd_calls.append(x.detach().clone()) or core(x)}
    kernels.reset_launch_counts()
    K3._FusedSdfCore.record = bwd_calls
    try:
        loss_k, m_k, g_k = s1_step(kernel_fns)
    finally:
        K3._FusedSdfCore.record = None
    step_launches = kernels.launch_counts()
    wg = K3.prepare_grad_weights(sdf, differentiable=True)
    loss_p, m_p, g_p = s1_step({"sdf_fn": lambda p: sdf_only(sdf, p),
                                "sdf_all_fn": lambda x: PlainCore.apply(wg, x, *wg.mats,
                                                                        *wg.biases)})
    errs = leaf_errs(g_k, g_p, 1e-4)
    worst = max(errs, key=errs.get)
    m_rel = {k: abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-6) for k in m_k}
    log(f"stage-1 step (view {int(draws.img_idx)}, anneal {anneal}): loss {loss_k:.6f} through "
        f"the kernels, {loss_p:.6f} through K3's plain versions (rel diff "
        f"{abs(loss_k - loss_p) / abs(loss_p):.3e}, tol 1e-5); metrics {m_k}; largest metric rel "
        f"diff {max(m_rel.values()):.3e} (tol 1e-4); launches {step_launches}; K3 calls "
        f"{[tuple(x.shape) for x in fwd_calls]}; gradients of {len(g_k)} leaves (sdf, colour, "
        f"variance, nerf): worst {worst} at {errs[worst]:.3f} of its tolerance (1e-4 of its "
        f"largest entry + 1e-7 of the step's)")
    assert step_launches["sdf_value_feat_grad"] == 1 and step_launches["sdf_value_feat_grad_bwd"] == 1
    assert sum(step_launches.values()) == 2, step_launches
    assert len(bwd_calls) == 1 and fwd_calls[0].numel() // 3 == n_pts
    assert all(np.isfinite(v) for v in m_k.values())
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p) and max(m_rel.values()) <= 1e-4
    assert errs[worst] <= 1.0
    assert {n.split(".")[0] for n in g_k} == {"sdf", "color", "variance", "nerf"}

    # (a') remat_core: the same kernel step, through build_stage1_fns as
    # train_step takes it, with the colour network recomputed in the
    # backward (torch.utils.checkpoint between K3-fwd and K3-bwd), changes
    # no number beyond the run-to-run order of f32 sums
    kernels.reset_launch_counts()
    loss_r, m_r, g_r = s1_step(None, dataclasses.replace(cfg, remat_core=True))
    remat_launches = kernels.launch_counts()
    errs_r = leaf_errs(g_r, g_k, 1e-5)
    worst_r = max(errs_r, key=errs_r.get)
    m_rel_r = max(abs(m_r[k] - m_k[k]) / max(abs(m_k[k]), 1e-6) for k in m_k)
    log(f"stage-1 step with remat_core: loss rel diff {abs(loss_r - loss_k) / abs(loss_k):.3e} "
        f"(tol 1e-6), largest metric rel diff {m_rel_r:.3e} (tol 1e-6), launches "
        f"{remat_launches}; gradients: worst {worst_r} at {errs_r[worst_r]:.3f} of its tolerance "
        f"(1e-5 of its largest entry + 1e-8 of the step's)")
    assert remat_launches == step_launches, remat_launches
    assert abs(loss_r - loss_k) <= 1e-6 * abs(loss_k) and m_rel_r <= 1e-6
    assert errs_r[worst_r] <= 1.0

    # (b) K3-fwd and K3-bwd on the step's own inputs
    w3s = K3.prepare_grad_weights(sdf)
    check_k3(fwd_calls[0], "stage-1 step", w3s)
    check_k3_bwd(*bwd_calls[0][:2], bwd_calls[0][2], "stage-1 step")

    # (c) the training run, every step counted
    def s1_run(trainer, n_warm, n_timed, path, label):
        step_s, per_step, history, syncs, sites = [], [], [], [], {}
        train_step, draw = trainer.train_step, trainer.draw
        saved = {(m, n): getattr(m, n) for m, n in plain_names}
        pending = {}

        def counted_draw(gen):
            with count_syncs() as c:
                out = draw(gen)
            pending["syncs"] = c
            return out

        def timed_step(d):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with count_syncs() as c:
                out = train_step(d)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            after = kernels.launch_counts()
            per_step.append({k: after[k] - before[k] for k in after})
            syncs.append(c.n + pending["syncs"].n)
            for s in c.sites + pending["syncs"].sites:
                sites[s] = sites.get(s, 0) + 1
            return out

        trainer.train_step, trainer.draw = timed_step, counted_draw
        for (m, n), fn in saved.items():
            setattr(m, n, refuse(n, fn))
        try:
            # one step a call: each step timed and its syncs counted (the
            # chunked run's graph is phase 8h's)
            trainer.run(num_iters=n_warm, seed=args.seed, history=history, steps_per_call=1)
            trainer.run(num_iters=n_timed, seed=args.seed, history=history, steps_per_call=1)
            torch.cuda.synchronize()
        finally:
            for (m, n), fn in saved.items():
                setattr(m, n, fn)
            trainer.train_step, trainer.draw = train_step, draw
        losses = [float(h["loss"]) for h in history]
        timed = step_s[n_warm:]
        med = float(np.median(timed))
        log(f"Stage1Trainer.run{label}, {len(history)} steps ({n_warm} + {n_timed}): loss first "
            f"10 {[round(v, 4) for v in losses[:10]]}, last 10 "
            f"{[round(v, 4) for v in losses[-10:]]}; launches a step {per_step[-1]}; host syncs "
            f"a step {syncs}" + (f" at {sites}" if sites else ""))
        log(f"stage-1 step{label}: median {med * 1e3:.2f} ms over {len(timed)} timed steps (host "
            f"clock with a synchronise after each step; min {min(timed) * 1e3:.2f}, max "
            f"{max(timed) * 1e3:.2f}), {B / med:.1f} rays/s; card {card}")
        assert all(np.isfinite(v) for v in losses)
        for i, d in enumerate(per_step):
            assert all(d[k] == path.get(k, 0) for k in d), (i, d)
        for p in trainer.params.parameters():
            assert torch.isfinite(p).all()
        return med, losses, syncs, sites

    def fixed_loss() -> float:
        """The loss of step (a)'s rays and draws under the current weights."""
        with torch.no_grad():
            return float(stage1_loss(tr.params, cfg, batch, anneal, t_rand=draws.t_rand,
                                     t_rand_outside=draws.t_rand_outside)[0])

    before = fixed_loss()
    med, losses, syncs, sites = s1_run(tr, 8, args.train_steps,
                                       {"sdf_value_feat_grad": 1, "sdf_value_feat_grad_bwd": 1},
                                       "")
    after = fixed_loss()
    log(f"  loss of step (a)'s rays before the run {before:.6f}, after {after:.6f}")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) and after < before

    # (d) upsample_pallas: the up-sample sweeps through K2, 4 calls a step,
    # each held against its plain version
    tr_up = new_trainer(dataclasses.replace(cfg, upsample_pallas=True))
    s1_run(tr_up, 1, 2, {"sdf_value_feat_grad": 1, "sdf_value_feat_grad_bwd": 1,
                         "sdf_only_bf16": cfg.render.up_sample_steps}, " with upsample_pallas")
    k2_calls = []
    make_k2 = S1.make_sdf_only_bf16_fn

    def recording_k2(net):
        f = make_k2(net)
        return lambda x: k2_calls.append(x.detach().clone()) or f(x)

    S1.make_sdf_only_bf16_fn = recording_k2
    try:
        tr_up.train_step(tr_up.draw(torch.Generator(device=dev).manual_seed(args.seed + 5)))
    finally:
        S1.make_sdf_only_bf16_fn = make_k2
    log(f"K2 calls of an upsample_pallas step: {[tuple(p.shape) for p in k2_calls]}")
    assert len(k2_calls) == cfg.render.up_sample_steps
    # Phase 3's holds (5e-3 against the plain version, 1.2e-2 against the
    # f32 SDF) were set on the tracer's points, inside the unit sphere.  The
    # sweeps also take points out to |x| = 2.5, where the activations, and
    # so one bf16 unit of them, grow with |x|: there the plain version with
    # f64 sums moves as far from the plain version as K2 does (the witness,
    # printed), so the difference is the arithmetic's, not the kernel's.
    # Held: each difference over max(1, |x|) to phase 3's holds, which is
    # looser than phase 3 outside the sphere.  Reported in the stage-1 line,
    # not in the kernels line's max_abs_err (phase 3's calls alone).
    net_up = tr_up.params["sdf"]
    wb = K12.prepare_bf16_weights(net_up)
    k2 = {"calls": [], "hold": BF16_REORDER_TOL, "f32_hold": 1.2e-2, "scaled_by": "max(1, |x|)",
          "err_scaled": 0.0, "f32_err_scaled": 0.0, "f64_sums_scaled": 0.0,
          "max_abs_err": 0.0, "max_abs_err_inside": 0.0, "max_abs_f64_sums": 0.0}
    for i, p in enumerate(k2_calls):
        x = p.reshape(-1, 3)
        with torch.no_grad():
            got = K12.sdf_only_bf16(wb, x)
            torch.cuda.synchronize()
            plain = K12.sdf_only_bf16_plain(wb, x)
            f64 = k2_plain_f64_sums(K12, wb, x)
            f32 = sdf_only(net_up, x)
        r = torch.linalg.norm(x, dim=-1)
        scale = torch.clamp(r, min=1.0)
        e, e32, e64 = (got - plain).abs(), (got - f32).abs(), (plain - f64).abs()
        inside = r < 1.0
        row = {"points": x.shape[0], "max_r": float(r.max()),
               "err_scaled": float((e / scale).max()),
               "f32_err_scaled": float((e32 / scale).max()),
               "f64_sums_scaled": float((e64 / scale).max()), "max_abs_err": float(e.max()),
               "max_abs_err_inside": float(e[inside].max()),
               "max_abs_f64_sums": float(e64.max())}
        log(f"K2 stage-1 up-sample call {i} ({x.shape[0]} points, |x| up to {row['max_r']:.2f}): "
            f"max|K2 - plain| / max(1, |x|) {row['err_scaled']:.3e} (tol {BF16_REORDER_TOL}; "
            f"unscaled {row['max_abs_err']:.3e}, {row['max_abs_err_inside']:.3e} inside the unit "
            f"sphere), max|K2 - f32 sdf| / max(1, |x|) {row['f32_err_scaled']:.3e} (tol 1.2e-2; "
            f"{float(e32[inside].max()):.3e} inside); the plain version with f64 sums against it: "
            f"{row['f64_sums_scaled']:.3e} / max(1, |x|), {row['max_abs_f64_sums']:.3e} unscaled")
        assert torch.isfinite(got).all()
        assert row["err_scaled"] <= BF16_REORDER_TOL and row["f32_err_scaled"] <= 1.2e-2
        k2["calls"].append(row)
        for key in ("err_scaled", "f32_err_scaled", "f64_sums_scaled", "max_abs_err",
                    "max_abs_err_inside", "max_abs_f64_sums"):
            k2[key] = max(k2[key], row[key])

    # (e) the validation render: K3-fwd alone, against its plain version
    render_calls = []
    kernels.reset_launch_counts()
    t_r = time.perf_counter()
    img = tr.render_image(0, resolution_level=4)
    render_s = time.perf_counter() - t_r
    render_launches = kernels.launch_counts()
    w3r = K3.prepare_grad_weights(sdf)
    plain = tr.render_image(0, resolution_level=4, fns={
        "sdf_fn": lambda p: sdf_only(sdf, p),
        "sdf_all_fn": lambda p: K3.sdf_value_feat_grad_plain(w3r, p)})
    with torch.no_grad():
        f_r = K3.make_fused_sdf_grad_fn(sdf)
        tr.render_image(0, resolution_level=4, fns={
            "sdf_fn": lambda p: sdf_only(sdf, p),
            "sdf_all_fn": lambda x: render_calls.append(x.clone()) or f_r(x)})
    dc = float(np.abs(img["color"] - plain["color"]).max())
    dn = float(np.abs(img["normal"] - plain["normal"]).max())
    H, W = ds.hw
    log(f"render_image(0, resolution_level=4): {img['color'].shape}, {render_s:.3f} s (host "
        f"clock); launches {render_launches}; K3-fwd calls "
        f"{[tuple(x.shape) for x in render_calls]}; against the render through K3's plain "
        f"version: colour within {dc:.3e}, normal within {dn:.3e} (tol 1e-4)")
    chunks = -(-(H // 4) * (W // 4) // 1024)
    assert render_launches["sdf_value_feat_grad"] == chunks
    assert sum(render_launches.values()) == chunks, render_launches
    assert np.isfinite(img["color"]).all() and np.isfinite(img["normal"]).all()
    assert dc <= 1e-4 and dn <= 1e-4
    check_k3(render_calls[0], "stage-1 render chunk", w3r)

    # (f) the hand-off to stage 2: a stage-1 checkpoint warm-starts a
    # Stage2Trainer, which takes one finite step
    with tempfile.TemporaryDirectory(dir=HERE) as ck_dir:
        tr.out_dir = ck_dir
        tr.save()
        tr.out_dir = None
        ck = load_checkpoint(latest_checkpoint(ck_dir))
    tr2 = Stage2Trainer(tcfg, data["images"], data["Ks"], data["W2Cs"],
                        generator=torch.Generator(device=dev).manual_seed(args.seed + 6),
                        stage1_params=ck["params"], device=dev)
    same_sdf = all(torch.equal(a, b) for a, b in zip(tr2.params["sdf"].parameters(),
                                                     sdf.parameters()))
    m2 = tr2.train_step(*crop, eik)
    log(f"hand-off: stage-1 checkpoint at step {ck['step']} -> Stage2Trainer (the SDF carried "
        f"over bit for bit: {same_sdf}); one stage-2 step: loss {float(m2['loss']):.6f}, "
        f"mask_frac {float(m2['mask_frac']):.4f}")
    assert same_sdf and all(bool(torch.isfinite(v)) for v in m2.values())
    log(f"phase 8d: {time.perf_counter() - t0:.1f} s")
    return {"cfg": cfg, "trainer": tr, "fwd": fwd_calls[0], "render": render_calls[0],
            "bwd": bwd_calls[0], "k2": k2_calls, "up_trainer": tr_up, "median_s": med,
            "syncs": syncs, "sync_sites": sites, "render_s": render_s, "k2_upsample": k2}


def cli_phase(args, dev, card, kernels, refuse, plain_names) -> dict:
    """Phase 8e, the user's run through the port's CLIs, in process and on
    the card (--device cuda), on the synthetic sphere written as a scene
    folder (8 views at 256x256 with masks):

      1. train_volume --mode train --conf iron_tpu_torch/configs/womask_iron.json
         --num_iters 40 (the full womask_iron width, async checkpoints);
      2. train_volume --mode validate_mesh --mcube_resolution 256;
      3. train_surface --neus_ckpt_fpath <that checkpoint> --num_iters 40
         --export_res 256 (comp at the full width, then the final export);
      4. train_surface --render_all;
      5. evaluate images (the renders against the scene's images), mesh (the
         exported mesh against the analytic sphere's) and relight.

    Holds: every stage-1 step ran K3-fwd and K3-bwd once and nothing else
    (train_volume's run takes chunks of 16 steps, replays of the captured
    step, which run no wrapper: the eager steps and the capture counted by
    the wrappers, and what a replay of the CLI trainer's graph runs counted
    in torch.profiler's device trace at the script's end), every stage-2
    step K1, K2, K3-fwd and K3-bwd and no K4 or K5, every view of the renders
    K1, K2 and K3-fwd alone, the export K3-fwd alone and validate_mesh no
    kernel; no plain version reached by a CUDA tensor; every
    async checkpoint reads back bit for bit as the trainer's parameters at
    its step; the stage-2 trainer starts from the stage-1 SDF bit for bit;
    the mesh and the atlases exist and are not empty; the renders are JPEGs
    the port's reader decodes; PSNR and chamfer are finite.  Returns the
    {"cli"} line's record."""
    import contextlib
    import glob
    import io
    import tempfile
    import torch
    from iron_tpu_torch.cli import evaluate as cli_evaluate
    from iron_tpu_torch.cli import train_surface as cli_surface
    from iron_tpu_torch.cli import train_volume as cli_volume
    from iron_tpu_torch.data.io import read_image
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset, write_scene_dir
    from iron_tpu_torch.export.mesh import extract_geometry, read_obj, write_obj
    from iron_tpu_torch.train import stage1 as S1
    from iron_tpu_torch.train import stage2 as S2
    from iron_tpu_torch.train.checkpoints import load_checkpoint, params_to_numpy

    t_phase = time.perf_counter()
    steps, res, n_views = 40, 256, 8
    conf = os.path.join(HERE, "iron_tpu_torch", "configs", "womask_iron.json")
    rec = {"scene": f"synthetic sphere, {n_views} views at {res}x{res}, masks",
           "cuts": {"stage1_steps": [steps, 100001], "stage2_steps": [steps, 50001],
                    "export_res": [256, 512]},
           "wall_s": {}, "launches": {}, "card": card}
    step_log = {"stage1": [], "stage2": []}      # (seconds, launches) a step (stage 1: seconds)
    chunk_log, s1_trainers = [], []              # stage 1's chunks; the last trainer
    view_log = []                                # (seconds, launches) a view
    saved_params = {"stage1": {}, "stage2": {}}  # step -> the parameters at the save
    adopted = []
    export_log = []

    def counted(fn, log_to):
        def call(self, *a, **k):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            log_to.append((time.perf_counter() - t, {k_: after[k_] - before[k_] for k_ in after}))
            return out
        return call

    def recorded_save(fn, stage, to_numpy):
        def call(self):
            tree = to_numpy(self.params)
            saved_params[stage][self.step] = [np.array(x) for x in _leaves(tree)]
            return fn(self)
        return call

    def adopting_init(fn):
        def call(self, *a, **k):
            fn(self, *a, **k)
            adopted.append([np.array(x) for x in _leaves(params_to_numpy(self.params)["sdf"])])
        return call

    def timed_export(fn):
        def call(trainer, export_dir, resolution=512):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(trainer, export_dir, resolution=resolution)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            export_log.append((time.perf_counter() - t,
                               {k: after[k] - before[k] for k in after}, export_dir))
        return call

    def counted_chunk(fn):
        """Stage1Trainer.run_chunk: the CLI's chunks of 16 steps, the first
        an eager warm-up step, the capture and replays of the captured step
        (phase 8h), the others replays, which run no wrapper: each chunk
        timed (logged as its steps' mean), its wrapper launches and its
        replays counted, the trainer kept for the device trace of its
        graph's replays."""
        def call(self, n, generator, history=None):
            graph = self._graph
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, n, generator, history)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            step_log["stage1"].extend([(time.perf_counter() - t) / n] * n)
            captured = self._graph is not graph
            chunk_log.append({"steps": n, "captured": captured,
                              "replays": 0 if n == 1 else n - captured,
                              "wrapper": {k_: after[k_] - before[k_] for k_ in after}})
            s1_trainers[:] = [self]
            return out
        return call

    patches = [(S1.Stage1Trainer, "run_chunk", counted_chunk(S1.Stage1Trainer.run_chunk)),
               (S1.Stage1Trainer, "save", recorded_save(S1.Stage1Trainer.save, "stage1",
                                                        S1.stage1_params_to_numpy)),
               (S2.Stage2Trainer, "train_step", counted(S2.Stage2Trainer.train_step,
                                                        step_log["stage2"])),
               (S2.Stage2Trainer, "save", recorded_save(S2.Stage2Trainer.save, "stage2",
                                                        params_to_numpy)),
               (S2.Stage2Trainer, "render_full", counted(S2.Stage2Trainer.render_full,
                                                         view_log)),
               (S2.Stage2Trainer, "__init__", adopting_init(S2.Stage2Trainer.__init__)),
               (cli_surface, "export_assets", timed_export(cli_surface.export_assets))]
    patches += [(m, n, refuse(n, getattr(m, n))) for m, n in plain_names]
    originals = [(o, n, getattr(o, n)) for o, n, _ in patches]

    def run(label, main_fn, argv):
        """One CLI call, its launches counted from 0 and its stdout kept."""
        out = io.StringIO()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main_fn(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        rec["wall_s"][label] = time.perf_counter() - t
        rec["launches"][label] = kernels.launch_counts()
        text = out.getvalue()
        log(f"  {label}: {rec['wall_s'][label]:.2f} s, wrapper launches {rec['launches'][label]}; "
            f"stdout: {text.strip().splitlines()[-1] if text.strip() else ''}")
        return text

    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        t0 = time.perf_counter()
        data = render_synthetic_dataset("sphere", n_views=n_views, H=res, W=res, light=30.0,
                                        device=dev)
        scene = write_scene_dir(data, os.path.join(tmp, "scene", "train"))
        log(f"phase 8e: scene folder written ({time.perf_counter() - t0:.1f} s); the CLIs "
            f"on the card:")
        exp1, exp2 = os.path.join(tmp, "exp1"), os.path.join(tmp, "exp2")
        for o, n, fn in patches:
            setattr(o, n, fn)
        try:
            run("train_volume", cli_volume.main,
                ["--mode", "train", "--conf", conf, "--data_dir", scene, "--out_dir", exp1,
                 "--num_iters", str(steps)])
            run("validate_mesh", cli_volume.main,
                ["--mode", "validate_mesh", "--conf", conf, "--data_dir", scene,
                 "--out_dir", exp1, "--mcube_resolution", "256"])
            ck1 = os.path.join(exp1, f"ckpt_{steps:07d}.pkl")
            run("train_surface", cli_surface.main,
                ["--data_dir", scene, "--out_dir", exp2, "--neus_ckpt_fpath", ck1,
                 "--num_iters", str(steps), "--export_res", "256"])
            n_views_before = len(view_log)
            run("render_all", cli_surface.main,
                ["--data_dir", scene, "--out_dir", exp2, "--render_all"])
            renders = os.path.join(exp2, f"render_train_{steps}")
            assets = os.path.join(exp2, f"mesh_and_materials_{steps}")
            sphere = os.path.join(tmp, "sphere.obj")
            write_obj(sphere, *extract_geometry(
                lambda p: torch.linalg.norm(p, dim=-1) * -1.0 + 0.5, resolution=256, device=dev))
            ev_img = run("evaluate", cli_evaluate.main,
                         ["images", "--pred_dir", renders, "--gt_dir",
                          os.path.join(scene, "image")])
            rec["wall_s"]["evaluate_images"] = rec["wall_s"].pop("evaluate")
            ev_mesh = run("evaluate", cli_evaluate.main,
                          ["mesh", "--mesh1", os.path.join(assets, "mesh.obj"),
                           "--mesh2", sphere])
            rec["wall_s"]["evaluate_mesh"] = rec["wall_s"].pop("evaluate")
            run("evaluate", cli_evaluate.main,
                ["relight", "--mesh", os.path.join(assets, "mesh.obj"), "--materials", assets,
                 "--cam_dict", os.path.join(scene, "cam_dict_norm.json"),
                 "--out_dir", os.path.join(tmp, "relit")])
            rec["wall_s"]["evaluate_relight"] = rec["wall_s"].pop("evaluate")
            rec["launches"].pop("evaluate")
        finally:
            for o, n, fn in originals:
                setattr(o, n, fn)

        # the kernels of each call
        # stage 1: each chunk's wrapper launches are its eager steps' and
        # its capture's (K3-fwd and K3-bwd once a step); a replay's kernels
        # come from the device trace at the script's end
        s1_path = {"sdf_value_feat_grad": 1, "sdf_value_feat_grad_bwd": 1}
        for i, c in enumerate(chunk_log):
            calls = c["steps"] - c["replays"] + c["captured"]
            assert all(v == s1_path.get(k, 0) * calls for k, v in c["wrapper"].items()), \
                ("stage-1 chunk", i, c)
        assert any(c["captured"] for c in chunk_log) and len(s1_trainers) == 1
        s2_path = ("coarse_march", "sdf_only_bf16", "sdf_value_feat_grad",
                   "sdf_value_feat_grad_bwd")
        for i, (_, d) in enumerate(step_log["stage2"]):
            assert all(d[k] >= 1 for k in s2_path) and d["sdf_only_3pass"] == 0 and \
                d["sdf_full"] == 0, ("stage-2 step", i, d)
        render_path = ("coarse_march", "sdf_only_bf16", "sdf_value_feat_grad")
        views = view_log[n_views_before:]
        for i, (_, d) in enumerate(views):
            assert all(d[k] >= 1 for k in render_path) and all(
                d[k] == 0 for k in d if k not in render_path), ("render_all view", i, d)
        assert len(step_log["stage1"]) == steps and len(step_log["stage2"]) == steps
        assert len(views) == n_views and len(export_log) == 1
        exp_s, exp_d, _ = export_log[0]
        assert exp_d["sdf_value_feat_grad"] >= 1 and all(
            v == 0 for k, v in exp_d.items() if k != "sdf_value_feat_grad"), exp_d
        assert sum(rec["launches"]["validate_mesh"].values()) == 0, rec["launches"]
        assert sum(c["steps"] for c in chunk_log) == steps

        # the async checkpoints, bit for bit; the stage-1 SDF adopted
        for stage, out_dir in (("stage1", exp1), ("stage2", exp2)):
            assert saved_params[stage], stage
            for step, leaves in saved_params[stage].items():
                got = _leaves(load_checkpoint(os.path.join(out_dir, f"ckpt_{step:07d}.pkl"))
                              ["params"])
                assert len(got) == len(leaves) and all(
                    np.array_equal(a, b) for a, b in zip(got, leaves)), (stage, step)
        sdf1 = _leaves(load_checkpoint(ck1)["params"]["sdf"])
        assert len(adopted) == 2 and all(np.array_equal(a, b)
                                         for a, b in zip(adopted[0], sdf1))

        # the products
        for name in ("mesh.obj", "mesh.mtl", "diffuse_albedo.png", "specular_albedo.png",
                     "roughness.png"):
            assert os.path.getsize(os.path.join(assets, name)) > 0, name
        atlas_cover = float((read_image(os.path.join(assets, "diffuse_albedo.png")).max(-1)
                             > 0).mean())
        verts, tris, uvs, _ = read_obj(os.path.join(assets, "mesh.obj"))
        assert len(tris) > 0 and len(uvs) == 3 * len(tris) and atlas_cover > 0
        assert os.path.getsize(os.path.join(exp1, f"mesh_{steps:07d}.obj")) > 0
        jpgs = sorted(glob.glob(os.path.join(renders, "*.jpg")))
        assert len(jpgs) == 4 * n_views
        for path in jpgs:
            with open(path, "rb") as f:
                assert f.read(2) == b"\xff\xd8", path
            img = read_image(path)
            assert img.shape == (res, res, 3) and np.isfinite(img).all(), path
        assert len(os.listdir(os.path.join(tmp, "relit"))) == n_views
        summary = json.loads(ev_img.strip().splitlines()[-1])
        chamfer = json.loads(ev_mesh.strip().splitlines()[-1])["chamfer"]
        assert summary["n_images"] == n_views and np.isfinite(summary["psnr"])
        assert np.isfinite(chamfer)

    s1_t = step_log["stage1"]
    s2_t = [t for t, _ in step_log["stage2"]]
    rec.update({
        "stage1_steps_per_s": len(s1_t) / sum(s1_t), "stage1_step_median_ms":
            float(np.median(s1_t)) * 1e3,
        "stage2_steps_per_s": len(s2_t) / sum(s2_t), "stage2_step_median_ms":
            float(np.median(s2_t)) * 1e3,
        "render_ms_per_view": float(np.mean([t for t, _ in views])) * 1e3,
        "export_256_s": exp_s, "export_launches": exp_d,
        "psnr": summary["psnr"], "ssim": summary["ssim"], "chamfer": chamfer,
        "mesh_triangles": int(len(tris)), "atlas_coverage": atlas_cover,
        "view_launches": views[0][1], "stage1_chunks": chunk_log})
    rec["wall_s"]["phase"] = time.perf_counter() - t_phase
    log(f"phase 8e: stage 1 {rec['stage1_steps_per_s']:.2f} steps/s (median "
        f"{rec['stage1_step_median_ms']:.2f} ms), stage 2 {rec['stage2_steps_per_s']:.2f} "
        f"steps/s (median {rec['stage2_step_median_ms']:.2f} ms), {rec['render_ms_per_view']:.1f}"
        f" ms a {res}x{res} view, export at 256 {exp_s:.2f} s ({len(tris)} triangles, atlas "
        f"coverage {atlas_cover:.3f}), PSNR {summary['psnr']:.3f}, chamfer {chamfer:.5f}; "
        f"{rec['wall_s']['phase']:.1f} s")

    def trace_cli_replays():
        """Two replays of the CLI trainer's graph under the device trace:
        the kernels a replay ran; with the eager steps' (K3-fwd and K3-bwd
        once each), the stage-1 launches of train_volume's run."""
        tr = s1_trainers[0]
        kernels.reset_launch_counts()
        traced = traced_launches(lambda: tr.run_chunk(2, tr._graph.generator), kernels.KERNELS)
        assert sum(kernels.launch_counts().values()) == 0
        per = {k: v / 2 for k, v in traced.items() if v}
        eager = sum(c["steps"] - c["replays"] for c in chunk_log)
        replays = sum(c["replays"] for c in chunk_log)
        total = {k: eager * s1_path.get(k, 0) + replays * v for k, v in per.items()}
        log(f"phase 8e, traced at the script's end: a replay of train_volume's graph ran {per}; "
            f"its run: {eager} eager steps and {replays} replays, {total}")
        assert per == {"sdf_value_feat_grad": 1, "sdf_value_feat_grad_bwd": 1,
                       "reduce_partials": 1}, per
        assert total["sdf_value_feat_grad_bwd"] == steps, total
        rec["stage1_replay_kernels"] = per
        rec["stage1_run_kernels"] = {"eager_steps": eager, "replays": replays, "kernels": total}

    DEFERRED_TRACES.append(trace_cli_replays)
    return rec


def research_phase(args, dev, card, data, kernels, h) -> dict:
    """Phase 8f, the fork's research paths at full width on phase 8's data
    (the synthetic sphere, 4 views at 256x256, masks), only the step counts
    cut (each cut listed in the returned record):

      (a) the `multi` and `disney` flavours: Stage2Trainer at
          Stage2Config(renderer_name=r) (SDF 8x256, 128x128 crops): one step
          through K1-K3 against the same step with K3 plain (the same trace:
          loss 1e-5, metrics 1e-4, gradients at phase 8's 5e-3, beside a
          witness of the lobes' conditioning) and all plain (phase 8's masks
          and loss; the gradients reported: a root moved by the tracer's
          5e-5 changes them through these sharp lobes far more); 1 + 4 + 15 steps of run (every
          step of the last 19 launches K1, K2, K3-fwd and K3-bwd and nothing
          else, the loss finite, no plain version reached by a CUDA tensor):
          the mean loss of the run's crops falls from the weights after its
          first step to those after its last;
          one render_full at 256x256 with the flavour's own buffers;
      (b) CurriculumTrainer at Stage2Config() (comp), the rgb, refrac and env
          phases of 10 steps each: after each phase every frozen leaf
          bit-equal to its value at the phase's start and some trainable leaf
          moved; the env phase moves env_light_network (use_env_light);
          each phase's step median and launches;
      (c) MultiSpectralStage1Trainer at MultiSpectralConfig(base=
          Stage1Config()) (the womask_iron width) on the sphere at light 30
          (RGB) and at light 20, its band mean in 3 channels (NIR): 20 RGB
          then 20 NIR steps, K3-fwd and K3-bwd once a step on 65,536 points
          and nothing else, 0 host syncs a step, color_nir and nerf_nir
          bit-equal after the RGB phase; save, then load_cross_modality in
          a fresh trainer restores the listed leaves bit for bit;
      (d) HashNeRFTrainer at NeRFRunnerConfig(use_foreground=True,
          use_envmap=True) (the default grids: 16 levels of 2^19 rows),
          batch 1024, 64 samples, the warm-up cut to 5 steps, 30 steps: a
          finite loss whose mean over the last 5 steps is below that over
          the first 5, no kernel launched; the step median and
          max_memory_allocated.

    `h` holds phase 8's helpers (one_step, one_loss, plain_fns,
    hold_retraced, leaf_errs, train_run, refuse, plain_names, step_path,
    tcfg, crop)."""
    import tempfile
    import torch
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset
    from iron_tpu_torch.train.curriculum import (PHASE_PLANS, CurriculumPhase,
                                                 CurriculumTrainer)
    from iron_tpu_torch.train.nerf_runner import HashNeRFTrainer, NeRFRunnerConfig
    from iron_tpu_torch.train.stage1 import Stage1Config
    from iron_tpu_torch.train.stage1_multispectral import (MultiSpectralConfig,
                                                           MultiSpectralStage1Trainer)
    from iron_tpu_torch.train.stage2 import Stage2Trainer

    t_phase = time.perf_counter()
    rec = {"card": card, "cuts": {}}
    snap = lambda params: {n: p.detach().clone() for n, p in params.named_parameters()}
    net_of = lambda n: n.split(".")[0] if n.startswith("sdf.") else n.split(".")[1]

    # (a) the flavours
    rec["cuts"]["flavour_steps"] = [20, 50001]
    for r in ("multi", "disney"):
        t0 = time.perf_counter()
        cfg_r = dataclasses.replace(h["tcfg"], renderer_name=r)
        tr = Stage2Trainer(cfg_r, data["images"], data["Ks"], data["W2Cs"],
                           generator=torch.Generator(device=dev).manual_seed(args.seed + 7),
                           device=dev)
        kernels.reset_launch_counts()
        loss_k, m_k, g_k = h["one_step"](tr)
        step_launches = kernels.launch_counts()
        loss_p3, m_p3, g_p3 = h["one_step"](tr, h["plain_fns"](False, tr))
        loss_pa, m_pa, g_pa = h["one_step"](tr, h["plain_fns"](True, tr))
        # the witness: the K3-plain step again with the SDF gradients (the
        # normals) scaled by 1 + 1e-6 N(0, 1), the size of K3's 3xTF32
        # difference from f32 (phase 4): these flavours' GGX lobes at their
        # initial roughness (~0.01) amplify it in the gradients, where comp's
        # NDF at alpha 1.49 (d_from_eta) does not
        jitter = torch.Generator(device=dev).manual_seed(args.seed + 12)
        plain3 = h["plain_fns"](False, tr)      # weights prepared anew for its backward

        def jittered(x, core=plain3["sdf_all_fn"]):
            v, feat, g = core(x)
            return v, feat, g * (1 + 1e-6 * torch.randn(g.shape, generator=jitter,
                                                        device=g.device))

        _, _, g_w = h["one_step"](tr, dict(plain3, sdf_all_fn=jittered))
        errs = h["leaf_errs"](g_k, g_p3, 1e-4)
        worst = max(errs, key=errs.get)
        errs_w = h["leaf_errs"](g_w, g_p3, 1e-4)
        worst_w = max(errs_w, key=errs_w.get)
        m_rel = max(abs(m_k[k] - m_p3[k]) / max(abs(m_p3[k]), 1e-6) for k in m_k)
        log(f"{r} training step on crop {h['crop']}: loss {loss_k:.6f} through the kernels, "
            f"{loss_p3:.6f} with K3 plain (rel diff {abs(loss_k - loss_p3) / abs(loss_p3):.3e}, "
            f"tol 1e-5; largest metric rel diff {m_rel:.3e}, tol 1e-4), {loss_pa:.6f} all "
            f"plain; launches {step_launches}; kernels vs K3 plain: worst gradient leaf {worst} "
            f"at {errs[worst]:.3f} of phase 8's 1e-4 tolerance, {errs[worst] / 50:.3f} of its 5e-3 "
            f"(held); the witness (K3 plain, normals x (1 + 1e-6 N)): worst leaf {worst_w} at "
            f"{errs_w[worst_w]:.3f} of the 1e-4 tolerance")
        assert all(step_launches[k] >= 1 for k in h["step_path"]), step_launches
        assert all(step_launches[k] == 0 for k in step_launches if k not in h["step_path"])
        assert abs(loss_k - loss_p3) <= 1e-5 * abs(loss_p3) and m_rel <= 1e-4
        assert errs[worst] <= 50.0
        assert "metallicness_loss" not in m_k
        h["hold_retraced"](f"{r}: kernels vs all plain", (loss_k, m_k, g_k),
                           (loss_pa, m_pa, g_pa), ("mask_frac", "edge_pixel_count",
                                                  "edge_seed_count"), hold_grads=False)
        # the loss falls: the mean loss of the run's own crops (each with
        # the eikonal points of the step above) under the weights after the
        # run's first step and under those after its last.  Single crops
        # differ in coverage more than 20 steps move the loss, and the first
        # step of a fresh Adam (lr * sign(g) on every weight) can move it up
        tr.run(num_iters=1, seed=args.seed)
        p_first = copy.deepcopy(tr.params)
        seen, step_fn = [], tr.train_step
        tr.train_step = lambda i, c_, r_, e: seen.append((i, c_, r_)) or step_fn(i, c_, r_, e)
        try:
            launches, med = h["train_run"](tr, h["step_path"], f" ({r})", n_warm=4, n_timed=15,
                                           window_falls=False)
        finally:
            tr.train_step = step_fn
        before = float(np.mean([h["one_loss"](tr, c_, p_first) for c_ in seen]))
        after = float(np.mean([h["one_loss"](tr, c_) for c_ in seen]))
        log(f"{r}: the mean loss of the run's {len(seen)} crops under the weights after its "
            f"first step {before:.6f}, after its last {after:.6f}")
        assert np.isfinite(after) and after < before
        kernels.reset_launch_counts()
        t_r = time.perf_counter()
        out = tr.render_full(0)
        render_s = time.perf_counter() - t_r
        view_launches = kernels.launch_counts()
        own = {"multi": ["material_vector"],
               "disney": ["metallic", "spec_tint", "clearcoat", "clearcoat_rgb"]}[r]
        hit = out["convergent_mask"] > 0
        log(f"{r} render_full(0) at {out['color'].shape[:2]}: {render_s:.3f} s, launches "
            f"{view_launches}; its own buffers "
            + ", ".join(f"{k} {tuple(out[k].shape)} mean {float(out[k][hit].mean()):.4f}"
                        for k in own) + f"; {int(hit.sum())} pixels shaded")
        assert all(view_launches[k] >= 1 for k in ("coarse_march", "sdf_only_bf16",
                                                   "sdf_value_feat_grad"))
        for k in own + ["color"]:
            assert np.isfinite(out[k]).all() and out[k].shape[:2] == data["images"].shape[1:3], k
        assert hit.any() and out["color"][hit].max() > 0
        rec[r] = {"step_ms_median": med * 1e3, "step_launches": step_launches,
                  "run_launches": launches, "render_s": render_s,
                  "render_launches": view_launches,
                  "loss_rel_diff_k3_plain": abs(loss_k - loss_p3) / abs(loss_p3),
                  "grad_err_k3_plain_of_1e-4": errs[worst], "witness_of_1e-4": errs_w[worst_w],
                  "run_crops_loss": [before, after],
                  "wall_s": time.perf_counter() - t0}

    # (b) the curriculum
    t0 = time.perf_counter()
    n_cur = 10
    rec["cuts"]["curriculum_steps"] = {"rgb": [n_cur, 50000], "refrac": [n_cur, 30000],
                                       "env": [n_cur, 40000]}
    cur = CurriculumTrainer(h["tcfg"], data["images"], data["Ks"], data["W2Cs"],
                            phases=[CurriculumPhase(n, n_cur) for n in ("rgb", "refrac", "env")],
                            device=dev, seed=args.seed + 8)
    phases = []
    make = cur.phase_trainer

    def traced(phase):
        tr = make(phase)
        p = {"name": phase.name, "start": snap(tr.params), "step_s": [], "launches": []}
        step = tr.train_step

        def timed(*a):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            p["step_s"].append(time.perf_counter() - t)
            after = kernels.launch_counts()
            p["launches"].append({k: after[k] - before[k] for k in after})
            return out

        tr.train_step = timed
        phases.append(p)
        return tr

    cur.phase_trainer = traced
    saved = {(m, n): getattr(m, n) for m, n in h["plain_names"]}
    for (m, n), fn in saved.items():
        setattr(m, n, h["refuse"](n, fn))
    history = []
    try:
        cur.run(seed=args.seed, history=history)
        torch.cuda.synchronize()
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    rec["curriculum"] = {}
    for i, p in enumerate(phases):
        end = phases[i + 1]["start"] if i + 1 < len(phases) else snap(cur.params)
        on = PHASE_PLANS[p["name"]]["trainable"]
        frozen = [n for n in p["start"] if not on[net_of(n)]]
        moved = sorted({net_of(n) for n in p["start"] if not torch.equal(end[n], p["start"][n])})
        still = all(torch.equal(end[n], p["start"][n]) for n in frozen)
        losses = [float(m["loss"]) for m in history[i * n_cur:(i + 1) * n_cur]]
        med = float(np.median(p["step_s"][1:]))
        totals = {k: sum(d[k] for d in p["launches"]) for k in p["launches"][0]}
        log(f"curriculum phase {p['name']} ({n_cur} steps, use_env_light "
            f"{PHASE_PLANS[p['name']]['use_env_light']}): step median {med * 1e3:.2f} ms (host "
            f"clock, synchronised); launches {totals}; {len(frozen)} frozen leaves bit-equal: "
            f"{still}; nets that moved {moved}; loss {[round(v, 4) for v in losses]}; card {card}")
        assert still and moved and all(on[k] for k in moved)
        assert all(np.isfinite(losses))
        for d in p["launches"]:
            assert all(d[k] >= 1 for k in h["step_path"]), d
            assert all(d[k] == 0 for k in d if k not in h["step_path"]), d
        if p["name"] == "env":
            assert moved == ["env_light_network"]
        rec["curriculum"][p["name"]] = {"step_ms_median": med * 1e3, "launches": totals,
                                        "moved": moved, "frozen_leaves": len(frozen)}
    rec["curriculum"]["wall_s"] = time.perf_counter() - t0

    # (c) RGB + NIR stage 1
    t0 = time.perf_counter()
    n_views, H, W = data["images"].shape[:3]
    nir = render_synthetic_dataset("sphere", n_views=n_views, H=H, W=W, light=20.0, device=dev)
    nir_imgs = np.repeat(nir["images"].mean(-1, keepdims=True), 3, axis=-1)
    datasets = {"rgb": RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"],
                                              data["masks"], device=dev),
                "nir": RayDataset.from_arrays(nir_imgs, nir["Ks"], nir["W2Cs"], nir["masks"],
                                              device=dev)}
    n_ms = 20
    ms_cfg = MultiSpectralConfig(base=Stage1Config(), rgb_iters=n_ms, nir_iters=n_ms)
    rec["cuts"]["multispectral_steps"] = [[n_ms, n_ms], [ms_cfg.base.end_iter] * 2]
    ms = MultiSpectralStage1Trainer(ms_cfg, datasets, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(args.seed
                                                                                      + 9))
    n_pts = ms_cfg.base.batch_size * (ms_cfg.base.render.n_samples
                                      + ms_cfg.base.render.n_importance)
    ms_log = {"rgb": [], "nir": []}
    train_step, draw = ms.train_step, ms.draw
    pending = {}

    def ms_draw(m, gen):
        with count_syncs() as c:
            out = draw(m, gen)
        pending["syncs"] = c.n
        return out

    def ms_step(m, d):
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with count_syncs() as c:
            out = train_step(m, d)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = kernels.launch_counts()
        ms_log[m].append((dt, {k: after[k] - before[k] for k in after}, c.n + pending["syncs"],
                          c.sites, float(out["loss"])))
        return out

    ms.train_step, ms.draw = ms_step, ms_draw
    saved = {(m, n): getattr(m, n) for m, n in h["plain_names"]}
    for (m, n), fn in saved.items():
        setattr(m, n, h["refuse"](n, fn))
    try:
        nir0 = {n: p.detach().clone() for n, p in ms.params.named_parameters()
                if n.split(".")[0] in ("color_nir", "nerf_nir")}
        sdf0 = snap(ms.params["sdf"])
        ms.run_phase("rgb", n_ms, seed=args.seed)
        nir_still = all(torch.equal(dict(ms.params.named_parameters())[n], v)
                        for n, v in nir0.items())
        sdf_moved = any(not torch.equal(p, sdf0[n])
                        for n, p in ms.params["sdf"].named_parameters())
        ms.run_phase("nir", n_ms, seed=args.seed)
        nir_moved = any(not torch.equal(dict(ms.params.named_parameters())[n], v)
                        for n, v in nir0.items())
        torch.cuda.synchronize()
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
        ms.train_step, ms.draw = train_step, draw
    path = {"sdf_value_feat_grad": 1, "sdf_value_feat_grad_bwd": 1}
    rec["multispectral"] = {"points_per_step": n_pts, "launches_total": {
        k: sum(r_[1][k] for rows in ms_log.values() for r_ in rows)
        for k in kernels.KERNELS}}
    for m, rows in ms_log.items():
        med = float(np.median([r_[0] for r_ in rows[1:]]))
        syncs = [r_[2] for r_ in rows]
        losses = [r_[4] for r_ in rows]
        log(f"multispectral {m} phase ({len(rows)} steps, {n_pts} points a step): step median "
            f"{med * 1e3:.2f} ms (host clock, synchronised); launches a step {rows[-1][1]}; host "
            f"syncs a step {syncs}; loss first 5 {[round(v, 4) for v in losses[:5]]}, last 5 "
            f"{[round(v, 4) for v in losses[-5:]]}; card {card}")
        for r_ in rows:
            assert all(r_[1][k] == path.get(k, 0) for k in r_[1]), r_[1]
        assert all(s_ == 0 for s_ in syncs) and all(np.isfinite(losses))
        rec["multispectral"][m] = {"step_ms_median": med * 1e3, "syncs_per_step": syncs,
                                   "launches_per_step": rows[-1][1]}
    log(f"multispectral: after the RGB phase color_nir / nerf_nir bit-equal {nir_still}, the "
        f"SDF moved {sdf_moved}; after the NIR phase the NIR nets moved {nir_moved}")
    assert nir_still and sdf_moved and nir_moved
    with tempfile.TemporaryDirectory(dir=HERE) as ck_dir:
        ms.out_dir = ck_dir
        ms.save()
        ms.out_dir = None
        fresh = MultiSpectralStage1Trainer(
            ms_cfg, datasets, device=dev,
            generator=torch.Generator(device=dev).manual_seed(args.seed + 10))
        fresh.load_cross_modality(rgb_ckpt_dir=ck_dir, nir_ckpt_dir=ck_dir)
    same = all(torch.equal(a, b) for a, b in zip(fresh.params.parameters(),
                                                 ms.params.parameters()))
    log(f"multispectral checkpoint: save -> load_cross_modality in a fresh trainer restores "
        f"{sorted(ms.params.keys())} bit for bit: {same}")
    assert same
    rec["multispectral"]["wall_s"] = time.perf_counter() - t0

    # (d) the hash-grid runner
    t0 = time.perf_counter()
    n_run = 30
    run_cfg = NeRFRunnerConfig(use_foreground=True, use_envmap=True, warm_up_end=5)
    rec["cuts"]["runner"] = {"steps": [n_run, run_cfg.end_iter], "warm_up_end": [5, 200]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    runner = HashNeRFTrainer(run_cfg, datasets["rgb"], device=dev,
                             generator=torch.Generator(device=dev).manual_seed(args.seed + 11))
    n_params = sum(p.numel() for p in runner.params.parameters())
    run_s, run_hist = [], []
    step = runner.train_step

    def run_timed(d):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(d)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t)
        return out

    runner.train_step = run_timed
    kernels.reset_launch_counts()
    runner.run(n_run, seed=args.seed, history=run_hist)
    run_launches = kernels.launch_counts()
    peak_abs = torch.cuda.max_memory_allocated(dev)
    peak = peak_abs - base_mem
    losses = [float(m["loss"]) for m in run_hist]
    med = float(np.median(run_s[1:]))
    log(f"hash-grid runner (foreground NeuS over the background NeRF, envmap; {n_params} "
        f"parameters in {sorted(runner.params.keys())}): {n_run} steps of "
        f"{run_cfg.batch_size} rays x {run_cfg.n_samples} samples; step median "
        f"{med * 1e3:.2f} ms (host clock, synchronised; first {run_s[0] * 1e3:.1f}); "
        f"max_memory_allocated {peak_abs / 2**20:.1f} MiB, {peak / 2**20:.1f} MiB above what "
        f"the script held before the runner; launches {run_launches}; loss "
        f"first 5 {[round(v, 4) for v in losses[:5]]}, last 5 {[round(v, 4) for v in losses[-5:]]}"
        f"; card {card}")
    assert all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(losses[:5])
    assert sum(run_launches.values()) == 0
    rec["runner"] = {"step_ms_median": med * 1e3, "first_step_ms": run_s[0] * 1e3,
                     "max_memory_allocated_mib": peak_abs / 2**20,
                     "memory_above_phase_mib": peak / 2**20, "parameters": n_params,
                     "loss_first5": float(np.mean(losses[:5])),
                     "loss_last5": float(np.mean(losses[-5:])),
                     "wall_s": time.perf_counter() - t0}
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 8f: {rec['wall_s']:.1f} s")
    return rec

# ---------------------------------------------------------------------------
# phase 8g: data-parallel training and rendering (iron_tpu_torch/dist/)
# ---------------------------------------------------------------------------

DP_WORLD = 2        # ranks of phase 8g's gloo group, both on the one card
DP_STEPS = 10       # steps of each stage a rank
DP_TIMEOUT = 300    # seconds for both ranks to finish (their group's timeout: 120 s)


def dp_configs():
    """Phase 8g's configurations: stage 1 at Stage1Config()'s width (the
    womask_iron width, 1,777,983 parameters; the warm-up cut to 2 steps so
    that 10 steps train), stage 2 at the training cell's (phase 8: comp,
    128x128 crops), and the band render's: Stage2Config() with the fallback
    sweep on every ray and no edge pass (tests/test_dist.py's render), so
    that a band traces as the whole frame does."""
    from iron_tpu_torch.surface.render import SurfaceRenderConfig
    from iron_tpu_torch.train.stage1 import Stage1Config
    from iron_tpu_torch.train.stage2 import Stage2Config
    s1 = dataclasses.replace(Stage1Config(), warm_up_end=2)
    s2 = Stage2Config(renderer_name="comp", patch_size=128,
                      surface=SurfaceRenderConfig(edge_budget=1024, interior_budget=4096))
    base = Stage2Config()
    r2 = dataclasses.replace(base, surface=dataclasses.replace(
        base.surface, handle_edges=False,
        tracer=dataclasses.replace(base.surface.tracer, fallback_budget=None)))
    return s1, s2, r2


def params_sha(params) -> str:
    """sha256 of every parameter's bytes, in named_parameters order."""
    import hashlib
    h = hashlib.sha256()
    for p in params.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_rank(spec: dict, data, rank: int, dev, store: str) -> dict:
    """Phase 8g (b) and (c) on one rank of the gloo group: 10 dp stage-1
    steps (256 rays a rank), 10 dp stage-2 steps (the first on the same crop
    on every rank, then each rank's own), the dp stage-1 render of view 0 at
    resolution level 4 and the dp band render of the render cell's view 0.
    Each step's time, all-reduce time, launches and parameter hash; rank 0
    saves the first steps' gradients and the renders into `store`."""
    import torch
    from iron_tpu_torch import kernels
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.dist.mesh import make_mesh, replicate
    from iron_tpu_torch.dist.train import (draw_dp_stage1, make_dp_stage1_render,
                                           make_dp_stage1_step, make_dp_stage2_render,
                                           make_dp_stage2_step)
    from iron_tpu_torch.train.schedules import cos_anneal_ratio
    from iron_tpu_torch.train.stage1 import init_stage1_params, stage1_adam, stage1_loss
    from iron_tpu_torch.train.stage2 import Stage2Trainer

    mesh = make_mesh(device=dev)
    c1, c2, r2 = dp_configs()
    seed = spec["seed"]
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    ar_s = []
    reduce = mesh.all_reduce_sum

    def timed_reduce(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(t)
        torch.cuda.synchronize()
        ar_s.append(time.perf_counter() - t0)
        return out

    mesh.all_reduce_sum = timed_reduce

    def run(step, params, label):
        """DP_STEPS steps of step(i) -> metrics, each synchronised and
        counted (the launch counts set to 0 just before it)."""
        rows = []
        for i in range(DP_STEPS):
            kernels.reset_launch_counts()
            del ar_s[:]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(i)
            torch.cuda.synchronize()
            rows.append({"s": time.perf_counter() - t0, "allreduce_s": sum(ar_s),
                         "allreduces": len(ar_s), "launches": kernels.launch_counts(),
                         "sha": params_sha(params),
                         "metrics": {k: float(v) for k, v in m.items()}})
            print(f"rank {rank} {label} step {i}: {rows[-1]['s'] * 1e3:.2f} ms, all-reduce "
                  f"{rows[-1]['allreduce_s'] * 1e3:.2f} ms, loss {rows[-1]['metrics']['loss']:.6f}",
                  flush=True)
        return rows

    save = lambda obj, name: rank == 0 and torch.save(obj, os.path.join(store, name))
    grads = lambda params: {n: p.grad.detach().cpu() for n, p in params.named_parameters()
                            if p.grad is not None}
    rec = {"rank": rank, "device": str(dev)}

    # stage 1: every rank draws the global step and keeps its rows
    ds = RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"], data["masks"],
                                device=dev)
    p1 = replicate(init_stage1_params(c1, gen(seed + 3 + rank), dev), mesh)
    opt1 = stage1_adam(p1.parameters(), dev)
    step1 = make_dp_stage1_step(c1, mesh)
    first = draw_dp_stage1(c1, ds, gen(seed + 40), mesh)

    def fixed_loss() -> float:
        """The global loss of the first step's rays and draws now."""
        with torch.no_grad():
            loss, _ = stage1_loss(p1, c1, first[0], cos_anneal_ratio(0, c1.anneal_end),
                                  t_rand=first[1].t_rand, t_rand_outside=first[1].t_rand_outside,
                                  reduce_sums=reduce)
            return float(reduce(loss.reshape(1).clone()))

    g1 = gen(seed + 40)
    before = fixed_loss()

    def s1_step(i):
        batch, draws = draw_dp_stage1(c1, ds, g1, mesh)
        m = step1(p1, opt1, batch, i, draws)
        if i == 0:
            save(grads(p1), "s1_grads.pt")
        return m

    rec["stage1"] = {"rows": run(s1_step, p1, "stage 1"), "fixed_loss": [before, fixed_loss()],
                     "rays_a_rank": first[0].shape[0]}

    # stage 2: the first step on the same crop and eikonal points on every
    # rank, then each rank's own crop of one draw for all ranks
    tr2 = Stage2Trainer(c2, data["images"], data["Ks"], data["W2Cs"],
                        generator=gen(seed + 50 + rank), device=dev)
    replicate(tr2.params, mesh)
    step2 = make_dp_stage2_step(c2, tr2.mat_cfgs, mesh, data["images"], data["Ks"],
                                data["W2Cs"])
    ps = c2.patch_size
    n_eik = ps * ps // 2
    eik_same = torch.rand((n_eik, 3), generator=gen(spec["eik_seed"]), device=dev) * 2 - 1
    g_eik = gen(seed + 60 + rank)
    g_crop = np.random.default_rng(seed + 70)
    n_views, H, W = data["images"].shape[:3]

    def s2_step(i):
        crops = [(int(g_crop.integers(0, n_views)), int(g_crop.integers(0, W - ps)),
                  int(g_crop.integers(0, H - ps))) for _ in range(mesh.size)]
        eik = torch.rand((n_eik, 3), generator=g_eik, device=dev) * 2 - 1
        if i == 0:
            crop, eik = tuple(spec["crop"]), eik_same
        else:
            crop = crops[rank]
        m = step2(tr2.params, tr2.opt, *crop, eik)
        if i == 0:
            save(grads(tr2.params), "s2_grads.pt")
        return m

    rec["stage2"] = {"rows": run(s2_step, tr2.params, "stage 2")}

    # the renders
    p_r = init_stage1_params(c1, gen(seed + 3), dev)
    ro, rd = ds.gen_rays_grid(0, 4)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    color, normal = make_dp_stage1_render(c1, mesh)(p_r, ro.reshape(-1, 3), rd.reshape(-1, 3))
    torch.cuda.synchronize()
    rec["render1"] = {"s": time.perf_counter() - t0, "launches": kernels.launch_counts(),
                      "rays": ro.numel() // 3}
    save({"color": color.cpu(), "normal": normal.cpu()}, "render1.pt")
    Ks_r, W2Cs_r = ring_cameras(spec["views"], spec["res"])
    res = spec["res"]
    tr_r = Stage2Trainer(r2, np.zeros((spec["views"], res, res, 3), np.float32), Ks_r, W2Cs_r,
                         generator=gen(seed), device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf = make_dp_stage2_render(r2, tr_r.mat_cfgs, mesh, res, res)(tr_r.params, Ks_r[0],
                                                                   W2Cs_r[0])
    torch.cuda.synchronize()
    rec["render2"] = {"s": time.perf_counter() - t0, "launches": kernels.launch_counts()}
    save({k: v.cpu() for k, v in buf.items()}, "render2.pt")
    return rec


TP_STEPS = 5         # phase 8h (e): stage-1 steps of the tp ranks


def tp_rank(spec: dict, data, rank: int, dev) -> dict:
    """Phase 8h (e) on one rank of a (dp 1, tp 2) gloo group on the card:
    TP_STEPS stage-1 steps at Stage1Config()'s width (every rank the whole
    512-ray batch), Adam over this rank's tp shards; after each step the
    sha256 of the whole tree (all-gathered over tp by the step), at the end
    that of Adam's moments all-gathered over tp, and this rank's Adam-state
    bytes."""
    import hashlib
    import torch
    from iron_tpu_torch import kernels
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.dist.mesh import make_mesh
    from iron_tpu_torch.dist.train import (draw_dp_stage1, make_dp_stage1_step, tp_dims,
                                           tp_shards)
    from iron_tpu_torch.train.stage1 import init_stage1_params, stage1_adam

    mesh = make_mesh(dp=1, tp=spec["world"], device=dev)
    c1 = dp_configs()[0]
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    ds = RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"], data["masks"],
                                device=dev)
    params = init_stage1_params(c1, gen(spec["seed"]), dev)
    shards = tp_shards(params, mesh)
    opt = stage1_adam(shards.values(), dev)
    step = make_dp_stage1_step(c1, mesh)
    g = gen(spec["seed"] + 1)
    rows = []
    for i in range(spec["steps"]):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch, draws = draw_dp_stage1(c1, ds, g, mesh)
        m = step(params, opt, batch, i, draws)
        torch.cuda.synchronize()
        rows.append({"s": time.perf_counter() - t0, "sha": params_sha(params),
                     "launches": kernels.launch_counts(), "loss": float(m["loss"])})
    dims = tp_dims(params, mesh)
    h = hashlib.sha256()
    for q, d in zip(shards.values(), dims.values()):
        for key in ("exp_avg", "exp_avg_sq"):
            t = opt.state[q][key]
            h.update((mesh.all_gather(t, "tp", d) if d is not None else t).cpu().numpy().tobytes())
    adam_bytes = sum(t.numel() * t.element_size() for st in opt.state.values()
                     for k, t in st.items() if k != "step")
    return {"rank": rank, "tp_rank": mesh.tp_rank, "rows": rows, "adam_sha": h.hexdigest(),
            "adam_bytes": adam_bytes,
            "sharded_leaves": sum(1 for d in dims.values() if d is not None)}


def dp_worker(args) -> int:
    """`chip_smoke.py --dp-worker RANK --dp-store DIR`: one rank of phase
    8g's gloo group on the card, or of phase 8h (e)'s tp group (its spec
    and data in DIR, written by the phase); prints one JSON line
    {"dp_rank": ...} and exits 0, or raises."""
    import torch.distributed as dist
    from iron_tpu_torch.dist.mesh import initialize_distributed

    with open(os.path.join(args.dp_store, "spec.json")) as f:
        spec = json.load(f)
    data = dict(np.load(os.path.join(args.dp_store, "data.npz")))
    dev = initialize_distributed(backend="gloo", device="cuda",
                                 init_method="file://" + os.path.join(args.dp_store, "init"),
                                 rank=args.dp_worker, world_size=spec["world"],
                                 local_rank=args.dp_worker, timeout=spec["group_timeout"])
    try:
        if spec.get("kind") == "tp":
            rec = tp_rank(spec, data, args.dp_worker, dev)
        else:
            rec = dp_rank(spec, data, args.dp_worker, dev, args.dp_store)
    finally:
        dist.destroy_process_group()
    print(json.dumps({"dp_rank": rec}), flush=True)
    return 0


def dp_phase(args, dev, card, data, kernels, h) -> dict:
    """Phase 8g, data-parallel training and rendering (iron_tpu_torch/dist/)
    at full width on phase 8's data:

      (a) NCCL at a world of 1 in this process: 3 dp stage-1 steps and 3 dp
          stage-2 steps bit-equal to the single-device trainers' steps from
          the same state (and each trainer's steps run twice, bit-equal: the
          single-device step is reproducible);
      (b) two ranks on the one card over gloo (subprocesses of this script,
          `--dp-worker`): 10 stage-1 steps of 256 rays a rank (the global
          batch 512), the first step's summed gradients against the
          single-device step on the global batch and draws at phase 8d's
          holds, the parameters bit-equal on both ranks after every step
          (sha256), the loss of the first step's rays falling; 10 stage-2
          steps, the first on the same crop on both ranks (its averaged
          gradients against the single-device step: bit-equal, or within
          phase 8's 5e-3 hold, reported), then each rank's own crop, the
          parameters bit-equal after every step; every kernel of each path
          launched at every step and no other;
      (c) the dp stage-1 render of view 0 at resolution level 4 against
          Stage1Trainer.render_image at 1e-5, and the dp band render of the
          render cell's view 0 (args.res square, fallback_budget None, no
          edge pass) against Stage2Trainer.render_full, away from the band
          seam at tests/test_dist.py's holds (colour 1e-2, masks 0.5%).

    `h` holds phase 8's helpers and this call's single-device step medians.
    Two processes on one card time-slice it and their all-reduce goes
    through the host (gloo): the times are a correctness run's, not a
    multi-GPU speed figure.  Returns the {"dp"} record."""
    import signal
    import tempfile
    import torch
    import torch.distributed as dist
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.dist.mesh import initialize_distributed, make_mesh
    from iron_tpu_torch.dist.train import make_dp_stage1_step, make_dp_stage2_step
    from iron_tpu_torch.train.schedules import cos_anneal_ratio
    from iron_tpu_torch.train.stage1 import (Stage1Trainer, draw_stage1, stage1_adam,
                                             stage1_loss)
    from iron_tpu_torch.train.stage2 import Stage2Trainer, make_optimizer, stage2_loss

    t_phase = time.perf_counter()
    c1, c2, r2 = dp_configs()
    seed = args.seed
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    ds = RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"], data["masks"],
                                device=dev)
    new_s1 = lambda: Stage1Trainer(c1, ds, generator=gen(seed + 3), device=dev)
    new_s2 = lambda: Stage2Trainer(c2, data["images"], data["Ks"], data["W2Cs"],
                                   generator=gen(seed + 50), device=dev)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    rec = {"card": card, "note": (
        "(b) and (c) are two processes time-slicing one card, their all-reduce through "
        "gloo (host memory): a correctness run, not a multi-GPU speed figure")}

    # (a) NCCL at a world of 1
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        initialize_distributed(backend="nccl", device=dev,
                               init_method="file://" + os.path.join(tmp, "init"), rank=0,
                               world_size=1, local_rank=dev.index or 0)
        try:
            mesh = make_mesh(device=dev)
            tr, tr_again = new_s1(), new_s1()
            p_dp = copy.deepcopy(tr.params)
            opt_dp = stage1_adam(p_dp.parameters(), dev)
            step1 = make_dp_stage1_step(c1, mesh)
            g = gen(seed + 41)
            s1_same, s1_repro = [], []
            for i in range(3):
                d = tr.draw(g)
                batch = ds.gen_random_rays(d.img_idx, c1.batch_size, px=d.px, py=d.py)
                tr.train_step(d)
                tr_again.train_step(d)
                step1(p_dp, opt_dp, batch, i, d)
                s1_same.append(same(tr.params, p_dp))
                s1_repro.append(same(tr.params, tr_again.params))
            tr, tr_again = new_s2(), new_s2()
            p_dp = copy.deepcopy(tr.params)
            opt_dp = make_optimizer(c2, p_dp)
            step2 = make_dp_stage2_step(c2, tr.mat_cfgs, mesh, data["images"], data["Ks"],
                                        data["W2Cs"])
            g_crop, g_eik = np.random.default_rng(seed + 42), gen(seed + 43)
            n_views, H, W = data["images"].shape[:3]
            ps = c2.patch_size
            s2_same, s2_repro = [], []
            for i in range(3):
                crop = (int(g_crop.integers(0, n_views)), int(g_crop.integers(0, W - ps)),
                        int(g_crop.integers(0, H - ps)))
                eik = torch.rand((ps * ps // 2, 3), generator=g_eik, device=dev) * 2 - 1
                tr.train_step(*crop, eik)
                tr_again.train_step(*crop, eik)
                step2(p_dp, opt_dp, *crop, eik)
                s2_same.append(same(tr.params, p_dp))
                s2_repro.append(same(tr.params, tr_again.params))
        finally:
            dist.destroy_process_group()
    rec["nccl_world_1"] = {"stage1_bit_equal": s1_same, "stage2_bit_equal": s2_same,
                           "single_device_reproducible": {"stage1": s1_repro,
                                                          "stage2": s2_repro}}
    log(f"phase 8g (a) NCCL at a world of 1: after each of 3 steps the dp parameters "
        f"bit-equal to the single-device trainer's: stage 1 {s1_same}, stage 2 {s2_same} (the "
        f"single-device steps run twice bit-equal: stage 1 {s1_repro}, stage 2 {s2_repro})")
    assert all(s1_same) and all(s2_same)

    # (b), (c) two ranks on the card over gloo
    with tempfile.TemporaryDirectory(dir=HERE) as store:
        np.savez(os.path.join(store, "data.npz"), **{k: np.asarray(data[k]) for k in
                                                     ("images", "Ks", "W2Cs", "masks")})
        spec = {"world": DP_WORLD, "seed": seed, "views": args.views, "res": args.res,
                "crop": list(h["crop"]), "eik_seed": h["eik_seed"], "group_timeout": 120}
        with open(os.path.join(store, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                                   str(r), "--dp-store", store], cwd=HERE, text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  start_new_session=True) for r in range(DP_WORLD)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DP_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        workers_s = time.perf_counter() - t0
        for r, out in enumerate(outs):
            for line in out.splitlines():
                if not line.startswith('{"dp_rank"'):
                    log(f"  [rank {r}] {line}")
        assert all(p.returncode == 0 for p in procs), [p.returncode for p in procs]
        ranks = [json.loads([ln for ln in out.splitlines() if ln.startswith('{"dp_rank"')][-1])
                 ["dp_rank"] for out in outs]
        load = lambda name, loc: torch.load(os.path.join(store, name), map_location=loc)
        s1_grads, s2_grads = load("s1_grads.pt", dev), load("s2_grads.pt", dev)
        render1, render2 = load("render1.pt", "cpu"), load("render2.pt", "cpu")

    # both ranks: the same parameters after every step, the same metrics
    for stage in ("stage1", "stage2"):
        a, b = (rk[stage]["rows"] for rk in ranks)
        assert [x["sha"] for x in a] == [x["sha"] for x in b], stage
        assert [x["metrics"] for x in a] == [x["metrics"] for x in b], stage
        assert all(np.isfinite(v) for x in a for v in x["metrics"].values()), stage
    rows1, rows2 = ranks[0]["stage1"]["rows"], ranks[0]["stage2"]["rows"]
    for rk in ranks:
        for x in rk["stage1"]["rows"]:
            assert {k: v for k, v in x["launches"].items() if v} == {
                "sdf_value_feat_grad": 1, "sdf_value_feat_grad_bwd": 1}, x["launches"]
        for x in rk["stage2"]["rows"]:
            assert all(x["launches"][k] >= 1 for k in h["step_path"]), x["launches"]
            assert all(v == 0 for k, v in x["launches"].items() if k not in h["step_path"])
    before, after = ranks[0]["stage1"]["fixed_loss"]
    log(f"phase 8g (b) two ranks on the card over gloo ({workers_s:.1f} s): parameters "
        f"bit-equal on both ranks after each of {DP_STEPS} steps of each stage; stage-1 loss "
        f"{[round(x['metrics']['loss'], 4) for x in rows1]}, the first step's rays' loss "
        f"{before:.6f} before, {after:.6f} after; stage-2 loss "
        f"{[round(x['metrics']['loss'], 4) for x in rows2]}")
    assert after < before

    # the first stage-1 step against the single-device step on the global
    # batch and draws (phase 8d's holds: 1e-5 loss, 1e-4 metrics, 1e-4 of
    # each leaf's largest entry + 1e-7 of the step's)
    tr1 = new_s1()
    d = draw_stage1(c1, ds, gen(seed + 40))
    batch = ds.gen_random_rays(d.img_idx, c1.batch_size, px=d.px, py=d.py)
    loss, m = stage1_loss(tr1.params, c1, batch, cos_anneal_ratio(0, c1.anneal_end),
                          t_rand=d.t_rand, t_rand_outside=d.t_rand_outside)
    loss.backward()
    g1 = {n: p.grad for n, p in tr1.params.named_parameters()}
    errs = h["leaf_errs"](s1_grads, g1, 1e-4)
    worst = max(errs, key=errs.get)
    m1 = rows1[0]["metrics"]
    m_rel = {k: abs(m1[k] - float(v.detach())) / max(abs(float(v.detach())), 1e-6)
             for k, v in m.items()}
    log(f"  stage 1, the first step (2 x {ranks[0]['stage1']['rays_a_rank']} rays) against the "
        f"single-device step on its {c1.batch_size} rays and draws: loss rel diff "
        f"{m_rel['loss']:.3e} (tol 1e-5), largest metric rel diff {max(m_rel.values()):.3e} (tol "
        f"1e-4), worst gradient leaf {worst} at {errs[worst]:.3f} of its tolerance")
    assert set(s1_grads) == set(g1) and m_rel["loss"] <= 1e-5
    assert max(m_rel.values()) <= 1e-4 and errs[worst] <= 1.0

    # the first stage-2 step (the same crop on both ranks) against the
    # single-device step: bit-equal if the step is deterministic, else at
    # phase 8's 5e-3
    tr2 = new_s2()
    cam, gt, _ = tr2.crop(*h["crop"])
    eik = torch.rand((c2.patch_size ** 2 // 2, 3), generator=gen(h["eik_seed"]),
                     device=dev) * 2 - 1
    loss2, _ = stage2_loss(tr2.params, tr2.mat_cfgs, c2, cam, gt, eik)
    loss2.backward()
    g2 = {n: p.grad for n, p in tr2.params.named_parameters() if p.grad is not None}
    bit_equal2 = set(g2) <= set(s2_grads) and all(torch.equal(s2_grads[n], g2[n]) for n in g2)
    errs2 = h["leaf_errs"]({n: s2_grads[n] for n in g2}, g2, 5e-3)
    worst2 = max(errs2, key=errs2.get)
    log(f"  stage 2, the first step (crop {h['crop']} on both ranks) against the single-device "
        f"step: loss {rows2[0]['metrics']['loss']:.6f} vs {float(loss2.detach()):.6f}, averaged "
        f"gradients bit-equal: {bit_equal2}; worst leaf {worst2} at {errs2[worst2]:.3e} of phase "
        f"8's 5e-3 hold; leaves without a gradient on the single device: "
        f"{len(s2_grads) - len(g2)}, all zero in the dp step: "
        f"{all(not bool(s2_grads[n].any()) for n in s2_grads if n not in g2)}")
    assert errs2[worst2] <= 1.0
    assert all(not bool(s2_grads[n].any()) for n in s2_grads if n not in g2)

    # (c) the renders
    r1 = new_s1().render_image(0, resolution_level=4)
    got_c = render1["color"].reshape(r1["color"].shape).numpy()
    got_n = render1["normal"].reshape(r1["normal"].shape).numpy()
    dc, dn = float(np.abs(got_c - r1["color"]).max()), float(np.abs(got_n - r1["normal"]).max())
    l1 = ranks[0]["render1"]["launches"]
    log(f"phase 8g (c) dp stage-1 render of view 0 at level 4 ({ranks[0]['render1']['rays']} rays, "
        f"{ranks[0]['render1']['s']:.3f} s, launches a rank {l1}) against render_image: colour "
        f"within {dc:.3e}, normal within {dn:.3e} (tol 1e-5)")
    assert dc <= 1e-5 and dn <= 1e-5
    assert {k: v for k, v in l1.items() if v} == {"sdf_value_feat_grad": l1["sdf_value_feat_grad"]}
    assert l1["sdf_value_feat_grad"] >= 1
    res = args.res
    Ks_r, W2Cs_r = ring_cameras(args.views, res)
    tr_r = Stage2Trainer(r2, np.zeros((args.views, res, res, 3), np.float32), Ks_r, W2Cs_r,
                         generator=gen(seed), device=dev)
    t0 = time.perf_counter()
    full = tr_r.render_full(0)
    full_s = time.perf_counter() - t0
    band = res // DP_WORLD
    rows = np.setdiff1d(np.arange(res), np.concatenate([np.arange(res, step=band),
                                                        np.arange(res, step=band) - 1]))
    got = {k: v.numpy() for k, v in render2.items()}
    dcol = float(np.abs(got["color"][rows] - full["color"][rows]).max())
    mdiff = float((got["convergent_mask"][rows] != full["convergent_mask"][rows]).mean())
    hit = float(full["convergent_mask"].mean())
    l2 = ranks[0]["render2"]["launches"]
    log(f"  dp band render of view 0 at {res}x{res} ({band} rows a rank, "
        f"{ranks[0]['render2']['s']:.3f} s; render_full {full_s:.3f} s; launches a rank {l2}) "
        f"against render_full, fallback_budget None and no edge pass in both, away from the "
        f"seam: colour within {dcol:.3e} (tol 1e-2), masks apart on {mdiff:.2e} of the pixels "
        f"(tol 5e-3), {hit:.4f} of the frame hit")
    assert got["color"].shape == full["color"].shape and hit > 0.01
    assert dcol <= 1e-2 and mdiff < 5e-3
    assert all(l2[k] >= 1 for k in ("coarse_march", "sdf_only_bf16", "sdf_value_feat_grad"))

    med = lambda rows_, key: float(np.median([x[key] for x in rows_[1:]]))
    per_step = lambda rows_: {k: float(np.mean([x["launches"][k] for x in rows_]))
                              for k in rows_[0]["launches"]}
    rec.update({
        "stage1": {"rays_a_rank": ranks[0]["stage1"]["rays_a_rank"],
                   "step_ms_median_a_rank": [med(rk["stage1"]["rows"], "s") * 1e3
                                             for rk in ranks],
                   "single_device_step_ms_median": h["s1_median_s"] * 1e3,
                   "allreduce_ms_a_step": med(rows1, "allreduce_s") * 1e3,
                   "allreduces_a_step": rows1[0]["allreduces"],
                   "launches_a_rank_a_step": per_step(rows1),
                   "loss": [x["metrics"]["loss"] for x in rows1],
                   "first_step_grad_err": errs[worst]},
        "stage2": {"step_ms_median_a_rank": [med(rk["stage2"]["rows"], "s") * 1e3
                                             for rk in ranks],
                   "single_device_step_ms_median": h["s2_median_s"] * 1e3,
                   "allreduce_ms_a_step": med(rows2, "allreduce_s") * 1e3,
                   "allreduces_a_step": rows2[0]["allreduces"],
                   "launches_a_rank_a_step": per_step(rows2),
                   "loss": [x["metrics"]["loss"] for x in rows2],
                   "same_crop_grads_bit_equal": bit_equal2,
                   "same_crop_grad_err_of_5e-3": errs2[worst2]},
        "render1": {**ranks[0]["render1"], "color_err": dc, "normal_err": dn},
        "render2": {**ranks[0]["render2"], "color_err": dcol, "mask_diff": mdiff,
                    "render_full_s": full_s},
        "workers_s": workers_s, "steps": DP_STEPS, "world": DP_WORLD})
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 8g: {rec['wall_s']:.1f} s; stage-1 step median a rank "
        f"{rec['stage1']['step_ms_median_a_rank']} ms (single device {h['s1_median_s'] * 1e3:.2f} "
        f"ms), all-reduce {rec['stage1']['allreduce_ms_a_step']:.2f} ms a step; stage-2 "
        f"{rec['stage2']['step_ms_median_a_rank']} ms (single device "
        f"{h['s2_median_s'] * 1e3:.2f} ms), all-reduce {rec['stage2']['allreduce_ms_a_step']:.2f} "
        f"ms a step; card {card}")
    return rec


# ---------------------------------------------------------------------------
# phase 8h: the chunked runs (stage 1 as a replayed CUDA graph), orbax, the
# video and tp
# ---------------------------------------------------------------------------

def _trainer_state(tr) -> tuple:
    """Copies of a Stage1Trainer's parameters and Adam state (in parameter
    order) and its step and count."""
    params = [p.detach().clone() for p in tr.params.parameters()]
    adam = [{k: v.clone() for k, v in tr.opt.state[p].items()} for p in tr.params.parameters()]
    return params, adam, tr.step, tr.opt_count


def _restore_trainer(tr, state) -> None:
    """Put a _trainer_state back in place: the same tensors, so that a
    captured step reads them."""
    params, adam, tr.step, tr.opt_count = state
    import torch
    with torch.no_grad():
        for p, v, st in zip(tr.params.parameters(), params, adam):
            p.copy_(v)
            for k, t in st.items():
                tr.opt.state[p][k].copy_(t)


def _states_equal(a, b) -> bool:
    import torch
    return (a[2:] == b[2:] and all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
            and all(torch.equal(x[k], y[k]) for x, y in zip(a[1], b[1]) for k in x))


def _metrics_equal(ha, hb) -> bool:
    import torch
    return len(ha) == len(hb) and all(torch.equal(a[k], b[k]) for a, b in zip(ha, hb) for k in a)


# each kernel's name on the device and the wrapper that launches it; K3-bwd
# launches two kernels, its reduction counted apart; K5 is K3-fwd's kernel
# without the gradient (GRAD false: "false>" demangled, "Lb0E" mangled)
_DEVICE_KERNELS = (("coarse_march_kernel", "coarse_march"),
                   ("sdf_only_bf16_kernel", "sdf_only_bf16"),
                   ("sdf_only_3pass_kernel", "sdf_only_3pass"),
                   ("sdf_grad_bwd_kernel", "sdf_value_feat_grad_bwd"),
                   ("reduce_partials_kernel", "reduce_partials"),
                   ("sdf_grad_fwd_kernel", None))


# the device traces, run after every timed phase (run_deferred_traces): once
# CUPTI has traced in a process, the host's later launches can run slower,
# which would skew each phase timed after a trace
DEFERRED_TRACES = []


def run_deferred_traces() -> None:
    while DEFERRED_TRACES:
        DEFERRED_TRACES.pop(0)()


def traced_launches(fn, names) -> dict:
    """Run fn() under torch.profiler's device trace (CUPTI's kernel records,
    which a CUDA graph's replays make as eager launches do) and count the
    kernels it ran by their names on the device: {wrapper name: count} for
    `names`, and "reduce_partials" (K3-bwd's reduction).  The measure of
    what a replay launches: a replay runs no wrapper, so no wrapper counts
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(list(names) + ["reduce_partials"], 0)
    for e in prof.key_averages():
        for dev_name, name in _DEVICE_KERNELS:
            if dev_name in e.key:
                if name is None:
                    name = ("sdf_full" if "false>" in e.key or "Lb0E" in e.key
                            else "sdf_value_feat_grad")
                counts[name] += e.count
                break
    return counts


def orbax_check(dev) -> dict:
    """Phase 8h (c): tests/data_orbax (a JAX stage-1 run saved through orbax
    by scripts/make_orbax_fixture.py) read by read_orbax_checkpoint through
    the port's own OCDBT, zarr and zstd readers (this machine has no
    tensorstore and no zstandard), every leaf of params and optax state
    bit-equal to the same checkpoint's pickle, and train_surface
    --neus_ckpt_fpath on the run directory adopting its SDF bit for bit (in
    process, --device cpu, --num_iters 0: the fixture's 16-wide SDF is below
    the kernels' width of 256)."""
    import contextlib
    import importlib.util
    import io
    import tempfile
    from iron_tpu_torch.train.checkpoints import load_checkpoint, read_orbax_checkpoint
    fixture = os.path.join(HERE, "tests", "data_orbax")
    step_dir = os.path.join(fixture, "stage1", "orbax", "0000002")
    have = {m: importlib.util.find_spec(m) is not None for m in ("tensorstore", "zstandard")}
    log(f"phase 8h (c) orbax: importable on this machine: {have}")
    t = time.perf_counter()
    got = read_orbax_checkpoint(step_dir)
    read_ms = (time.perf_counter() - t) * 1e3
    ref = load_checkpoint(os.path.join(fixture, "stage1_step2.pkl"))
    a, b = _leaves([got["params"], got["opt_state"]]), _leaves([ref["params"], ref["opt_state"]])
    read_equal = (len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                           for x, y in zip(a, b))
                  and got["step"] == ref["step"] and got["extra"] == ref["extra"])
    from iron_tpu_torch.cli import train_surface
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset, write_scene_dir
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        scene = write_scene_dir(render_synthetic_dataset("sphere", n_views=2, H=24, W=24,
                                                         light=30.0, device="cpu"),
                                os.path.join(tmp, "scene"))
        with contextlib.redirect_stdout(io.StringIO()):
            train_surface.main(["--data_dir", scene, "--out_dir", os.path.join(tmp, "exp"),
                                "--neus_ckpt_fpath", os.path.join(fixture, "stage1"),
                                "--renderer_name", "ggx", "--num_iters", "0",
                                "--patch_size", "16", "--skip_final_export", "--sync_ckpt",
                                "--device", "cpu"])
        sdf = load_checkpoint(os.path.join(tmp, "exp", "ckpt_0000000.pkl"))["params"]["sdf"]
    a, b = _leaves(sdf), _leaves(ref["params"]["sdf"])
    adopted = len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    log(f"  read the fixture in {read_ms:.1f} ms (step {got['step']}, "
        f"{len(_leaves(got['params']))} parameter "
        f"leaves, optax state {[type(s_).__name__ for s_ in got['opt_state']]}) bit-equal to its "
        f"pickle: {read_equal}; train_surface warm-started from the orbax run, its SDF the "
        f"fixture's bit for bit: {adopted}")
    assert read_equal and adopted
    return {"importable": have, "read_ms": read_ms,
            "did": "read the fixture with the port's OCDBT / zarr / zstd readers and "
                   "warm-started train_surface from the orbax run",
            "read_bit_equal": read_equal, "warm_start_sdf_bit_equal": adopted}


def video_check(tr, kernels) -> dict:
    """Phase 8h (d): Stage1Trainer.interpolate_view_video of views 0 and 1,
    8 frames at resolution level 4, written to .avi as MPEG-4 Part 2
    (`mp4v`, the JAX package's cv2.VideoWriter fourcc; this machine has no
    decoder of it): the RIFF structure (an `mp4v` stream, one `00dc` chunk a
    frame, each the stream's headers and one I-VOP), 16 frames (ping-pong),
    and the encoder's own reconstruction of each frame within a mean of
    3/255 of the same frame rendered again (the 4:2:0 chroma's loss on the
    render's edges; the CPU test holds FFmpeg's decode to that
    reconstruction)."""
    import struct
    import tempfile
    import torch
    import iron_tpu_torch.train.stage1 as S1
    n = 8
    recs = []
    write = S1.write_mpeg4_video

    def kept(path, frames, fps):
        recs.extend(write(path, frames, fps))

    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        path = os.path.join(tmp, "interp.avi")
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        S1.write_mpeg4_video = kept
        try:
            t0 = time.perf_counter()
            tr.interpolate_view_video(0, 1, path, n_frames=n, resolution_level=4)
            write_s = time.perf_counter() - t0
        finally:
            S1.write_mpeg4_video = write
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        with open(path, "rb") as f:
            data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI ", data[:12]
    assert data[data.index(b"strh") + 12:][:4] == b"mp4v"
    movi = data.index(b"movi") + 4
    chunks = []
    while data[movi:movi + 4] == b"00dc":
        size = struct.unpack_from("<I", data, movi + 4)[0]
        chunks.append(data[movi + 8:movi + 8 + size])
        movi += 8 + size + (size & 1)
    assert len(chunks) == len(recs) == 2 * n, (len(chunks), len(recs))
    assert all(c[:4] == b"\0\0\1\xb0" and c.count(b"\0\0\1\xb6") == 1 for c in chunks)
    frames = []
    for i in range(n):
        ratio = np.sin(((i / n) - 0.5) * np.pi) * 0.5 + 0.5
        frames.append((np.clip(tr.render_novel_view(0, 1, ratio, 4), 0, 1) * 255)
                      .astype(np.uint8))
    frames = frames + frames[::-1]
    errs = [float(np.abs(rgb.astype(np.float64) - b).mean()) for (rgb, _), b in zip(recs, frames)]
    log(f"phase 8h (d) interpolate_view_video: {len(chunks)} mp4v frames of "
        f"{recs[0][0].shape} in {len(data)} bytes of AVI, {write_s:.2f} s; launches "
        f"{launches}; each reconstructed frame's mean difference from the render, in 1/255: "
        f"max {max(errs):.3f} (hold 3)")
    assert max(errs) <= 3.0
    assert set(launches) == {"sdf_value_feat_grad"}, launches
    return {"codec": "mp4v", "frames": len(chunks), "shape": list(recs[0][0].shape),
            "bytes": len(data), "write_s": write_s, "launches": launches,
            "max_mean_err_255": max(errs)}


def tp_check(args, dev, data) -> dict:
    """Phase 8h (e): two ranks on the card over gloo, a (dp 1, tp 2) mesh,
    TP_STEPS stage-1 steps (tp_rank), against the same steps on one device
    in this process (make_dp_stage1_step on a mesh of one rank, Adam over
    the whole tree): the parameters bit-equal after every step on both
    ranks, Adam's moments (gathered over tp) bit-equal at the end; each
    rank's Adam-state bytes against one device's."""
    import hashlib
    import signal
    import tempfile
    import torch
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.dist.mesh import Mesh
    from iron_tpu_torch.dist.train import draw_dp_stage1, make_dp_stage1_step
    from iron_tpu_torch.train.stage1 import init_stage1_params, stage1_adam

    spec = {"kind": "tp", "world": 2, "seed": args.seed + 90, "steps": TP_STEPS,
            "group_timeout": 120}
    with tempfile.TemporaryDirectory(dir=HERE) as store:
        np.savez(os.path.join(store, "data.npz"), **{k: np.asarray(data[k]) for k in
                                                     ("images", "Ks", "W2Cs", "masks")})
        with open(os.path.join(store, "spec.json"), "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                                   str(r), "--dp-store", store], cwd=HERE, text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  start_new_session=True) for r in range(spec["world"])]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DP_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        workers_s = time.perf_counter() - t0
    for r, out in enumerate(outs):
        for line in out.splitlines():
            if not line.startswith('{"dp_rank"'):
                log(f"  [tp rank {r}] {line}")
    assert all(p.returncode == 0 for p in procs), [p.returncode for p in procs]
    ranks = [json.loads([ln for ln in out.splitlines() if ln.startswith('{"dp_rank"')][-1])
             ["dp_rank"] for out in outs]

    # one device: the same initial tree and draws, Adam over the whole tree
    c1 = dp_configs()[0]
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    ds = RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"], data["masks"],
                                device=dev)
    mesh1 = Mesh(None, 0, 1, dev, {"dp": 1, "tp": 1})
    params = init_stage1_params(c1, gen(spec["seed"]), dev)
    opt = stage1_adam(params.parameters(), dev)
    step = make_dp_stage1_step(c1, mesh1)
    g = gen(spec["seed"] + 1)
    shas = []
    for i in range(TP_STEPS):
        batch, draws = draw_dp_stage1(c1, ds, g, mesh1)
        step(params, opt, batch, i, draws)
        shas.append(params_sha(params))
    h = hashlib.sha256()
    for p in params.parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            h.update(opt.state[p][key].cpu().numpy().tobytes())
    one_bytes = sum(t.numel() * t.element_size() for st in opt.state.values()
                    for k, t in st.items() if k != "step")
    params_equal = all([x["sha"] for x in rk["rows"]] == shas for rk in ranks)
    medians = [round(float(np.median([x["s"] for x in rk["rows"][1:]])) * 1e3, 2)
               for rk in ranks]
    adam_equal = all(rk["adam_sha"] == h.hexdigest() for rk in ranks)
    launches = [{k: v for k, v in x["launches"].items() if v} for x in ranks[0]["rows"]]
    log(f"phase 8h (e) tp = 2 over gloo on the card ({workers_s:.1f} s for both ranks): "
        f"{ranks[0]['sharded_leaves']} leaves sharded; the whole tree after each of "
        f"{TP_STEPS} steps bit-equal to one device's on both ranks: {params_equal}; Adam's "
        f"moments gathered over tp bit-equal: {adam_equal}; losses "
        f"{[round(x['loss'], 5) for x in ranks[0]['rows']]}; Adam-state bytes a rank "
        f"{[rk['adam_bytes'] for rk in ranks]} against {one_bytes} on one device; step "
        f"median a rank {medians} "
        f"ms (two processes time-slicing one card); launches a step {launches[-1]}")
    assert params_equal and adam_equal
    assert all(d == {"sdf_value_feat_grad": 1, "sdf_value_feat_grad_bwd": 1} for d in launches)
    assert all(rk["adam_bytes"] < one_bytes for rk in ranks)
    return {"params_bit_equal": params_equal, "adam_bit_equal": adam_equal,
            "launches_a_step": launches[-1], "sharded_leaves": ranks[0]["sharded_leaves"],
            "adam_bytes_a_rank": [rk["adam_bytes"] for rk in ranks],
            "adam_bytes_one_device": one_bytes, "workers_s": workers_s,
            "step_ms_a_rank": [[x["s"] * 1e3 for x in rk["rows"]] for rk in ranks],
            "losses": [x["loss"] for x in ranks[0]["rows"]]}


def graph_phase(args, dev, card, data, kernels) -> dict:
    """Phase 8h, the chunked runs and the rest of the port's last slice, on
    phase 8's data:

      (a) Stage1Trainer.run(steps_per_call > 1) at Stage1Config()'s width,
          warm_up_end 100 and anneal_end 200, so that from step 1 the
          learning rate and the anneal change on every step: a first chunk
          of 8 (an eager warm-up step, the capture, 7 replays); then from
          the same state 8 eager steps, one a call, and the same 8 steps as
          8 replays: parameters, Adam state and metrics bit-equal, the
          replays' draws (read from the graph after each replay) equal to
          the eager draws and different from one replay to the next; each
          step timed (synchronised), no wrapper run by the replays, and
          (at the script's end) what 4 more replays ran in torch.profiler's
          device trace: K3-fwd and K3-bwd (its two kernels) once a replay.
          Then a 16-step
          chunk with use_occupancy and occupancy_update_every 8 against the
          eager loop under the JAX package's chunk rule (the grid refreshed
          once, at the chunk's start), and a 3-step chunk with
          upsample_pallas against 3 eager steps, both bit-equal, and 2
          replays of the latter traced at the end (K2 four times a
          replay);
      (b) Stage2Trainer.run(4, steps_per_call=4) at Stage2Config() (128x128
          crops): the crops drawn on the device within the JAX package's
          bounds, each step launching K1 2, K2 2, K3-fwd 3 and K3-bwd 3
          times and no K4 or K5, finite metrics;
      (c) orbax (orbax_check): the committed fixture read without
          tensorstore bit for bit as its pickle, and train_surface
          warm-started from it;
      (d) the interpolation video (video_check);
      (e) tp (tp_check): two gloo ranks on the card, dp 1 and tp 2, against
          one device.
    Returns the {"graph"} record."""
    import torch
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.train.stage1 import Stage1Config, Stage1Trainer
    from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer

    t_phase = time.perf_counter()
    seed = args.seed
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    ds = RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"], data["masks"],
                                device=dev)
    rec = {"card": card, "wall_s": {}}

    # (a) the stage-1 graph
    t0 = time.perf_counter()
    cfg = dataclasses.replace(Stage1Config(), warm_up_end=100, anneal_end=200)
    tr = Stage1Trainer(cfg, ds, generator=gen(seed + 80), device=dev)
    tr.run(1, seed=seed, steps_per_call=1)              # step 1: Adam's state made
    start = _trainer_state(tr)
    lrs = [float(tr.schedule(torch.tensor(c))) for c in range(1, 9)]
    anneals = [min(1.0, k / cfg.anneal_end) for k in range(1, 9)]
    assert len(set(lrs)) == 8 and len(set(anneals)) == 8
    h_first = []
    torch.cuda.synchronize()
    tc = time.perf_counter()
    tr.run(8, seed=seed, steps_per_call=8, history=h_first)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - tc
    first = _trainer_state(tr)
    g = tr._graph
    assert g is not None and g.generator is tr._gen
    # 8 eager steps from the same state, each timed, their draws kept
    _restore_trainer(tr, start)
    eager_s, eager_px, h_eager = [], [], []
    draw, train_step = tr.draw, tr.train_step

    def kept_draw(generator):
        d = draw(generator)
        eager_px.append(d.px.clone())
        return d

    def timed_step(d):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(d)
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t)
        return out

    tr.draw, tr.train_step = kept_draw, timed_step
    try:
        tr.run(8, seed=seed, steps_per_call=1, history=h_eager)
    finally:
        tr.draw, tr.train_step = draw, train_step
    eager = _trainer_state(tr)
    # the same 8 steps as 8 replays from the same state, each timed
    _restore_trainer(tr, start)
    replay_s, replay_px, h_replay = [], [], []
    real = g.graph

    class TimedReplay:
        def replay(self):
            torch.cuda.synchronize()
            t = time.perf_counter()
            real.replay()
            torch.cuda.synchronize()
            replay_s.append(time.perf_counter() - t)
            replay_px.append(g.draws.px.clone())

    g.graph = TimedReplay()
    kernels.reset_launch_counts()
    try:
        tr.run(8, seed=seed, steps_per_call=8, history=h_replay)
    finally:
        g.graph = real
    replay_wrapped = sum(kernels.launch_counts().values())
    replayed = _trainer_state(tr)
    assert tr._graph is g, "the second chunk captured again"
    bit_equal = _states_equal(eager, replayed) and _metrics_equal(h_eager, h_replay)
    first_equal = _states_equal(eager, first) and _metrics_equal(h_eager, h_first)
    draws_differ = all(not torch.equal(a, b) for a, b in zip(replay_px, replay_px[1:]))
    draws_eager = all(torch.equal(a, b) for a, b in zip(replay_px, eager_px))
    med_e, med_r = float(np.median(eager_s)), float(np.median(replay_s))
    log(f"phase 8h (a) stage-1 graph at {cfg.batch_size} rays (womask width), steps 1-8 at "
        f"learning rates {[f'{v:.3e}' for v in lrs]} and anneal {anneals}: 8 replays bit-equal "
        f"to 8 eager steps from the same state (parameters, Adam state, metrics): {bit_equal}; "
        f"the first chunk (eager warm-up, capture, 7 replays) too: {first_equal}; replays' draws "
        f"equal to the eager draws {draws_eager}, different from one replay to the next "
        f"{draws_differ}; wrapper launches in the 8 replays {replay_wrapped}; step median eager "
        f"{med_e * 1e3:.2f} ms, replayed {med_r * 1e3:.2f} ms (each synchronised), the first "
        f"chunk {first_s:.2f} s with its capture; card {card}")
    assert bit_equal and first_equal and draws_differ and draws_eager and replay_wrapped == 0
    assert all(np.isfinite(float(m["loss"])) for m in h_replay)
    rec["stage1"] = {"bit_equal_8_replays": bit_equal, "first_chunk_bit_equal": first_equal,
                     "draws_differ": draws_differ,
                     "eager_step_ms_median": med_e * 1e3, "replay_step_ms_median": med_r * 1e3,
                     "eager_step_ms": [v * 1e3 for v in eager_s],
                     "replay_step_ms": [v * 1e3 for v in replay_s],
                     "first_chunk_s": first_s, "lr": lrs, "anneal": anneals}

    # the 16-step chunk with the occupancy grid, against the eager loop under
    # JAX's chunk rule: the grid refreshed once, at the chunk's start
    cfg_o = dataclasses.replace(cfg, use_occupancy=True, occupancy_update_every=8)
    to = Stage1Trainer(cfg_o, ds, generator=gen(seed + 81), device=dev)
    to.run(1, seed=seed, steps_per_call=1)
    start_o = _trainer_state(to)
    refreshes = []
    update = to.update_occupancy
    to.update_occupancy = lambda: refreshes.append(to.step) or update()
    h_g = []
    torch.cuda.synchronize()
    tc = time.perf_counter()
    try:
        to.run(16, seed=seed, steps_per_call=16, history=h_g)
    finally:
        to.update_occupancy = update
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - tc
    graph_o = _trainer_state(to)
    _restore_trainer(to, start_o)
    to.update_occupancy()
    gen_o = to._generator(seed)
    h_e = [to.train_step(to.draw(gen_o)) for _ in range(16)]
    occ_equal = _states_equal(graph_o, _trainer_state(to)) and _metrics_equal(h_e, h_g)
    log(f"  16-step chunk with use_occupancy (occupancy_update_every 8; grid refreshed at steps "
        f"{refreshes}): bit-equal to the eager loop under the chunk rule {occ_equal}; the "
        f"chunk {chunk_s:.2f} s with its capture")
    assert occ_equal and refreshes == [1]
    rec["occupancy_chunk"] = {"bit_equal": occ_equal, "refreshed_at": refreshes,
                              "chunk_s": chunk_s}

    # upsample_pallas: K2 in the graph, four sweeps a step
    tu = Stage1Trainer(dataclasses.replace(cfg, upsample_pallas=True), ds,
                       generator=gen(seed + 82), device=dev)
    tu.run(1, seed=seed, steps_per_call=1)
    start_u = _trainer_state(tu)
    h_g = []
    tu.run(3, seed=seed, steps_per_call=3, history=h_g)
    graph_u = _trainer_state(tu)
    _restore_trainer(tu, start_u)
    h_e = []
    tu.run(3, seed=seed, steps_per_call=1, history=h_e)
    up_equal = _states_equal(graph_u, _trainer_state(tu)) and _metrics_equal(h_e, h_g)
    log(f"  3-step chunk with upsample_pallas: bit-equal to 3 eager steps {up_equal}")
    assert up_equal
    rec["upsample_pallas_chunk"] = {"bit_equal": up_equal}

    def trace_replays():
        """What a replay launches, from the device trace: 4 more replays of
        (a)'s graph, 2 of the upsample_pallas graph; no wrapper runs."""
        k3 = {"sdf_value_feat_grad": 1, "sdf_value_feat_grad_bwd": 1, "reduce_partials": 1}
        for key, t, n, want in (
                ("stage1", tr, 4, k3),
                ("upsample_pallas_chunk", tu, 2,
                 dict(k3, sdf_only_bf16=cfg.render.up_sample_steps))):
            graph = t._graph
            kernels.reset_launch_counts()
            traced = traced_launches(lambda: t.run(n, seed=seed, steps_per_call=n),
                                     kernels.KERNELS)
            assert t._graph is graph and sum(kernels.launch_counts().values()) == 0
            per = {k: v / n for k, v in traced.items() if v}
            log(f"phase 8h (a), traced at the script's end: {key}, kernels a replay in the "
                f"device trace of {n} replays {per}")
            assert per == want, (key, per)
            rec[key]["launches_a_replay"] = per

    DEFERRED_TRACES.append(trace_replays)
    rec["wall_s"]["a"] = time.perf_counter() - t0

    # (b) stage 2 in chunks of 4, the crops drawn on the device
    t0 = time.perf_counter()
    c2 = Stage2Config()
    t2 = Stage2Trainer(c2, data["images"], data["Ks"], data["W2Cs"], generator=gen(seed + 83),
                       device=dev)
    crops, per_step = [], []
    step2 = t2.train_step

    def counted_step2(idx, col, row, eik):
        crops.append((idx, col, row))
        before = kernels.launch_counts()
        out = step2(idx, col, row, eik)
        after = kernels.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        return out

    t2.train_step = counted_step2
    h2 = []
    try:
        m2 = t2.run(4, seed=seed, steps_per_call=4, history=h2)
    finally:
        t2.train_step = step2
    n_views, H, W = data["images"].shape[:3]
    ps = c2.patch_size
    in_bounds = all(0 <= i < n_views and 0 <= c < max(W - ps, 1) and 0 <= r < max(H - ps, 1)
                    for i, c, r in crops)
    log(f"phase 8h (b) Stage2Trainer.run(4, steps_per_call=4): crops {crops} (in JAX's bounds "
        f"{in_bounds}), launches a step {[{k: v for k, v in d.items() if v} for d in per_step]}, "
        f"losses {[round(float(h['loss']), 5) for h in h2]}, last metrics {m2}")
    step_launches = {"coarse_march": 2, "sdf_only_bf16": 2, "sdf_value_feat_grad": 3,
                     "sdf_value_feat_grad_bwd": 3, "sdf_only_3pass": 0, "sdf_full": 0}
    assert len(crops) == 4 and in_bounds and all(np.isfinite(v) for v in m2.values())
    for d in per_step:
        assert d == step_launches, d
    rec["stage2"] = {"crops": crops, "launches_a_step": per_step,
                     "losses": [float(h["loss"]) for h in h2]}
    rec["wall_s"]["b"] = time.perf_counter() - t0

    # (c) orbax: the JAX package's async saves, read by the port's own readers
    t0 = time.perf_counter()
    rec["orbax"] = orbax_check(dev)
    rec["wall_s"]["c"] = time.perf_counter() - t0

    # (d) the interpolation video of (a)'s trainer: 8 frames at level 4,
    # ping-pong, MPEG-4 Part 2 (mp4v) in an AVI
    t0 = time.perf_counter()
    rec["video"] = video_check(tr, kernels)
    rec["wall_s"]["d"] = time.perf_counter() - t0

    # (e) tp = 2 on two gloo ranks of the card against one device
    t0 = time.perf_counter()
    rec["tp"] = tp_check(args, dev, data)
    rec["wall_s"]["e"] = time.perf_counter() - t0
    rec["wall_s"]["phase"] = time.perf_counter() - t_phase
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in rec["wall_s"].items() if k != "phase")
    log(f"phase 8h: {rec['wall_s']['phase']:.1f} s ({parts})")
    return rec


# ---------------------------------------------------------------------------
# phase 8i: the image formats the JAX package reads through OpenCV
# ---------------------------------------------------------------------------

FORMAT_STEPS = 8     # phase 8i's stage-1 steps on the fixture scene


def _decode_fixture(root: str):
    """Every file of a fixture folder decoded by the port (decode_image,
    then read_image), each decode timed on the host, the decoded array's
    sha256 held equal to that of OpenCV's decode recorded beside it
    (opencv_sha256.json; a null entry, a file OpenCV reads no image from,
    is left to the caller) -> (decode ms by file, read_image arrays by
    file)."""
    import hashlib
    from iron_tpu_torch.data import io as tio
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        expected = json.load(f)
    decode_ms, decoded = {}, {}
    for key in sorted(k for k, v in expected.items() if v is not None):
        path = os.path.join(root, key)
        with open(path, "rb") as f:
            data = f.read()
        t = time.perf_counter()
        raw = np.ascontiguousarray(tio.decode_image(data, key))
        decode_ms[key] = (time.perf_counter() - t) * 1e3
        want = expected[key]
        got = {"shape": list(raw.shape), "dtype": str(raw.dtype),
               "sha256": hashlib.sha256(raw.tobytes()).hexdigest()}
        assert got == want, (key, got, want)
        decoded[key] = tio.read_image(path)
        assert decoded[key].shape == (256, 256, 3) and np.isfinite(decoded[key]).all()
    return decode_ms, decoded


def _refuse_and_skip(root: str, views: dict):
    """decode_image on each file of a fixture folder that OpenCV reads no
    image from (a null entry of its opencv_sha256.json) raises NoImage,
    timed on the host; then preprocess make-masks over a copy of refused/
    with the views beside it (`views`: a view's path in the fixture -> its
    name in the copy) -> (decode ms by refused file, the masks make-masks
    wrote)."""
    import shutil
    import tempfile
    from iron_tpu_torch.cli import preprocess
    from iron_tpu_torch.data import io as tio
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        refused = sorted(k for k, v in json.load(f).items() if v is None)
    assert len(refused) >= 10, refused
    refused_ms = {}
    for key in refused:
        with open(os.path.join(root, key), "rb") as f:
            data = f.read()
        t = time.perf_counter()
        try:
            tio.decode_image(data, key)
        except tio.NoImage:
            refused_ms[key] = (time.perf_counter() - t) * 1e3
        else:
            raise AssertionError(f"{key}: decoded, where OpenCV reads no image")
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        folder = os.path.join(tmp, "image")
        shutil.copytree(os.path.join(root, "refused"), folder)
        for src, name in views.items():
            shutil.copy(os.path.join(root, src), os.path.join(folder, name))
        preprocess.main(["make-masks", "--image_dir", folder])
        made = sorted(os.listdir(os.path.join(tmp, "masks")))
    return refused_ms, made


def _stage1_on_fixture(args, dev, card, kernels, root: str, names: list, seed: int,
                       steps: int, label: str) -> dict:
    """RayDataset.from_folder(root, mask_dir=root/mask) on the card (its
    files listed as `names`), then Stage1Trainer at Stage1Config()'s width
    (the learning-rate warm-up cut to 2 steps) for `steps` steps, one a
    call: K3-fwd and K3-bwd launched once a step and no other kernel, every
    loss finite, and the loss of one fixed batch of rays (its draws fixed)
    lower after the steps than before."""
    import torch
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.train.schedules import cos_anneal_ratio
    from iron_tpu_torch.train.stage1 import Stage1Config, Stage1Trainer, stage1_loss

    t = time.perf_counter()
    ds = RayDataset.from_folder(root, mask_dir=os.path.join(root, "mask"), device=dev)
    load_s = time.perf_counter() - t
    assert tuple(ds.images.shape) == (3, 256, 256, 3) and tuple(ds.masks.shape) == (3, 256, 256, 1)
    assert ds.images.device.type == dev.type and [os.path.basename(p) for p in ds.fpaths] == names

    cfg = dataclasses.replace(Stage1Config(), warm_up_end=2)
    tr = Stage1Trainer(cfg, ds, generator=torch.Generator(device=dev).manual_seed(seed),
                       device=dev)
    draws = tr.draw(torch.Generator(device=dev).manual_seed(seed + 1))
    batch = ds.gen_random_rays(draws.img_idx, cfg.batch_size, px=draws.px, py=draws.py)
    anneal = cos_anneal_ratio(1000, cfg.anneal_end)

    def fixed_loss() -> float:
        with torch.no_grad():
            return float(stage1_loss(tr.params, cfg, batch, anneal, t_rand=draws.t_rand,
                                     t_rand_outside=draws.t_rand_outside)[0])

    before = fixed_loss()
    step_ms, per_step, history = [], [], []
    train_step = tr.train_step

    def counted_step(d):
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(d)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        after = kernels.launch_counts()
        per_step.append({k: after[k] - counts[k] for k in after if after[k] != counts[k]})
        return out

    tr.train_step = counted_step
    kernels.reset_launch_counts()
    try:
        tr.run(num_iters=steps, seed=args.seed, history=history, steps_per_call=1)
        torch.cuda.synchronize()
    finally:
        tr.train_step = train_step
    launches = kernels.launch_counts()
    after = fixed_loss()
    losses = [float(h["loss"]) for h in history]
    log(f"phase {label} Stage1Trainer on the fixture, {len(losses)} steps: losses "
        f"{[round(v, 5) for v in losses]}; the fixed batch's loss {before:.5f} -> {after:.5f}; "
        f"launches a step {per_step[-1]}, in all {launches}; step ms "
        f"{[round(v, 2) for v in step_ms]}; card {card}")
    assert len(losses) == steps and all(np.isfinite(v) for v in losses)
    assert all(s == {"sdf_value_feat_grad": 1, "sdf_value_feat_grad_bwd": 1}
               for s in per_step), per_step
    assert launches["sdf_value_feat_grad"] == launches["sdf_value_feat_grad_bwd"] == steps
    assert after < before, (before, after)
    for p in tr.params.parameters():
        assert torch.isfinite(p).all()
    return {"dataset_load_s": load_s, "steps": steps, "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms)), "losses": losses,
            "fixed_batch_loss": [before, after],
            "launches": {k: v for k, v in launches.items() if v}}


def formats_phase(args, dev, card, kernels) -> dict:
    """Phase 8i, a stage-1 run from files that the JAX package reads through
    OpenCV and the port with its own decoders (this machine has neither
    OpenCV nor PIL): tests/data_formats/ (scripts/make_format_fixtures.py),
    three 256x256 views of one camera as an Adobe CMYK JPEG, a lossless JPEG
    and an arithmetic-coded progressive JPEG, their masks as an RLE8 BMP, a
    16-bit LZW TIFF and a binary PGM:

      (a) each file decoded by the port, its sha256 that of OpenCV's decode
          (_decode_fixture), the three masks equal, the lossy views within
          3/255 on average of the lossless one;
      (b), (c) RayDataset.from_folder(..., mask_dir=...) on the card and
          8 stage-1 steps at Stage1Config()'s width (_stage1_on_fixture)."""
    t0 = time.perf_counter()
    root = os.path.join(HERE, "tests", "data_formats")
    decode_ms, decoded = _decode_fixture(root)
    masks = [v for k, v in sorted(decoded.items()) if k.startswith("mask/")]
    views = {k: v for k, v in decoded.items() if k.startswith("image/")}
    assert all(np.array_equal(masks[0], m) for m in masks[1:])
    assert set(np.unique(masks[0]).tolist()) == {0.0, 1.0}
    lossless = views["image/view1.jpg"]
    lossy_err = {k: float(np.abs(v - lossless).mean() * 255) for k, v in views.items()
                 if k != "image/view1.jpg"}
    assert all(e <= 3.0 for e in lossy_err.values()), lossy_err
    log(f"phase 8i (a) decodes of tests/data_formats/ (host, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
        + f"; every array's sha256 is OpenCV's; the lossy views' mean |difference| from the "
        f"lossless one (of 255): {lossy_err}; card {card}")
    rec = {"card": card, "decode_ms": decode_ms, "lossy_mean_abs_err_255": lossy_err,
           **_stage1_on_fixture(args, dev, card, kernels, root,
                                ["view0.jpg", "view1.jpg", "view2.jpg"], args.seed + 9,
                                FORMAT_STEPS, "8i (c)"),
           "wall_s": time.perf_counter() - t0}
    log(f"phase 8i: {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8j: WebP and PAM, the formats of the port's tenth slice
# ---------------------------------------------------------------------------

WEBP_STEPS = 8       # phase 8j's stage-1 steps on the fixture scene


def webp_phase(args, dev, card, kernels) -> dict:
    """Phase 8j, a stage-1 run from WebP and PAM files, which the JAX package
    reads through OpenCV and the port with its own decoders (this machine
    has neither OpenCV nor PIL): tests/data_webp/
    (scripts/make_webp_fixtures.py), three 256x256 views of one camera named
    as the dataset lists them but WebP inside (view0.jpg lossy VP8,
    view1.png VP8X lossy with ALPH, view2.png lossless VP8L), their masks a
    lossless WebP, a P7 GRAYSCALE PAM and a lossy WebP:

      (a) each file decoded by the port, its sha256 that of OpenCV's decode
          (_decode_fixture), the lossless WebP mask equal to the PAM mask
          and binary, the lossy mask and the lossy views within 3/255 on
          average of their lossless counterparts;
      (b), (c) RayDataset.from_folder(..., mask_dir=...) on the card and
          8 stage-1 steps at Stage1Config()'s width (_stage1_on_fixture:
          K3-fwd and K3-bwd once a step, a falling loss on a fixed batch)."""
    t0 = time.perf_counter()
    root = os.path.join(HERE, "tests", "data_webp")
    decode_ms, decoded = _decode_fixture(root)
    exact = decoded["mask/view0.webp"]
    assert np.array_equal(exact, decoded["mask/view1.pam"])
    assert set(np.unique(exact).tolist()) == {0.0, 1.0}
    lossless = decoded["image/view2.png"]
    lossy_err = {k: float(np.abs(v - ref).mean() * 255) for k, v, ref in (
        ("image/view0.jpg", decoded["image/view0.jpg"], lossless),
        ("image/view1.png", decoded["image/view1.png"], lossless),
        ("mask/view2.webp", decoded["mask/view2.webp"], exact))}
    assert all(e <= 3.0 for e in lossy_err.values()), lossy_err
    log(f"phase 8j (a) decodes of tests/data_webp/ (host, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
        + f"; every array's sha256 is OpenCV's; the lossy files' mean |difference| from their "
        f"lossless counterparts (of 255): {lossy_err}; card {card}")
    rec = {"card": card, "decode_ms": decode_ms, "lossy_mean_abs_err_255": lossy_err,
           # phase 8i's initialisation and draws: the same scene, decoded from other files
           **_stage1_on_fixture(args, dev, card, kernels, root,
                                ["view0.jpg", "view1.png", "view2.png"], args.seed + 9,
                                WEBP_STEPS, "8j (c)"),
           "wall_s": time.perf_counter() - t0}
    log(f"phase 8j: {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8k: JPEG 2000, the format of the port's eleventh slice
# ---------------------------------------------------------------------------

JP2_STEPS = 8        # phase 8k's stage-1 steps on the fixture scene


def jp2_phase(args, dev, card, kernels) -> dict:
    """Phase 8k, a stage-1 run from JPEG 2000 files, which the JAX package
    reads through OpenCV (OpenJPEG) and the port with its own decoder (this
    machine has neither OpenCV, PIL nor glymur): tests/data_jp2/
    (scripts/make_jp2_fixtures.py), three 256x256 views of one camera named
    as the dataset lists them but JPEG 2000 inside (view0.jpg OpenCV's .jp2,
    reversible 5/3; view1.png a 5/3 RCT .jp2 in 128^2 tiles with 3 quality
    layers, lossless; view2.png a 9/7 ICT raw codestream cut at its rate),
    their masks an 8-bit lossless .jp2, a 16-bit lossless .j2k and an 8-bit
    lossy .jp2:

      (a) each file decoded by the port, its sha256 that of OpenCV's decode
          (_decode_fixture), the two lossless masks equal and binary, the
          lossy mask and the other views within 3/255 on average of their
          lossless counterparts;
      (b), (c) RayDataset.from_folder(..., mask_dir=...) on the card and
          8 stage-1 steps at Stage1Config()'s width (_stage1_on_fixture:
          K3-fwd and K3-bwd once a step, a falling loss on a fixed batch)."""
    t0 = time.perf_counter()
    root = os.path.join(HERE, "tests", "data_jp2")
    decode_ms, decoded = _decode_fixture(root)
    exact = decoded["mask/view0.jp2"]
    assert np.array_equal(exact, decoded["mask/view1.j2k"])
    assert set(np.unique(exact).tolist()) == {0.0, 1.0}
    lossless = decoded["image/view1.png"]
    lossy_err = {k: float(np.abs(v - ref).mean() * 255) for k, v, ref in (
        ("image/view0.jpg", decoded["image/view0.jpg"], lossless),
        ("image/view2.png", decoded["image/view2.png"], lossless),
        ("mask/view2.jp2", decoded["mask/view2.jp2"], exact))}
    assert all(e <= 3.0 for e in lossy_err.values()), lossy_err
    log(f"phase 8k (a) decodes of tests/data_jp2/ (host, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
        + f"; every array's sha256 is OpenCV's; the other files' mean |difference| from their "
        f"lossless counterparts (of 255): {lossy_err}; card {card}")
    rec = {"card": card, "decode_ms": decode_ms, "lossy_mean_abs_err_255": lossy_err,
           # phase 8i's initialisation and draws: the same scene, decoded from other files
           **_stage1_on_fixture(args, dev, card, kernels, root,
                                ["view0.jpg", "view1.png", "view2.png"], args.seed + 9,
                                JP2_STEPS, "8k (c)"),
           "wall_s": time.perf_counter() - t0}
    log(f"phase 8k: {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8l: TIFF as OpenCV's libtiff reads it, the port's twelfth slice
# ---------------------------------------------------------------------------

TIFF_STEPS = 8       # phase 8l's stage-1 steps on the fixture scene


def tiff_phase(args, dev, card, kernels) -> dict:
    """Phase 8l, a stage-1 run from TIFF files of the variants the port's
    twelfth slice reads, which the JAX package reads through OpenCV
    (libtiff) and the port with its own decoders (this machine has neither
    OpenCV nor PIL): tests/data_tiff/ (scripts/make_tiff_fixtures.py), three
    256x256 views of one camera named as the dataset lists them but TIFF
    inside (view0.jpg YCbCr JPEG-in-TIFF, 2x2 subsampling, in tiles with
    JPEGTables; view1.png a big-endian BigTIFF of float32 samples with the
    floating-point predictor; view2.png CMYK LZW), their masks Group 4,
    Group 3 2D with FillOrder 2 and float64:

      (a) each file decoded by the port, its sha256 that of OpenCV's decode
          (_decode_fixture), the three masks equal and binary, the float and
          CMYK views equal (both hold the PNG's values exactly), the JPEG
          view within 3/255 on average of them;
      (b), (c) RayDataset.from_folder(..., mask_dir=...) on the card and
          8 stage-1 steps at Stage1Config()'s width (_stage1_on_fixture:
          K3-fwd and K3-bwd once a step, a falling loss on a fixed batch)."""
    t0 = time.perf_counter()
    root = os.path.join(HERE, "tests", "data_tiff")
    decode_ms, decoded = _decode_fixture(root)
    masks = [v for k, v in sorted(decoded.items()) if k.startswith("mask/")]
    assert all(np.array_equal(masks[0], m) for m in masks[1:])
    assert set(np.unique(masks[0]).tolist()) == {0.0, 1.0}
    exact = decoded["image/view2.png"]
    assert np.array_equal(decoded["image/view1.png"], exact)
    lossy_err = {"image/view0.jpg": float(np.abs(decoded["image/view0.jpg"] - exact).mean()
                                          * 255)}
    assert all(e <= 3.0 for e in lossy_err.values()), lossy_err
    log(f"phase 8l (a) decodes of tests/data_tiff/ (host, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
        + f"; every array's sha256 is OpenCV's; the JPEG view's mean |difference| from the "
        f"exact ones (of 255): {lossy_err}; card {card}")
    rec = {"card": card, "decode_ms": decode_ms, "lossy_mean_abs_err_255": lossy_err,
           # phase 8i's initialisation and draws: the same scene, decoded from other files
           **_stage1_on_fixture(args, dev, card, kernels, root,
                                ["view0.jpg", "view1.png", "view2.png"], args.seed + 9,
                                TIFF_STEPS, "8l (c)"),
           "wall_s": time.perf_counter() - t0}
    log(f"phase 8l: {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8m: the image writers and preprocess, the port's thirteenth slice
# ---------------------------------------------------------------------------

WRITER_RES = 512     # phase 8m's render


def _sha_record(arr: np.ndarray) -> dict:
    """shape, dtype and sha256 of an array (as the fixtures record them)."""
    import hashlib
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def writers_phase(args, dev, card, kernels) -> dict:
    """Phase 8m, the port's writers and `preprocess` as the JAX package's
    cv2.imwrite / cv2.imread make them (this machine has no OpenCV):

      (a) `preprocess make-masks` then `apply-alpha` (the port's CLI) on a
          copy of tests/data_preprocess/image/ (gray + alpha, JPEG bytes,
          RGBA, RGBA16, palette + tRNS and gray files named .png, and one
          of no image format): every file and mask left is the JAX
          package's, by the decoded arrays' sha256 recorded beside the
          fixture (scripts/make_writer_fixtures.py), and the file of no
          image is skipped by both;
      (b) tests/data_writers/'s gray, RGB and RGBA images through
          write_image to every extension it takes: the bytes' sha256 that of
          the JAX package's file where the port writes OpenCV's bytes
          (.jpg, .bmp, .pam, .ras, .pfm, .hdr, PNM and their other names),
          the decoded array's that recorded (.png, .tif, .webp, .gif), and a
          ValueError and no file where OpenCV writes none it can read;
      (c) view 0 of phase 8's ring at 512^2 rendered on the card at the
          default width (K1, K2 and K3-fwd launched and counted), written
          to every extension but .jp2, which phase 8n writes (.pgm / .pbm
          its gray), each write and read
          (read_image) timed on the host: the lossless formats read back
          exactly, JPEG, Radiance and GIF within their bounds."""
    import hashlib
    import shutil
    import tempfile
    import torch
    from iron_tpu_torch.cli import preprocess
    from iron_tpu_torch.data import io as tio
    from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer

    t0 = time.perf_counter()
    rec = {"card": card}

    def decoded(path: str) -> dict:
        with open(path, "rb") as f:
            return _sha_record(tio.decode_image(f.read(), path))

    # (a) preprocess
    root = os.path.join(HERE, "tests", "data_preprocess")
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        want = json.load(f)
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        shutil.copytree(os.path.join(root, "image"), os.path.join(tmp, "image"))
        t = time.perf_counter()
        preprocess.main(["make-masks", "--image_dir", os.path.join(tmp, "image")])
        preprocess.main(["apply-alpha", "--image_dir", os.path.join(tmp, "image")])
        pre_s = time.perf_counter() - t
        left = sorted(f"{d}/{n}" for d in ("image", "masks")
                      for n in os.listdir(os.path.join(tmp, d)))
        assert left == sorted(want), (left, sorted(want))
        for key, w in sorted(want.items()):
            path = os.path.join(tmp, key)
            if w is None:
                try:
                    decoded(path)
                except tio.NoImage:
                    continue
                raise AssertionError(f"{key}: OpenCV reads no image from it; the port did")
            got = decoded(path)
            assert got == w, (key, got, w)
    rec["preprocess"] = {"files": len(want), "wall_s": pre_s}
    log(f"phase 8m (a) preprocess make-masks + apply-alpha on tests/data_preprocess/: "
        f"{len(want)} files and masks equal to the JAX package's, {pre_s * 1e3:.1f} ms; "
        f"card {card}")

    # (b) the fixture images through every writer
    root = os.path.join(HERE, "tests", "data_writers")
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        want = json.load(f)
    inputs = dict(np.load(os.path.join(root, "inputs.npz")))
    held = {"bytes": 0, "decoded": 0, "refused": 0}
    sizes = {}
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        for key, w in sorted(want.items()):
            name, ext = os.path.splitext(key)
            path = os.path.join(tmp, key)
            if "refused" in w:
                try:
                    tio.write_image(path, inputs[name])
                except ValueError:
                    assert not os.path.exists(path), key
                    held["refused"] += 1
                    continue
                raise AssertionError(f"{key}: OpenCV writes no readable file; the port did")
            tio.write_image(path, inputs[name])
            if "bytes" in w:
                with open(path, "rb") as f:
                    data = f.read()
                got = {"sha256": hashlib.sha256(data).hexdigest(), "size": len(data)}
                assert got == w["bytes"], (key, got, w["bytes"])
                held["bytes"] += 1
                continue
            got = decoded(path)
            assert got == w["decoded"], (key, got, w["decoded"])
            held["decoded"] += 1
            if ext in (".webp", ".gif"):
                sizes[key] = {"port": os.path.getsize(path), "opencv": w["opencv_size"]}
    assert sum(held.values()) == len(want)
    rec["fixture"] = {"held": held, "sizes_webp_gif": sizes}
    log(f"phase 8m (b) tests/data_writers/ through write_image: {held['bytes']} files "
        f"byte-equal to OpenCV's, {held['decoded']} decoding to the recorded arrays, "
        f"{held['refused']} refused as OpenCV refuses them; sizes (port, OpenCV) {sizes}")

    # (c) a render of the card through every writer
    cfg = Stage2Config()
    Ks, W2Cs = ring_cameras(1, WRITER_RES)
    images = np.zeros((1, WRITER_RES, WRITER_RES, 3), np.float32)
    tr = Stage2Trainer(cfg, images, Ks, W2Cs,
                       generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = tr.render_full(0, keys=("color", "hit_mask"))
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    launches = kernels.launch_counts()
    for name in ("coarse_march", "sdf_only_bf16", "sdf_value_feat_grad"):
        assert launches[name] > 0, launches
    color = out["color"]
    assert color.shape == (WRITER_RES, WRITER_RES, 3) and np.isfinite(color).all()
    assert 0 < out["hit_mask"].mean() < 1
    u8 = tio.to8b(color)
    gray = u8[..., 1]
    lossless = (".png", ".bmp", ".dib", ".tif", ".tiff", ".pbm", ".pgm", ".ppm", ".pnm", ".pam",
                ".ras", ".sr", ".pfm", ".webp")
    # the lossy ones' bounds on the mean |error| (of 255)
    bounds = {".jpg": 3.0, ".jpeg": 3.0, ".jpe": 3.0, ".hdr": 1.0, ".pic": 1.0, ".gif": 8.0}
    per_ext = {}
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        for ext in sorted(set(tio._WRITERS) - {".jp2"}):       # phase 8n writes .jp2
            img, ref = (color, u8) if ext not in (".pgm", ".pbm") else (gray, gray)
            if ext == ".pbm":
                ref = np.where(gray > 0, 255, 0).astype(np.uint8)
            path = os.path.join(tmp, "render" + ext)
            t = time.perf_counter()
            tio.write_image(path, img)
            w_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            back = tio.read_image(path)
            r_ms = (time.perf_counter() - t) * 1e3
            expect = np.repeat(ref[..., None], 3, -1) if ref.ndim == 2 else ref
            expect = expect.astype(np.float32)
            expect = expect / 255.0 if expect.max() > 1.5 else expect
            assert back.shape == expect.shape and np.isfinite(back).all(), (ext, back.shape)
            err = float(np.abs(back - expect).mean() * 255)
            if ext in lossless:
                assert np.array_equal(back, expect), (ext, err)
            else:
                assert err <= bounds[ext], (ext, err)
            per_ext[ext] = {"write_ms": w_ms, "read_ms": r_ms, "bytes": os.path.getsize(path),
                            "exact": bool(np.array_equal(back, expect)),
                            "mean_abs_err_255": err}
    rec["render"] = {"res": WRITER_RES, "render_s": render_s, "launches": launches,
                     "coverage": float(out["hit_mask"].mean()), "per_ext": per_ext}
    rec["launches"] = launches
    log(f"phase 8m (c) view 0 at {WRITER_RES}^2 on the card in {render_s:.2f} s (launches "
        f"{launches}), then write / read_image (host ms): "
        + ", ".join(f"{k} {v['write_ms']:.1f} / {v['read_ms']:.1f}" for k, v in per_ext.items()))
    rec["wall_s"] = time.perf_counter() - t0
    log(f"phase 8m: {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8n: the JPEG 2000 writer, the port's fourteenth slice
# ---------------------------------------------------------------------------

def writers2_phase(args, dev, card, kernels) -> dict:
    """Phase 8n, the port's .jp2 writer as the JAX package's cv2.imwrite
    writes it through OpenJPEG (this machine has no OpenCV):

      (a) every image of tests/data_jp2w/inputs.npz (the CPU tests'
          fixture: ramps, 12.png at 512^2 and a mask, which OpenCV's file
          decodes exactly; noise, textured crops and 64 x 48 images, where
          OpenCV's 4:1 rate cut binds) through write_image(".jp2"): the
          file's sha256 that of cv2.imencode recorded beside the fixture
          (scripts/make_jp2w_fixtures.py), and the port's decode_jp2 of it
          that of cv2.imdecode recorded there;
      (b) view 0 of phase 8's ring at 512^2 rendered on the card at the
          default width (K1, K2 and K3-fwd launched and counted), written
          with write_image(".jp2") and read back with read_image, each
          timed on the host: exact where the cut does not bind, else its
          PSNR."""
    import hashlib
    import tempfile
    import torch
    from iron_tpu_torch.data import io as tio
    from iron_tpu_torch.data.jp2 import decode_jp2
    from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer

    t0 = time.perf_counter()
    rec = {"card": card}

    # (a) the fixture images
    root = os.path.join(HERE, "tests", "data_jp2w")
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        want = json.load(f)
    inputs = dict(np.load(os.path.join(root, "inputs.npz")))
    held = {"required": 0, "cut": 0}
    write_ms = {}
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        for key, w in sorted(want.items()):
            img = inputs[key]
            if img.ndim == 3 and img.shape[2] == 4:
                img = img[..., [3, 0, 1, 2]]    # write_image stores RGBA as (G, B, A, R)
            path = os.path.join(tmp, key + ".jp2")
            t = time.perf_counter()
            tio.write_image(path, img)
            write_ms[key] = (time.perf_counter() - t) * 1e3
            with open(path, "rb") as f:
                data = f.read()
            got = {"sha256": hashlib.sha256(data).hexdigest(), "size": len(data)}
            assert got == w["bytes"], (key, got, w["bytes"])
            back = _sha_record(decode_jp2(data))
            assert back == w["decoded"], (key, back, w["decoded"])
            held[w["set"]] += 1
    assert sum(held.values()) == len(want)
    rec["fixture"] = {"held": held, "write_ms": write_ms}
    log(f"phase 8n (a) tests/data_jp2w/ through write_image('.jp2'): {held['required']} files "
        f"(uncut) and {held['cut']} (cut to 4:1) byte-equal to OpenCV's, each decoded by "
        f"decode_jp2 to OpenCV's recorded decode; host ms a write: "
        + ", ".join(f"{k} {v:.1f}" for k, v in write_ms.items()))

    # (b) a render of the card through the writer
    cfg = Stage2Config()
    Ks, W2Cs = ring_cameras(1, WRITER_RES)
    images = np.zeros((1, WRITER_RES, WRITER_RES, 3), np.float32)
    tr = Stage2Trainer(cfg, images, Ks, W2Cs,
                       generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = tr.render_full(0, keys=("color", "hit_mask"))
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    launches = kernels.launch_counts()
    for name in ("coarse_march", "sdf_only_bf16", "sdf_value_feat_grad"):
        assert launches[name] > 0, launches
    color = out["color"]
    assert color.shape == (WRITER_RES, WRITER_RES, 3) and np.isfinite(color).all()
    assert 0 < out["hit_mask"].mean() < 1
    u8 = tio.to8b(color)
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        path = os.path.join(tmp, "render.jp2")
        t = time.perf_counter()
        tio.write_image(path, color)
        w_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        back = tio.read_image(path)
        r_ms = (time.perf_counter() - t) * 1e3
        size = os.path.getsize(path)
    assert back.shape == u8.shape and np.isfinite(back).all()
    diff = back.astype(np.float64) * 255 - u8
    exact = bool(np.abs(diff).max() < 1e-3)
    psnr = None if exact else float(10 * np.log10(255.0 ** 2 / np.mean(diff ** 2)))
    assert exact or psnr > 25, psnr
    rec["render"] = {"res": WRITER_RES, "render_s": render_s, "launches": launches,
                     "coverage": float(out["hit_mask"].mean()), "bytes": size,
                     "raw_bytes": int(u8.size), "exact": exact, "psnr": psnr,
                     "write_ms": w_ms, "read_ms": r_ms}
    rec["launches"] = launches
    log(f"phase 8n (b) view 0 at {WRITER_RES}^2 on the card in {render_s:.2f} s (launches "
        f"{launches}), written as .jp2 in {size} bytes ({u8.size} raw): "
        + ("read back exactly" if exact else f"PSNR {psnr:.2f} dB (the 4:1 cut binds)")
        + f"; host write {w_ms:.1f} ms, read_image {r_ms:.1f} ms")
    rec["wall_s"] = time.perf_counter() - t0
    log(f"phase 8n: {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8o: damaged files as cv2.imread reads them, the port's fifteenth slice
# ---------------------------------------------------------------------------

DAMAGED_STEPS = 8    # phase 8o's stage-1 steps on the fixture scene


def damaged_phase(args, dev, card, kernels) -> dict:
    """Phase 8o, a stage-1 run from damaged JPEG views, which the JAX package
    reads through OpenCV (libjpeg-turbo's recovery) and the port with its
    own decoder (this machine has no OpenCV): tests/data_damaged/
    (scripts/make_damaged_fixtures.py), three 256x256 views of one camera
    (view0.jpg baseline, cut at 60 % of its scan; view1.jpg progressive, cut
    in its ninth scan; view2.jpg with a restart interval of 2, one corrupt
    interval and no EOI), intact PNG masks, and refused/, a damaged file of
    each other format that OpenCV reads no image from:

      (a) each view and mask decoded by the port, its sha256 that of
          OpenCV's decode (_decode_fixture);
      (b) decode_image raises NoImage on every refused file, and preprocess
          make-masks over a copy of refused/ with the three views beside
          them (named .png) writes the views' masks and no other;
      (c) RayDataset.from_folder(..., mask_dir=...) on the card: view0's
          cut tail (the rows libjpeg decodes from zero coefficients) at
          128/255 there, bit for bit the host's decode;
      (d) 8 stage-1 steps at Stage1Config()'s width (_stage1_on_fixture:
          K3-fwd and K3-bwd once a step, a falling loss on a fixed batch)."""
    import torch
    from iron_tpu_torch.data.dataset import RayDataset
    t0 = time.perf_counter()
    root = os.path.join(HERE, "tests", "data_damaged")
    decode_ms, decoded = _decode_fixture(root)
    refused_ms, made = _refuse_and_skip(root, {f"image/view{i}.jpg": f"view{i}.png"
                                               for i in range(3)})
    refused = list(refused_ms)
    assert made == ["view0.png", "view1.png", "view2.png"], made
    log(f"phase 8o (a) decodes of tests/data_damaged/ (host, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
        + f"; every array's sha256 is OpenCV's; (b) NoImage on all {len(refused)} refused "
        f"files (host, ms: " + ", ".join(f"{k} {v:.1f}" for k, v in refused_ms.items())
        + f"), make-masks skipped them and wrote {made}; card {card}")
    # (c) view0's tail from zero coefficients: gray 128 on the card too
    view0 = decoded["image/view0.jpg"]
    tail = np.where((view0 == np.float32(128 / 255)).all(axis=(1, 2)))[0]
    assert len(tail) >= 16 and tail[-1] == 255 and np.array_equal(tail, np.arange(tail[0], 256))
    ds = RayDataset.from_folder(root, mask_dir=os.path.join(root, "mask"), device=dev)
    assert ds.images.device.type == dev.type
    on_card = ds.images[0, int(tail[0]):]
    assert bool((on_card == 128 / 255).all())
    assert torch.equal(ds.images[0].cpu(), torch.from_numpy(view0))
    log(f"phase 8o (c) RayDataset.from_folder on the card: view0's rows {int(tail[0])}-255 "
        f"(after the cut) at 128/255, bit for bit the host's decode")
    rec = {"card": card, "decode_ms": decode_ms, "refused_ms": refused_ms,
           "refused": len(refused), "view0_tail_rows": [int(tail[0]), 255],
           **_stage1_on_fixture(args, dev, card, kernels, root,
                                ["view0.jpg", "view1.jpg", "view2.jpg"], args.seed + 9,
                                DAMAGED_STEPS, "8o (d)"),
           "wall_s": time.perf_counter() - t0}
    log(f"phase 8o: {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8p: the TIFF corners OpenCV reads and the plots, the port's sixteenth
# slice
# ---------------------------------------------------------------------------

TIFF_WIDE_STEPS = 8  # phase 8p's stage-1 steps on the fixture scene


def tiff_wide_phase(args, dev, card, kernels) -> dict:
    """Phase 8p, a stage-1 run from TIFF files of the corners the port's
    sixteenth slice reads, which the JAX package reads through OpenCV
    (libtiff) and the port with its own decoder (this machine has no
    OpenCV): tests/data_tiff_wide/ (scripts/make_tiff_wide_fixtures.py),
    three 256x256 views of one camera named as the dataset lists them
    (view0.jpg 12-bit RGB LZW in strips, view1.png big-endian 10-bit RGB
    Deflate in 64^2 tiles, view2.png LogLuv32), their masks 16-bit gray of
    3 samples, 14-bit gray PackBits and 12-bit gray with FillOrder 2:

      (a) each file decoded by the port, its sha256 that of OpenCV's decode
          (_decode_fixture); the masks' foregrounds equal, the views within
          1/255 of each other on average;
      (b), (c) RayDataset.from_folder(..., mask_dir=...) on the card and
          8 stage-1 steps at Stage1Config()'s width (_stage1_on_fixture:
          K3-fwd and K3-bwd once a step, a falling loss on a fixed batch);
      (d) plot_cameras of the fixture's camera and a ring of 8, and
          plot_fresnel_terms, drawn by the port without matplotlib, read
          back by the port's PNG decoder: 960 x 960 and 1200 x 480, mostly
          white, the frustums in tab10 red and the curves in the colour
          cycle's first three colours."""
    import tempfile
    from iron_tpu_torch.data import io as tio
    from iron_tpu_torch.utils import visualize as vis
    t0 = time.perf_counter()
    root = os.path.join(HERE, "tests", "data_tiff_wide")
    decode_ms, decoded = _decode_fixture(root)
    masks = [v[..., 0] > 0.5 for k, v in sorted(decoded.items()) if k.startswith("mask/")]
    assert all(np.array_equal(masks[0], m) for m in masks[1:]) and 0 < masks[0].mean() < 1
    views = [v for k, v in sorted(decoded.items()) if k.startswith("image/")]
    view_err = {f"view{i}": float(np.abs(views[i] - views[0]).mean() * 255) for i in (1, 2)}
    assert all(e <= 1.0 for e in view_err.values()), view_err
    log(f"phase 8p (a) decodes of tests/data_tiff_wide/ (host, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
        + f"; every array's sha256 is OpenCV's; the views' mean |difference| from view0 (of "
        f"255): {view_err}; card {card}")
    rec = {"card": card, "decode_ms": decode_ms, "view_mean_abs_err_255": view_err,
           # phase 8i's initialisation and draws: the same scene, decoded from other files
           **_stage1_on_fixture(args, dev, card, kernels, root,
                                ["view0.jpg", "view1.png", "view2.png"], args.seed + 9,
                                TIFF_WIDE_STEPS, "8p (c)")}
    # (d) the plots, on this machine without matplotlib
    with open(os.path.join(root, "cam_dict_norm.json")) as f:
        fixture_cams = json.load(f)
    Ks, W2Cs = ring_cameras(8, 256)
    ring = {f"{i}.png": {"K": np.asarray(Ks[i]).ravel().tolist(),
                         "W2C": np.asarray(W2Cs[i]).ravel().tolist(), "img_size": (256, 256)}
            for i in range(8)}
    plots = {}
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        for name, draw, shape in (
                ("cameras", lambda p: vis.plot_cameras({"train": fixture_cams, "test": ring}, p),
                 (960, 960, 3)),
                ("fresnel", vis.plot_fresnel_terms, (480, 1200, 3))):
            path = os.path.join(tmp, name + ".png")
            t = time.perf_counter()
            draw(path)
            write_ms = (time.perf_counter() - t) * 1e3
            with open(path, "rb") as f:
                data = f.read()
            img = tio.decode_image(data, path)
            assert img.shape == shape and img.dtype == np.uint8, (name, img.shape)
            white = float((img == 255).all(-1).mean())
            colours = (("tab:red", "tab:blue") if name == "cameras" else
                       ("tab:blue", "tab:orange", "tab:green"))
            shown = {c: int((img == vis.TAB10[c]).all(-1).sum()) for c in colours}
            assert white > 0.8 and all(n > 50 for n in shown.values()), (name, white, shown)
            plots[name] = {"shape": list(img.shape), "bytes": len(data), "write_ms": write_ms,
                           "white_share": white, "colour_pixels": shown}
    log(f"phase 8p (d) plots drawn without matplotlib and read back: "
        + ", ".join(f"{k} {v['shape']} {v['bytes']} bytes in {v['write_ms']:.1f} ms"
                    for k, v in plots.items()))
    rec["plots"] = plots
    rec["wall_s"] = time.perf_counter() - t0
    log(f"phase 8p: {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8q: damaged headers as cv2.imread reads them, the port's seventeenth
# slice
# ---------------------------------------------------------------------------

HEADER_STEPS = 8     # phase 8q's stage-1 steps on the fixture scene


def header_phase(args, dev, card, kernels) -> dict:
    """Phase 8q, a stage-1 run from files whose headers are damaged where
    OpenCV still reads them, which the JAX package reads through OpenCV and
    the port with its own decoders (this machine has no OpenCV):
    tests/data_header/ (scripts/make_header_fixtures.py), three 256x256
    views of one camera named as the dataset lists them (view0.png a JPEG
    whose JFIF segment is damaged, view1.png a lossless WebP whose VP8L
    chunk size is short, view2.png a Deflate TIFF of one strip whose byte
    count is 0), their masks a 1-bit TIFF whose one strip's byte count is
    short, a Group 3 TIFF whose last EOL is broken and a PNG, and refused/,
    a header-damaged file of each format that OpenCV reads no image from:

      (a) each view and mask decoded by the port, its sha256 that of
          OpenCV's decode (_decode_fixture);
      (b) decode_image raises NoImage on every refused file, and preprocess
          make-masks over a copy of refused/ with the three views beside
          them writes the views' masks and no other;
      (c) RayDataset.from_folder(..., mask_dir=...) on the card, its images
          and masks bit for bit the host's decodes;
      (d) 8 stage-1 steps at Stage1Config()'s width (_stage1_on_fixture:
          K3-fwd and K3-bwd once a step, a falling loss on a fixed batch)."""
    import torch
    from iron_tpu_torch.data.dataset import RayDataset
    t0 = time.perf_counter()
    root = os.path.join(HERE, "tests", "data_header")
    names = ["view0.png", "view1.png", "view2.png"]
    decode_ms, decoded = _decode_fixture(root)
    refused_ms, made = _refuse_and_skip(root, {f"image/{n}": n for n in names})
    refused = list(refused_ms)
    assert made == names, made
    log(f"phase 8q (a) decodes of tests/data_header/ (host, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
        + f"; every array's sha256 is OpenCV's; (b) NoImage on all {len(refused)} refused "
        f"files (host, ms: " + ", ".join(f"{k} {v:.1f}" for k, v in refused_ms.items())
        + f"), make-masks skipped them and wrote {made}; card {card}")
    # (c) the dataset on the card: the host's decodes, bit for bit
    ds = RayDataset.from_folder(root, mask_dir=os.path.join(root, "mask"), device=dev)
    assert ds.images.device.type == dev.type
    for i, name in enumerate(names):
        assert torch.equal(ds.images[i].cpu(), torch.from_numpy(decoded[f"image/{name}"]))
        assert torch.equal(ds.masks[i].cpu(),
                           torch.from_numpy(decoded[f"mask/{name}"][..., :1].copy()))
    log("phase 8q (c) RayDataset.from_folder on the card: the views and masks bit for bit "
        "the host's decodes")
    rec = {"card": card, "decode_ms": decode_ms, "refused_ms": refused_ms,
           "refused": len(refused),
           **_stage1_on_fixture(args, dev, card, kernels, root, names, args.seed + 9,
                                HEADER_STEPS, "8q (d)"),
           "wall_s": time.perf_counter() - t0}
    log(f"phase 8q: {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8r: the JPEG 2000 corners OpenCV reads, the port's eighteenth slice
# ---------------------------------------------------------------------------

JP2_CORNER_STEPS = 8     # phase 8r's stage-1 steps on the fixture scene


def jp2_corners_phase(args, dev, card, kernels) -> dict:
    """Phase 8r, a stage-1 run from JPEG 2000 files of the corners OpenCV
    reads, which the JAX package reads through OpenCV and the port with its
    own decoder (this machine has no OpenCV): tests/data_jp2_corners/
    (scripts/make_jp2_corner_fixtures.py, written by OpenJPEG), three
    256x256 views of one camera named as the dataset lists them (view0.png
    5/3 of code-block style 0x3F with a POC and tile-parts, view1.jpg 9/7
    with an RGN shift and its packet headers in PPM markers, view2.png in
    the sYCC colour space), their masks BYPASS + TERMALL, a palette
    ('pclr' + 'cmap') and packet headers in PPT markers:

      (a) each view and mask decoded by the port, its sha256 that of
          OpenCV's decode (_decode_fixture), the masks binary;
      (b) RayDataset.from_folder(..., mask_dir=...) on the card, its images
          and masks bit for bit the host's decodes;
      (c) 8 stage-1 steps at Stage1Config()'s width (_stage1_on_fixture:
          K3-fwd and K3-bwd once a step, a falling loss on a fixed batch)."""
    import torch
    from iron_tpu_torch.data.dataset import RayDataset
    t0 = time.perf_counter()
    root = os.path.join(HERE, "tests", "data_jp2_corners")
    names = ["view0.png", "view1.jpg", "view2.png"]
    decode_ms, decoded = _decode_fixture(root)
    assert len(decoded) == 6, sorted(decoded)
    for name in names:
        assert set(np.unique(decoded[f"mask/{name[:-4]}.png"]).tolist()) == {0.0, 1.0}
    log(f"phase 8r (a) decodes of tests/data_jp2_corners/ (host, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in decode_ms.items())
        + f"; every array's sha256 is OpenCV's; card {card}")
    ds = RayDataset.from_folder(root, mask_dir=os.path.join(root, "mask"), device=dev)
    assert ds.images.device.type == dev.type
    for i, name in enumerate(names):
        assert torch.equal(ds.images[i].cpu(), torch.from_numpy(decoded[f"image/{name}"]))
        assert torch.equal(ds.masks[i].cpu(), torch.from_numpy(
            decoded[f"mask/{name[:-4]}.png"][..., :1].copy()))
    log("phase 8r (b) RayDataset.from_folder on the card: the views and masks bit for bit "
        "the host's decodes")
    rec = {"card": card, "decode_ms": decode_ms,
           **_stage1_on_fixture(args, dev, card, kernels, root, names, args.seed + 10,
                                JP2_CORNER_STEPS, "8r (c)"),
           "wall_s": time.perf_counter() - t0}
    log(f"phase 8r: {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8s: the quality path (e2e validation, PSNR decomposition, relighting
# eval), the port's nineteenth slice
# ---------------------------------------------------------------------------

class _Tee:
    """A text stream that writes to stdout and keeps a copy."""

    def __init__(self):
        self.parts = []

    def write(self, s):
        self.parts.append(s)
        return sys.__stdout__.write(s)

    def flush(self):
        sys.__stdout__.flush()

    def text(self) -> str:
        return "".join(self.parts)


def _logged_losses(text: str, stage: str) -> list:
    """(step, loss) of every `[<stage> <step>] loss=...` line a trainer's run
    printed."""
    import re
    return [(int(m.group(1)), float(m.group(2)))
            for m in re.finditer(rf"^\[{stage} (\d+)\] loss=(\S+)", text, re.M)]


def _non_finite(tree, path="") -> list:
    """(path, value) of every number in a JSON tree that is not finite."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _non_finite(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _non_finite(v, f"{path}/{i}")]
    if isinstance(tree, (int, float)) and not isinstance(tree, bool) and \
            not np.isfinite(tree):
        return [(path, tree)]
    return []


def quality_phase(args, dev, card, kernels) -> dict:
    """Phase 8s, the port's quality path through its three entry points, in
    process on the card (each `main(argv)` as `python -m` runs it):

      (a) `iron_tpu_torch.eval.e2e_validation --fast --independent_gt
          --silhouette_weight 0.3` on the blobby scene (the independent
          renderer's 14 views at 64x64, 300 stage-1 steps in replayed chunks
          of 16, 150 stage-2 steps, the held-out views, the materials, the
          recovered mesh against the GT mesh);
      (b) `psnr_decomposition --scene blobby --res 64` on that run
          directory (D, B, A on the held-out views);
      (c) `relight_eval --scene blobby --res 64 --export_res 64` on it (the
          export, then the novel flash against the independent renderer).

    Holds: every number of the three reports finite (but the best step and
    its PSNR, null without a 5,000-step validation, as in the JAX script);
    the loss of each stage lower at its last logged step than at its first;
    K1, K2, K3-fwd and K3-bwd launched at least once over the three entry
    points by the wrappers' counters (stage 1's replays run no wrapper: its
    warm-up step and capture count).  Returns the {"quality"} line's record:
    the headline numbers of the three reports, the walls, the launches and
    the card."""
    import contextlib
    import tempfile
    import torch
    from iron_tpu_torch.eval import e2e_validation, psnr_decomposition, relight_eval

    t_phase = time.perf_counter()
    rec = {"card": card, "wall_s": {}, "launches": {}}
    reports, logs = {}, {}
    with tempfile.TemporaryDirectory(dir=HERE) as run_dir:
        calls = [("e2e", e2e_validation, ["--out_dir", run_dir, "--fast", "--independent_gt",
                                          "--silhouette_weight", "0.3", "--scene", "blobby"]),
                 ("decomposition", psnr_decomposition,
                  ["--run_dir", run_dir, "--scene", "blobby", "--res", "64"]),
                 ("relight", relight_eval, ["--run_dir", run_dir, "--scene", "blobby",
                                            "--res", "64", "--export_res", "64"])]
        for name, module, argv in calls:
            tee = _Tee()
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                reports[name] = module.main(argv + ["--device", "cuda"])
            torch.cuda.synchronize()
            rec["wall_s"][name] = time.perf_counter() - t
            rec["launches"][name] = kernels.launch_counts()
            logs[name] = tee.text()
            log(f"phase 8s ({name}) python -m {module.__name__} {' '.join(argv)}: "
                f"{rec['wall_s'][name]:.1f} s, launches {rec['launches'][name]}")
    e2e, dec, rel = reports["e2e"], reports["decomposition"], reports["relight"]
    for name, rep in reports.items():
        bad = _non_finite({k: v for k, v in rep.items()
                               if not (name == "e2e" and k in ("best_step", "best_heldout_psnr")
                                       and v is None)})
        assert not bad, (name, bad)
        assert rep["device"] == card, (name, rep["device"], card)
    assert e2e["best_step"] is None and e2e["best_heldout_psnr"] is None
    losses = {}
    for stage in ("stage1", "stage2"):
        logged = _logged_losses(logs["e2e"], stage)
        assert len(logged) == 10, (stage, logged)
        losses[stage] = logged
        assert logged[-1][1] < logged[0][1], (stage, logged)
    total = {k: sum(r[k] for r in rec["launches"].values()) for k in kernels.KERNELS}
    for k in ("coarse_march", "sdf_only_bf16", "sdf_value_feat_grad",
              "sdf_value_feat_grad_bwd"):
        assert total[k] >= 1, (k, rec["launches"])
    rec["launches"]["total"] = total
    rec["e2e"] = {k: e2e[k] for k in ("test_psnr", "test_ssim", "chamfer", "light")}
    rec["e2e"]["materials"] = {k: e2e["materials"][k] for k in (
        "light_diffuse_product_rel_err", "roughness_mean", "roughness_abs_err")}
    rec["e2e"]["stage1"] = {k: e2e["stage1"][k] for k in ("wall_s", "iters_per_s", "run_mode")}
    rec["e2e"]["stage2"] = {k: e2e["stage2"][k] for k in ("wall_s", "rays_per_s")}
    rec["e2e"]["total_wall_s"] = e2e["total_wall_s"]
    rec["decomposition"] = {k: dec["configs"][k]["psnr"] for k in ("D", "B", "A")}
    rec["decomposition"]["psnr_in_mask"] = {k: dec["configs"][k]["psnr_in_mask"]
                                            for k in ("D", "B", "A")}
    rec["relight"] = {"relight_psnr": rel["relight_psnr"], "per_view": rel["per_view"]}
    rec["losses_logged"] = losses
    rec["wall_s"]["phase"] = time.perf_counter() - t_phase
    log(f"phase 8s: PSNR {e2e['test_psnr']:.2f}, SSIM {e2e['test_ssim']:.4f}, chamfer "
        f"{e2e['chamfer']:.5f}; D / B / A {rec['decomposition']['D']:.2f} / "
        f"{rec['decomposition']['B']:.2f} / {rec['decomposition']['A']:.2f} dB; relight "
        f"{rel['relight_psnr']:.2f} dB; losses first -> last logged: stage 1 "
        f"{losses['stage1'][0][1]:.4f} -> {losses['stage1'][-1][1]:.4f}, stage 2 "
        f"{losses['stage2'][0][1]:.4f} -> {losses['stage2'][-1][1]:.4f}; launches {total}; "
        f"{rec['wall_s']['phase']:.1f} s; card {card}")
    return rec


# phase 8t's cuts of what the research scripts hard-wire: the regression
# fit's steps (4,000 in diag_torus_stage2), and the independent-GT torus of
# torus_resume_experiment (256x256 views with the GT mesh at 384, the
# chamfer's GT mesh at 256); the resume checkpoints every 10 steps (5,000)
SCRIPTS_FIT_STEPS = 1000
SCRIPTS_RESUME_RES, SCRIPTS_RESUME_MESH = 128, 192
SCRIPTS_RESUME_SAVE = 10


def scripts_phase(args, dev, card, kernels) -> dict:
    """Phase 8t, the JAX package's research scripts on the port, each
    module's entry point in process on the card at small sizes:

      (a) `singleview_demo --iters 64 --patch 64 --log_every 32` (the photo
          of tests/data_singleview/, full-width SDF, K3 in the loss);
      (b) `tracer_budget_coverage --res 64 128`;
      (c) `diag_torus_stage1 200 40`;
      (d) `diag_torus_stage2 40 2 64`, its regression fit cut to
          SCRIPTS_FIT_STEPS steps, its SDF saved into the phase's directory;
      (e) `silhouette_ab --res 64 --stage1_iters 200 --stage2_iters 40
          --ckpt_every 20`;
      (f) `torus_resume_experiment --arm clip --iters 20` from (e)'s last
          silhouette-arm checkpoint, on the independent GT torus at
          SCRIPTS_RESUME_RES^2 with its meshes at SCRIPTS_RESUME_MESH, a
          checkpoint every SCRIPTS_RESUME_SAVE steps.

    Holds: every number each returns finite and every record's device the
    card; the mosaics, checkpoints and report files written; the GT torus's
    SDF at the hole 0.24; every stage-2 run at its step count; K1, K2,
    K3-fwd and K3-bwd launched at least once over the phase by the
    wrappers' counters (stage 1's replays run no wrapper: its warm-up step
    and capture count).  Returns the {"scripts"} line's record: each
    module's headline numbers, wall and launches, and the cuts."""
    import tempfile
    import torch
    from iron_tpu_torch.fields.sdf import SDFConfig
    from iron_tpu_torch.scripts import (diag_torus_stage1, diag_torus_stage2, silhouette_ab,
                                        singleview_demo, torus_resume_experiment,
                                        tracer_budget_coverage)

    t_phase = time.perf_counter()
    rec = {"card": card, "wall_s": {}, "launches": {},
           "cuts": {"diag_torus_stage2_fit_steps": [SCRIPTS_FIT_STEPS, 4000],
                    "torus_resume_data": [[SCRIPTS_RESUME_RES, SCRIPTS_RESUME_MESH], [256, 384]],
                    "torus_resume_gt_mesh": [SCRIPTS_RESUME_MESH, 256],
                    "torus_resume_save_freq": [SCRIPTS_RESUME_SAVE, 5000]}}
    out = {}
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        sv_dir, ab_dir = os.path.join(tmp, "singleview"), os.path.join(tmp, "ab")
        resume_args = torus_resume_experiment.arg_parser().parse_args(
            ["--arm", "clip", "--iters", "20", "--out_dir", os.path.join(tmp, "resume"),
             "--from_ckpt", os.path.join(ab_dir, "stage2_silhouette", "ckpt_0000040.pkl"),
             "--device", "cuda"])
        calls = [
            ("singleview_demo", lambda: singleview_demo.main(
                ["--iters", "64", "--patch", "64", "--log_every", "32", "--out_dir", sv_dir,
                 "--device", "cuda"])),
            ("tracer_budget_coverage", lambda: tracer_budget_coverage.main(
                ["--res", "64", "128", "--device", "cuda"])),
            ("diag_torus_stage1", lambda: diag_torus_stage1.main(["200", "40", "--device",
                                                                  "cuda"])),
            ("diag_torus_stage2", lambda: diag_torus_stage2.run(
                40, 2, 64, dev, fit_steps=SCRIPTS_FIT_STEPS,
                sdf_path=os.path.join(tmp, "diag_torus_s2_sdf.npy"))),
            ("silhouette_ab", lambda: silhouette_ab.main(
                ["--out_dir", ab_dir, "--res", "64", "--stage1_iters", "200",
                 "--stage2_iters", "40", "--ckpt_every", "20", "--device", "cuda"])),
            ("torus_resume_experiment", lambda: torus_resume_experiment.run(
                resume_args, dataclasses.replace(
                    torus_resume_experiment.stage2_config("clip", resume_args.clip),
                    save_freq=SCRIPTS_RESUME_SAVE), dev,
                data=torus_resume_experiment.make_data(SCRIPTS_RESUME_RES,
                                                       SCRIPTS_RESUME_MESH),
                gt_mesh_resolution=SCRIPTS_RESUME_MESH)),
        ]
        for name, call in calls:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out[name] = call()
            torch.cuda.synchronize()
            rec["wall_s"][name] = time.perf_counter() - t
            rec["launches"][name] = kernels.launch_counts()
            log(f"phase 8t ({name}): {rec['wall_s'][name]:.1f} s, launches "
                f"{rec['launches'][name]}")
        assert sorted(os.listdir(sv_dir)) == ["ckpt_0000064.pkl", "logim_000032.png",
                                              "logim_000064.png"], os.listdir(sv_dir)
        assert os.path.exists(os.path.join(ab_dir, "report.json"))
        sdf_tree = np.load(os.path.join(tmp, "diag_torus_s2_sdf.npy"), allow_pickle=True).item()
        assert [sorted(l) for l in sdf_tree["layers"]] == \
            [["b", "g", "v"]] * (len(SDFConfig().dims) - 1), sdf_tree
    for name, r in out.items():
        bad = _non_finite(r)
        assert not bad, (name, bad)
    sv, cov, t1, t2, ab, rs = (out[n] for n, _ in calls)
    cards = ([sv["device"], t1["stage1"]["device"], t1["stage2"]["device"], ab["device"]]
             + [r["device"] for r in cov] + [r["device"] for r in t2["reports"]]
             + [r["device"] for r in t2["edge_coverage"]])
    assert set(cards) == {card}, set(cards)
    assert sv["iters"] == 64 and 0 <= sv["iou"] <= 1
    assert [r["res"] for r in cov] == [64, 128]
    assert all(0 < r["accurate_only"] <= 1 and 0 < r["coarse_to_fine"] <= 1 for r in cov)
    assert abs(t1["stage1"]["gt_sdf_at_hole"] - 0.24) < 1e-6, t1["stage1"]
    assert isinstance(t1["stage1"]["euler_gt"], int)
    assert [r["tag"] for r in t2["reports"]] == ["fitted_init", "after_20", "after_40"]
    assert [r["edge_coverage_at"] for r in t2["edge_coverage"]] == [256, 512]
    for arm in ("control", "silhouette"):
        assert list(ab["arms"][arm]["trajectory"]) == [20, 40], ab["arms"][arm]
        assert ab["arms"][arm]["rays_per_s"] > 0
    assert [r["ckpt"] for r in rs] == ["ckpt_0035010.pkl", "ckpt_0035020.pkl"], rs
    total = {k: sum(r[k] for r in rec["launches"].values()) for k in kernels.KERNELS}
    for k in ("coarse_march", "sdf_only_bf16", "sdf_value_feat_grad",
              "sdf_value_feat_grad_bwd"):
        assert total[k] >= 1, (k, rec["launches"])
    rec["launches"]["total"] = total
    rec["singleview_demo"] = sv
    rec["tracer_budget_coverage"] = cov
    rec["diag_torus_stage1"] = t1
    rec["diag_torus_stage2"] = {"fit": t2["fit"], "reports": t2["reports"],
                                "light": t2["light"], "edge_coverage": t2["edge_coverage"],
                                "stage2_wall_s": t2["stage2_wall_s"]}
    rec["silhouette_ab"] = {arm: ab["arms"][arm] for arm in ab["arms"]}
    rec["torus_resume_experiment"] = rs
    rec["wall_s"]["phase"] = time.perf_counter() - t_phase
    log(f"phase 8t: single-view IoU {sv['iou']:.4f} after 64 steps; coverage "
        + ", ".join(f"{r['res']}^2 {r['accurate_only']:.4f} / {r['coarse_to_fine']:.4f}"
                    for r in cov)
        + f"; torus stage 1 Euler {t1['stage1']['euler_largest']} (GT "
        f"{t1['stage1']['euler_gt']}), SDF at the hole {t1['stage1']['sdf_at_hole']:.4f}; "
        f"launches {total}; {rec['wall_s']['phase']:.1f} s; card {card}")
    return rec


def _leaves(tree) -> list:
    """The arrays of a nested dict / list tree, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512, help="render resolution (square)")
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=30,
                    help="timed training steps after the 8 warm-up steps (at least 10)")
    ap.add_argument("--no-timing", action="store_true", help="skip phase 9")
    ap.add_argument("--dp-worker", type=int, default=None, metavar="RANK",
                    help="run one rank of phase 8g's gloo group (started by the phase)")
    ap.add_argument("--dp-store", default=None, help="phase 8g's directory for its ranks")
    ap.add_argument("--only-8h", action="store_true",
                    help="build, then run phase 8h alone on phase 8's data (a shorter "
                         "compile-and-check call; prints no result line)")
    ap.add_argument("--only-8i", action="store_true",
                    help="build, then run phase 8i alone (the image formats; prints no "
                         "result line)")
    ap.add_argument("--only-8j", action="store_true",
                    help="build, then run phase 8j alone (WebP and PAM; prints no result "
                         "line)")
    ap.add_argument("--only-8k", action="store_true",
                    help="build, then run phase 8k alone (JPEG 2000; prints no result line)")
    ap.add_argument("--only-8l", action="store_true",
                    help="build, then run phase 8l alone (TIFF; prints no result line)")
    ap.add_argument("--only-8m", action="store_true",
                    help="build, then run phase 8m alone (the writers and preprocess; prints "
                         "no result line)")
    ap.add_argument("--only-8n", action="store_true",
                    help="build, then run phase 8n alone (the .jp2 writer; prints no result "
                         "line)")
    ap.add_argument("--only-8o", action="store_true",
                    help="build, then run phase 8o alone (damaged files; prints no result "
                         "line)")
    ap.add_argument("--only-8p", action="store_true",
                    help="build, then run phase 8p alone (the TIFF corners and the plots; "
                         "prints no result line)")
    ap.add_argument("--only-8q", action="store_true",
                    help="build, then run phase 8q alone (damaged headers; prints no result "
                         "line)")
    ap.add_argument("--only-8r", action="store_true",
                    help="build, then run phase 8r alone (the JPEG 2000 corners; prints no "
                         "result line)")
    ap.add_argument("--only-8s", action="store_true",
                    help="build, then run phase 8s alone (the quality path; prints no "
                         "result line)")
    ap.add_argument("--only-8t", action="store_true",
                    help="build, then run phase 8t alone (the research scripts; prints no "
                         "result line)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "iron_tpu_torch", "kernels", "csrc")):
        print("chip_smoke.py needs the repository beside it (iron_tpu_torch/ not found)",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible: chip_smoke.py runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.dp_worker is not None:
        return dp_worker(args)

    from iron_tpu_torch import kernels, resolve_device
    from iron_tpu_torch.core.rays import intersect_sphere
    from iron_tpu_torch.fields.sdf import sdf_apply, sdf_only
    from iron_tpu_torch.kernels import build
    from iron_tpu_torch.kernels import fused_sdf as K12
    from iron_tpu_torch.kernels import fused_sdf_grad as K3
    from iron_tpu_torch.surface.render import (render_camera, scale_config_for_resolution,
                                               shade_masked)
    from iron_tpu_torch.surface.tracer import TracerConfig, raytrace
    from iron_tpu_torch.core.camera import make_camera
    from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer, build_stage2_fns

    dev = resolve_device("cuda")
    rng = np.random.default_rng(args.seed)
    tc = TracerConfig()
    thr = tc.coarse_threshold

    # ---- 1. the card ----
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    for line in build.ptxas_reports():
        log(f"  ptxas {line}")

    if args.only_8i:
        log(json.dumps({"formats": formats_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8j:
        log(json.dumps({"webp": webp_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8k:
        log(json.dumps({"jp2": jp2_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8l:
        log(json.dumps({"tiff": tiff_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8m:
        log(json.dumps({"writers": writers_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8n:
        log(json.dumps({"writers2": writers2_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8o:
        log(json.dumps({"damaged": damaged_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8p:
        log(json.dumps({"tiff_wide": tiff_wide_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8q:
        log(json.dumps({"header": header_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8r:
        log(json.dumps({"jp2_corners": jp2_corners_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8s:
        log(json.dumps({"quality": quality_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8t:
        log(json.dumps({"scripts": scripts_phase(args, dev, card, kernels)}))
        return 0

    if args.only_8h:
        from iron_tpu_torch.data.synthetic import render_synthetic_dataset
        data = render_synthetic_dataset("sphere", n_views=4, H=256, W=256, light=30.0, device=dev)
        graph = graph_phase(args, dev, card, data, kernels)
        run_deferred_traces()
        log(json.dumps({"graph": graph}))
        return 0

    cfg = Stage2Config()
    Ks, W2Cs = ring_cameras(args.views, args.res)
    images = np.zeros((args.views, args.res, args.res, 3), np.float32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    trainer = Stage2Trainer(cfg, images, Ks, W2Cs, generator=gen, device=dev)
    net = trainer.params["sdf"]
    w12 = K12.prepare_bf16_weights(net)
    w3 = K3.prepare_grad_weights(net)
    w4 = K12.prepare_3pass_weights(net)
    max_err = {}
    log(f"K1 grid: the card holds {K12._lib().iron_coarse_march_ctas()} CTAs of the march "
        f"kernel at once")

    def check_k2(pts, what: str, sdf_net=None) -> None:
        """K2 against its plain version and the f32 SDF, on the weights of
        sdf_net (default the render's)."""
        sdf_net = net if sdf_net is None else sdf_net
        w = w12 if sdf_net is net else K12.prepare_bf16_weights(sdf_net)
        with torch.no_grad():
            k2 = K12.sdf_only_bf16(w, pts)
            torch.cuda.synchronize()
            k2_plain = K12.sdf_only_bf16_plain(w, pts)
            f32 = sdf_only(sdf_net, pts)
        assert k2.shape == pts.shape[:-1] and torch.isfinite(k2).all()
        err = float((k2 - k2_plain).abs().max())
        err_f32 = float((k2 - f32).abs().max())
        log(f"K2 sdf_only_bf16 {what} {tuple(pts.shape)}: max|K2 - plain| {err:.3e} (tol 5e-3), "
            f"max|K2 - f32 sdf| {err_f32:.3e} (tol 1.2e-2, the bf16 coarse budget)")
        assert err <= BF16_REORDER_TOL and err_f32 <= 1.2e-2
        max_err["sdf_only_bf16"] = max(max_err.get("sdf_only_bf16", 0.0), err)

    def check_k3(x, what: str, w=None) -> None:
        """K3-fwd against its plain version (weights w, default the
        render's)."""
        w = w3 if w is None else w
        with torch.no_grad():
            got = K3.sdf_value_feat_grad(w, x)
            torch.cuda.synchronize()
            ref = K3.sdf_value_feat_grad_plain(w, x)
        errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        scale = [float(b.abs().max()) for b in ref]
        log(f"K3 sdf_value_feat_grad {what} {tuple(x.shape)}: max err value {errs[0]:.3e} "
            f"feature {errs[1]:.3e} grad {errs[2]:.3e} (magnitudes {scale[0]:.2f}, "
            f"{scale[1]:.2f}, {scale[2]:.2f}; tol 1e-5 + 1e-5 relative: 3xTF32 products and "
            f"f32 sums in another order)")
        for a, e, s in zip(got, errs, scale):
            assert torch.isfinite(a).all() and e <= 1e-5 + 1e-5 * s
        max_err["sdf_value_feat_grad"] = max(max_err.get("sdf_value_feat_grad", 0.0), *errs)

    def k1_sdf(w, ro, rd, dist, md):
        """|sdf| at ro + rd * dist under K1's own arithmetic: a K1 launch
        with n_iters = 0 evaluates every ray once at its acc0."""
        if ro.shape[0] == 0:
            return ro.new_zeros(0)
        ones = torch.ones(ro.shape[0], dtype=torch.bool, device=ro.device)
        return K12.coarse_march(w, ro, rd, dist, ones, md, 0, thr)[2].abs()

    def check_k1(margs, what: str, w=None) -> None:
        """K1 against its plain version on one march (weights w, default the
        render's).  A ray may stop up to
        one coarse step (< 2e-2) apart.  A ray that passes the surface with
        |sdf| near the 2e-2 threshold (a graze) stops there in one version
        and marches on in the other when the two sum orders round an
        activation apart, so its distances can differ by much more.  Held:
        the active masks agree on 99.9% of the rays, and of the rays further
        apart than 3e-2, every one whose earlier stop lies inside the sphere
        has |sdf| <= threshold + 5e-3 (the bf16 reordering error) there
        under both evaluators, K1's own arithmetic (a K1 launch with n_iters
        = 0 at that distance) and its plain version: it is a graze within
        the evaluators' error of the threshold.  The others left the sphere
        in both versions or are still marching in both (the same outcome,
        at other distances).  Prints the march's schedule: rays, marching
        rays, evaluations, the slowest ray's iterations, and 64-ray
        tile-evaluations, compacted (K1) and one block a tile to its slowest
        ray (the design before)."""
        w = w12 if w is None else w
        ro, rd, acc0, work, max_dis, n_it = margs
        with torch.no_grad():
            a_k, acc_k, _ = K12.coarse_march(w, *margs, thr)
            torch.cuda.synchronize()
            a_p, acc_p, _ = K12.coarse_march_plain(w, *margs, thr)
            *_, st = K12.coarse_march_schedule(w, *margs, thr)
            wk = work.reshape(-1)
            md = torch.broadcast_to(max_dis, work.shape).reshape(-1)
            a_k, a_p = a_k.reshape(-1), a_p.reshape(-1)
            acc_k, acc_p = acc_k.reshape(-1), acc_p.reshape(-1)
            d = (acc_k - acc_p).abs()
            err = float(d[wk].max()) if bool(wk.any()) else 0.0
            agree = float((a_k == a_p).float().mean())
            apart = wk & (d > 3e-2)
            early = torch.minimum(acc_k, acc_p)
            early_stopped = torch.where(acc_k <= acc_p, ~a_k, ~a_p)
            graze = apart & (early < md) & early_stopped
            ro_g, rd_g = ro.reshape(-1, 3)[graze], rd.reshape(-1, 3)[graze]
            s_k = k1_sdf(w, ro_g, rd_g, early[graze], md[graze])
            p = ro_g + rd_g * early[graze][:, None]
            s_p = K12.sdf_only_bf16_plain(w, p).abs()
        n_apart, n_graze = int(apart.sum()), int(graze.sum())
        n_left = int((apart & (early >= md)).sum())
        top = lambda t: float(t.max()) if t.numel() else 0.0
        log(f"K1 coarse_march {what}: {st['rays']} rays, {st['marching']} marching, "
            f"{st['evaluations']} evaluations, slowest ray {st['iterations']} iterations (of "
            f"{n_it}), tile-evaluations {st['tile_evals']} compacted, {st['tile_evals_blocks']} "
            f"one block a tile; active rays by iteration {[p_[0] for p_ in st['per_iteration']]}")
        log(f"  max|acc K1 - plain| {err:.3e}, active masks agree {agree:.6f} (tol >= "
            f"0.999); rays apart by > 3e-2: {n_apart} ({n_apart / max(int(wk.sum()), 1):.2e} "
            f"of the marching), {n_graze} of them stopped inside the sphere first; at that "
            f"stop max |sdf| K1 {top(s_k):.3e}, plain {top(s_p):.3e} (tol "
            f"{thr + BF16_REORDER_TOL:.3e}), min plain {float(s_p.min()) if n_graze else 0.0:.3e}"
            f"; of the others {n_left} left the sphere in both, "
            f"{n_apart - n_graze - n_left} are still marching in both")
        assert agree >= 0.999
        assert top(s_k) <= thr + BF16_REORDER_TOL and top(s_p) <= thr + BF16_REORDER_TOL
        max_err["coarse_march"] = max(max_err.get("coarse_march", 0.0), err)
        return st

    def k4_err(pts, w4_=None) -> float:
        """max |K4 - its plain version| on pts (held at K4_PLAIN_TOL), with
        the weights w4_ (default: the render's)."""
        w4_ = w4 if w4_ is None else w4_
        with torch.no_grad():
            k4 = K12.sdf_only_3pass(w4_, pts)
            torch.cuda.synchronize()
            ref = K12.sdf_only_3pass_plain(w4_, pts)
        assert k4.shape == pts.shape[:-1] and torch.isfinite(k4).all()
        err = float((k4 - ref).abs().max()) if k4.numel() else 0.0
        assert err <= K4_PLAIN_TOL, err
        max_err["sdf_only_3pass"] = max(max_err.get("sdf_only_3pass", 0.0), err)
        return err

    def check_k4(pts, what: str, sdf_net=None) -> None:
        """K4 against its plain version, and the JAX package's criteria for
        the 3-pass kernel against the f32 SDF (tests/test_kernels.py):
        within 5e-4, and under 0.3 x K2's error on the same points (on the
        weights of sdf_net, default the render's)."""
        if sdf_net is None:
            sdf_net, w4_, w12_ = net, w4, w12
        else:
            w4_, w12_ = K12.prepare_3pass_weights(sdf_net), K12.prepare_bf16_weights(sdf_net)
        err = k4_err(pts, w4_)
        with torch.no_grad():
            k4 = K12.sdf_only_3pass(w4_, pts)
            f32 = sdf_only(sdf_net, pts)
            e4 = float((k4 - f32).abs().max())
            e2 = float((K12.sdf_only_bf16(w12_, pts) - f32).abs().max())
        log(f"K4 sdf_only_3pass {what} {tuple(pts.shape)}: max|K4 - plain| {err:.3e} (tol "
            f"{K4_PLAIN_TOL:.0e}); max|K4 - f32 sdf| {e4:.3e} (tol 5e-4), max|K2 - f32 sdf| "
            f"{e2:.3e}, ratio {e4 / e2:.4f} (tol < 0.3)")
        assert e4 <= 5e-4 and e4 < 0.3 * e2

    def check_k5(x, what: str) -> None:
        """K5 against its plain version (max abs within K5_TOL) and against
        the f32 sdf_apply through cuBLAS (atol K5_TOL, rtol 1e-5)."""
        with torch.no_grad():
            got = K3.sdf_full(w3, x)
            torch.cuda.synchronize()
            ref = K3.sdf_full_plain(w3, x)
            f32 = sdf_apply(net, x)
        assert got.shape == x.shape[:-1] + (cfg.sdf.d_out,) and torch.isfinite(got).all()
        err = float((got - ref).abs().max())
        err_f32 = float((got - f32).abs().max())
        log(f"K5 sdf_full {what} {tuple(x.shape)}: max|K5 - plain| {err:.3e} (tol "
            f"{K5_TOL:.0e}; 3xTF32 products and f32 sums in another order), max|K5 - f32 "
            f"sdf_apply| {err_f32:.3e} (tol {K5_TOL:.0e} + 1e-5 relative; magnitude "
            f"{float(f32.abs().max()):.2f})")
        assert err <= K5_TOL and torch.allclose(got, f32, atol=K5_TOL, rtol=1e-5)
        max_err["sdf_full"] = max(max_err.get("sdf_full", 0.0), err)

    # ---- 3. K2 against its plain bf16 version and the f32 SDF: the fallback
    # sweep's shape, 1024 rays x 128 samples ----
    ro, rd = rays_at_targets(rng, 1024, 3.0, 0.3)
    ro_t, rd_t = torch.as_tensor(ro, device=dev), torch.as_tensor(rd, device=dev)
    _, near, far = intersect_sphere(ro_t, rd_t)
    t = torch.linspace(0, 1, 128, device=dev)
    pts = ro_t[:, None] + rd_t[:, None] * (near[:, None] + t * (far - near)[:, None])[..., None]
    with torch.no_grad():
        check_k2(pts, "on random rays")

    # ---- 4. K3-fwd against its plain f32 version, 65,536 points ----
    x3 = torch.as_tensor((rng.uniform(-1, 1, size=(65536, 3)) * 0.6).astype(np.float32),
                         device=dev)
    check_k3(x3, "on random points")

    # ---- 4b. K4 and K5 on 262,144 points uniform in the cube ----
    x_u = torch.as_tensor(np.random.default_rng(args.seed + 7).uniform(-1, 1, size=(262144, 3))
                          .astype(np.float32), device=dev)
    check_k4(x_u, "on uniform points")
    check_k5(x_u, "on uniform points")

    # ---- 5. K1 inside raytrace against the accurate-only raytrace ----
    ro5, rd5 = rays_at_targets(rng, 512, 2.5, 0.2)
    ro5, rd5 = torch.as_tensor(ro5, device=dev), torch.as_tensor(rd5, device=dev)
    mn = torch.full((512,), 0.5, device=dev)
    mx = torch.full((512,), 4.5, device=dev)
    wk = torch.ones(512, dtype=torch.bool, device=dev)
    sdf_fn = lambda p: sdf_only(net, p)
    march = lambda *a: K12.coarse_march(w12, *a, threshold=thr)
    with torch.no_grad():
        ref = raytrace(sdf_fn, ro5, rd5, mn, mx, wk, tc)
        got = raytrace(sdf_fn, ro5, rd5, mn, mx, wk, tc, coarse_march_fn=march,
                       coarse_sdf_fn=lambda p: K12.sdf_only_bf16(w12, p))
        conv_r, conv_g = ref["convergent_mask"], got["convergent_mask"]
        d_err = float((got["distance"] - ref["distance"])[conv_r & conv_g].abs().max())
        root = float(sdf_fn(got["points"])[conv_g].abs().max())
        # A ray may differ only where the JAX package documents that the
        # coarse tracer may differ: its accurate SDF dips below zero by less
        # than the bf16 coarse error (1.2e-2), so the coarse sweep can miss
        # the crossing (or see one the accurate sweep misses).
        diff = torch.nonzero(conv_r != conv_g)[:, 0]
        zs = torch.linspace(0.5, 4.5, 4096, device=dev)
        dips = [float(sdf_fn(ro5[i] + rd5[i] * zs[:, None]).min()) for i in diff.tolist()]
    log(f"K1 in raytrace (512 rays): convergent {int(conv_g.sum())} vs accurate-only "
        f"{int(conv_r.sum())}, differing rays {len(dips)} with along-ray SDF minima "
        f"{[f'{d:.2e}' for d in dips]} (allowed: shallow dips above -1.2e-2, at most 1%), "
        f"max distance err {d_err:.3e} (tol 2e-3), max |f| at roots {root:.3e} "
        f"(tol {tc.sdf_threshold * 1.01:.3e})")
    assert int(conv_r.sum()) > 50 and len(dips) <= 5 and all(-1.2e-2 < d < 0 for d in dips)
    assert d_err <= 2e-3 and root <= tc.sdf_threshold * 1.01

    # ---- 6. the render path: render_full of every view at full width ----
    calls_of_render = ("coarse_march", "sdf_only_bf16", "sdf_value_feat_grad")
    kernels.reset_launch_counts()
    render_s = []
    outs = []
    for i in range(args.views):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(trainer.render_full(i))
        render_s.append(time.perf_counter() - t0)
    render_launches = kernels.launch_counts()
    log(f"render_full x{args.views} at {args.res}x{args.res}: "
        + ", ".join(f"{s:.2f} s" for s in render_s) + f"; launches {render_launches}")
    assert all(render_launches[k] > 0 for k in calls_of_render), render_launches
    assert all(render_launches[k] == 0 for k in render_launches if k not in calls_of_render), \
        render_launches
    for i, o in enumerate(outs):
        for k in ("color", "normal", "depth"):
            assert np.isfinite(o[k]).all(), (i, k)
        cov = float(o["hit_mask"].mean())
        log(f"  view {i}: coverage {cov:.4f}, edge pixels {int(o['edge_mask'].sum())}, "
            f"mean colour {float(o['color'][o['hit_mask']].mean()):.4f}")
        # Non-zero, not full: at 512x512 the coarse-to-fine tracer leaves more
        # unfinished rays than its fallback budget (1024) can take, in the
        # JAX package as in the port (ROADMAP "Faults found"), so coverage
        # is a fraction of the f32-only trace's.
        assert cov > 0 and o["color"].shape == (args.res, args.res, 3)

    def view0(res: int):
        cam = make_camera(Ks[0] * np.array([[res / args.res], [res / args.res], [1], [1]],
                                           np.float32), W2Cs[0], res, res, device=dev)
        return cam, scale_config_for_resolution(cfg.surface, res, res, cfg.patch_size)

    def render_view0(res: int, fns: dict, sdf_all_fn=None, coarse_sdf_fn=None,
                     coarse_march_fn=None, trace_sdf_fn=None) -> dict:
        cam, surf = view0(res)
        with torch.no_grad():
            out = render_camera(fns["sdf_fn"], sdf_all_fn or fns["sdf_all_fn"], fns["shade_fn"],
                                cam, surf, trace_sdf_fn=trace_sdf_fn or fns["trace_sdf_fn"],
                                trace_sdf_all_fn=fns["trace_sdf_all_fn"],
                                coarse_sdf_fn=coarse_sdf_fn or fns["coarse_sdf_fn"],
                                coarse_march_fn=coarse_march_fn or fns["coarse_march_fn"])
        return {k: v.cpu().numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}

    def compare_with_plain(res: int, out=None):
        """View 0 at `res` through the kernels (or `out`, that render) and
        through the plain versions of the three kernels, on the card.

        The two renders' roots agree to the tracer's 5e-5 threshold, not bit
        for bit (the bf16 march takes other steps).  So an unfinished ray can
        fall on either side of the tracer's 1024-ray budget (each ray whose
        state differs moves at most one ray across it), or be traced in one
        render and hole-filled in the other, and a pixel whose depth Sobel
        sits at the 1e-2 seed threshold can seed the edge walk in one render
        only.  Held: hit and edge masks differ on at most 1% of the pixels
        hit (or edge) in either render; re-shading the kernels' own interior
        points through the plain K3 gives their colour and gradient within
        1e-4, so every larger colour difference comes from the roots; at most
        0.5% of interior pixels have depths more than 1e-4 apart (two roots),
        and at most 0.5% differ in colour by more than 1e-3."""
        fns = build_stage2_fns(trainer.params, trainer.mat_cfgs, cfg)
        plain_all = lambda p: K3.sdf_value_feat_grad_plain(w3, p)
        if out is None:
            out = render_view0(res, fns)
        plain = render_view0(
            res, fns, sdf_all_fn=plain_all,
            coarse_sdf_fn=lambda p: K12.sdf_only_bf16_plain(w12, p),
            coarse_march_fn=lambda *a: K12.coarse_march_plain(w12, *a, thr))
        o = out
        T = lambda a: torch.as_tensor(a, device=dev)
        with torch.no_grad():
            resh = shade_masked(plain_all, fns["shade_fn"], T(o["ray_o"]), T(o["ray_d"]),
                                T(o["points"]), T(o["convergent_mask"]))
        resh = {k: v.cpu().numpy() for k, v in resh.items()}
        interior = (o["hit_mask"] & plain["hit_mask"] & ~o["edge_mask"] & ~plain["edge_mask"])
        own = o["convergent_mask"]
        reshade_c = float(np.abs(o["color"] - resh["color"])[own].max(initial=0))
        reshade_g = float(np.abs(o["raw_grad"] - resh["raw_grad"])[own].max(initial=0))

        def differ(key):
            union = o[key] | plain[key]
            return int((o[key] != plain[key]).sum()), int(union.sum())

        (hit_d, hit_u), (edge_d, edge_u) = differ("hit_mask"), differ("edge_mask")
        dc = np.abs(o["color"] - plain["color"]).max(-1)
        dp = np.linalg.norm(o["points"] - plain["points"], axis=-1)
        edges = o["edge_mask"] & plain["edge_mask"]
        same_root = interior & (np.abs(o["depth"] - plain["depth"]) <= 1e-4)
        two_roots = float(1.0 - same_root.sum() / max(interior.sum(), 1))
        moved = same_root & (dp > 0)
        gain = float((dc[moved] / dp[moved]).max(initial=0))
        off_int = float((dc[interior] > 1e-3).mean()) if interior.any() else 0.0
        off_edge = float((dc[edges] > 1e-3).mean()) if edges.any() else 0.0
        log(f"kernels vs plain render, view 0 at {res}x{res}: coverage "
            f"{float(o['hit_mask'].mean()):.4f}; hit masks differ on {hit_d} of {hit_u} pixels "
            f"hit in either, edge masks on {edge_d} of {edge_u} (tol <= 1% each); re-shading "
            f"the kernels' interior points through the plain K3: colour within {reshade_c:.3e}, "
            f"gradient within {reshade_g:.3e} (tol 1e-4); interior pixels with two roots "
            f"{two_roots:.2e} (tol <= 5e-3), colour off by > 1e-3 {off_int:.2e} (tol <= 5e-3), "
            f"max diff {float(dc[interior].max(initial=0)):.3e} "
            f"({float(dc[same_root].max(initial=0)):.3e} where the roots agree, at most "
            f"{gain:.1f} x the distance between the two roots); shared edge pixels "
            f"({int(edges.sum())}) max diff {float(dc[edges].max(initial=0)):.3e}, share off "
            f"by > 1e-3 {off_edge:.2e}")
        assert hit_d <= 0.01 * hit_u and edge_d <= 0.01 * max(edge_u, 1)
        assert reshade_c <= 1e-4 and reshade_g <= 1e-4
        assert two_roots <= 5e-3 and off_int <= 5e-3

    compare_with_plain(args.res, outs[0])
    # 128x128, the training patch the tracer's budgets are tuned for: here
    # the edge pipeline has pixels to compare
    if args.res != 128:
        compare_with_plain(128)

    # Each kernel against its plain version on the inputs the main path
    # gives it: view 0 rendered again through the kernels, recording every
    # kernel call (the counted run above is over; these launches are not
    # counted).
    fns = build_stage2_fns(trainer.params, trainer.mat_cfgs, cfg)
    calls = {name: [] for name in calls_of_render}

    def recorded(name, fn):
        def call(*a):
            calls[name].append(tuple(x.clone() if isinstance(x, torch.Tensor) else x
                                     for x in a))
            return fn(*a)
        return call

    render_view0(args.res, fns,
                 sdf_all_fn=recorded("sdf_value_feat_grad", fns["sdf_all_fn"]),
                 coarse_sdf_fn=recorded("sdf_only_bf16", fns["coarse_sdf_fn"]),
                 coarse_march_fn=recorded("coarse_march", fns["coarse_march_fn"]))
    log("main-path calls of view 0: " + ", ".join(
        f"{k} {[tuple(c[0].shape[:-1]) for c in v]}" for k, v in calls.items()))
    k1_view_stats = [check_k1(margs, f"main-path call {i} of view 0")
                     for i, margs in enumerate(calls["coarse_march"])]
    for i, (p,) in enumerate(calls["sdf_only_bf16"]):
        check_k2(p, f"main-path call {i}")
    for i, (x,) in enumerate(calls["sdf_value_feat_grad"]):
        check_k3(x, f"main-path call {i}")

    # ---- 6b. the trace_pallas render: every accurate trace evaluation
    # (refine, stragglers, fallback revalidation, bisection, edge sides)
    # through K4 ----
    cfg_tp = dataclasses.replace(cfg, trace_pallas=True)
    trainer_tp = copy.copy(trainer)      # the same parameters
    trainer_tp.cfg = cfg_tp
    calls_of_tp_render = calls_of_render + ("sdf_only_3pass",)
    kernels.reset_launch_counts()
    tp_s, outs_tp = [], []
    for i in range(args.views):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs_tp.append(trainer_tp.render_full(i))
        tp_s.append(time.perf_counter() - t0)
    tp_launches = kernels.launch_counts()
    log(f"render_full with trace_pallas x{args.views} at {args.res}x{args.res}: "
        + ", ".join(f"{s:.2f} s" for s in tp_s) + f"; launches {tp_launches}")
    assert all(tp_launches[k] > 0 for k in calls_of_tp_render), tp_launches
    assert all(tp_launches[k] == 0 for k in tp_launches if k not in calls_of_tp_render), \
        tp_launches
    for i, (o, o_ref) in enumerate(zip(outs_tp, outs)):
        for k in ("color", "normal", "depth"):
            assert np.isfinite(o[k]).all(), (i, k)
        cov = float(o["hit_mask"].mean())
        log(f"  view {i}: coverage {cov:.4f} (without trace_pallas "
            f"{float(o_ref['hit_mask'].mean()):.4f}), edge pixels {int(o['edge_mask'].sum())}")
        assert cov > 0

    # K4 against its plain version on every trace call of view 0
    fns_tp = build_stage2_fns(trainer.params, trainer.mat_cfgs, cfg_tp)
    k4_calls = []

    def rec_k4(p):
        k4_calls.append(p.clone())
        return fns_tp["trace_sdf_fn"](p)

    render_view0(args.res, fns_tp, trace_sdf_fn=rec_k4)
    errs4 = [k4_err(p) for p in k4_calls]
    n4 = [p.numel() // 3 for p in k4_calls]
    log(f"K4 on the {len(k4_calls)} trace calls of view 0 at {args.res}x{args.res} "
        f"({sum(n4)} points, largest {max(n4)}): max|K4 - plain| {max(errs4):.3e} "
        f"(tol {K4_PLAIN_TOL:.0e})")
    k4_big = max(k4_calls, key=lambda p: p.numel())
    check_k4(k4_big, "largest main-path call")

    def along_ray_min(o: dict, pix: np.ndarray) -> np.ndarray:
        """The f32 SDF's minimum along the primary ray of each pixel in pix,
        over its span through the unit sphere (4096 samples)."""
        ro = torch.as_tensor(o["ray_o"][pix], device=dev)
        rd = torch.as_tensor(o["ray_d"][pix], device=dev)
        _, near, far = intersect_sphere(ro, rd)
        zs = torch.linspace(0, 1, 4096, device=dev)
        with torch.no_grad():
            return np.asarray([float(sdf_only(net, ro[i] + rd[i] * (near[i] + zs * (
                far[i] - near[i]))[:, None]).min()) for i in range(ro.shape[0])])

    # the render through K4 against the same render through K4's plain
    # version, at 128x128 (at full frame the fallback-budget fault leaves
    # little coverage to compare).  Both agree to 1e-5 at most, so only a
    # graze can differ: a ray whose f32 SDF dips under zero by less than
    # 1e-3 along its span, where the tracer's 5e-5 threshold decides; each
    # ray whose state differs may move one other ray across the tracer's
    # fallback budget; an edge pixel may differ only on the silhouette of
    # either hit mask, where the edge walk seeds at depth steps of 1e-2.
    tp128 = render_view0(128, fns_tp)
    tp128_plain = render_view0(128, fns_tp,
                               trace_sdf_fn=lambda p: K12.sdf_only_3pass_plain(w4, p))
    hit_diff = tp128["hit_mask"] != tp128_plain["hit_mask"]
    edge_diff = tp128["edge_mask"] != tp128_plain["edge_mask"]
    mins = along_ray_min(tp128, hit_diff)
    grazes = int((mins > -1e-3).sum())
    sil = on_silhouette(tp128["hit_mask"]) | on_silhouette(tp128_plain["hit_mask"])
    hit_u = int((tp128["hit_mask"] | tp128_plain["hit_mask"]).sum())
    interior = tp128["hit_mask"] & tp128_plain["hit_mask"] & ~tp128["edge_mask"] \
        & ~tp128_plain["edge_mask"]
    dd = np.abs(tp128["depth"] - tp128_plain["depth"])[interior]
    log(f"trace_pallas render, K4 vs its plain version, view 0 at 128x128: coverage "
        f"{float(tp128['hit_mask'].mean()):.4f}; hit masks differ on {int(hit_diff.sum())} of "
        f"{hit_u} pixels hit in either ({grazes} grazes, along-ray f32 minima "
        f"{[f'{m:.2e}' for m in mins]}), edge masks on {int(edge_diff.sum())} (all on the "
        f"silhouette: {bool(sil[edge_diff].all())}); interior depth max diff "
        f"{float(dd.max(initial=0)):.3e}, share above 1e-4 {float((dd > 1e-4).mean()):.2e}")
    assert int(hit_diff.sum()) - grazes <= grazes and bool(sil[edge_diff].all())
    assert int(hit_diff.sum() + edge_diff.sum()) <= 0.005 * hit_u
    assert float((dd > 1e-4).mean()) <= 5e-3

    # ... and against the render without trace_pallas (f32 trace).  K4's
    # error (up to ~2e-4, smooth in x) is above the tracer's 5e-5 root
    # threshold, so roots move by it over the SDF's slope along the ray: the
    # trade the JAX package documents for its 3-pass kernel.  Held as the
    # kernels-vs-plain render is: masks within 1% of the pixels set in
    # either, at most 0.5% of interior pixels with depths more than 1e-3 apart.
    f128 = render_view0(128, fns)
    (hd, hu), (ed, eu) = mask_diff(tp128, f128, "hit_mask"), mask_diff(tp128, f128, "edge_mask")
    interior = tp128["hit_mask"] & f128["hit_mask"] & ~tp128["edge_mask"] & ~f128["edge_mask"]
    dd = np.abs(tp128["depth"] - f128["depth"])[interior]
    log(f"trace_pallas vs f32-trace render, view 0 at 128x128: hit masks differ on {hd} of "
        f"{hu}, edge masks on {ed} of {eu} (tol <= 1% each); interior depth max diff "
        f"{float(dd.max(initial=0)):.3e}, share above 1e-3 {float((dd > 1e-3).mean()):.2e} "
        f"(tol <= 5e-3), above 1e-4 {float((dd > 1e-4).mean()):.2e}")
    assert hd <= 0.01 * hu and ed <= 0.01 * max(eu, 1)
    assert float((dd > 1e-3).mean()) <= 5e-3

    # ---- 7. K3-bwd against its plain version on random points ----
    def check_k3_bwd(w, x, cots, what: str) -> None:
        """K3-bwd against its plain version: every output within 1e-4 of its
        largest entry (f32 sums over up to 65,536 points, and across blocks,
        in another order), and two launches bit for bit the same (the
        per-block partials are summed in a fixed order)."""
        got = K3.sdf_value_feat_grad_bwd(w, x, *cots)
        again = K3.sdf_value_feat_grad_bwd(w, x, *cots)
        torch.cuda.synchronize()
        ref = K3.sdf_value_feat_grad_bwd_plain(w, x, *cots)
        flat = lambda r: [r[2]] + list(r[0]) + list(r[1])
        rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(flat(got), flat(ref))]
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(again)))
        err = max(float((a - b).abs().max()) for a, b in zip(flat(got), flat(ref)))
        rows, clusters = K3.bwd_tiling(x.numel() // 3, K3._lib().iron_grad_bwd_clusters())
        log(f"K3-bwd {what} ({x.numel() // 3} points, {rows}-row tiles on {clusters} clusters, "
            f"{4 * clusters} CTAs): max |K3-bwd - plain| / max |plain| over dx, {len(got[0])} "
            f"matrices and {len(got[1])} biases {max(rel):.3e} (tol 1e-4), max abs err "
            f"{err:.3e}, deterministic {same}")
        assert max(rel) <= 1e-4 and same
        for t in flat(got):
            assert torch.isfinite(t).all()
        max_err["sdf_value_feat_grad_bwd"] = max(max_err.get("sdf_value_feat_grad_bwd", 0.0), err)

    def random_cots(n: int, w):
        c = [rng.normal(size=s).astype(np.float32) for s in ((n,), (n, w.d_out - 1), (n, 3))]
        return [torch.as_tensor(t, device=dev) for t in c]

    w3g = K3.prepare_grad_weights(net)
    for n in (1, 63, 65, 4096, 65536, 100000):
        xb = torch.as_tensor((rng.normal(size=(n, 3)) * 0.4).astype(np.float32), device=dev)
        check_k3_bwd(w3g, xb, random_cots(n, w3g), "on random points")

    # ---- 8. the training step at the bench configuration ----
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset
    from iron_tpu_torch.surface.render import SurfaceRenderConfig
    from iron_tpu_torch.train.stage2 import stage2_loss

    t0 = time.perf_counter()
    data = render_synthetic_dataset("sphere", n_views=4, H=256, W=256, light=30.0, device=dev)
    tcfg = Stage2Config(renderer_name="comp", patch_size=128,
                        surface=SurfaceRenderConfig(edge_budget=1024, interior_budget=4096))
    gen_t = torch.Generator(device=dev).manual_seed(args.seed + 1)
    tr = Stage2Trainer(tcfg, data["images"], data["Ks"], data["W2Cs"], generator=gen_t,
                       device=dev)
    log(f"training data: sphere, 4 views at 256x256, coverage "
        f"{[round(float(m.mean()), 4) for m in data['masks']]} ({time.perf_counter() - t0:.1f} s)")

    class PlainCore(torch.autograd.Function):
        """The fused core with the plain versions as forward and backward."""
        @staticmethod
        def forward(ctx, w, x, *params):
            ctx.w = w
            ctx.save_for_backward(x)
            return K3.sdf_value_feat_grad_plain(w, x)

        @staticmethod
        def backward(ctx, dv, df, dg):
            (x,) = ctx.saved_tensors
            dW, db, dx = K3.sdf_value_feat_grad_bwd_plain(ctx.w, x, dv, df, dg)
            return (None, dx, *dW, *db)

    def plain_fns(all_plain: bool, trainer=None) -> dict:
        """`trainer`'s evaluators (default phase 8's) with K3 through its plain
        versions, and with all_plain K1 and K2 too."""
        trainer = tr if trainer is None else trainer
        f = build_stage2_fns(trainer.params, trainer.mat_cfgs, trainer.cfg)
        wg = K3.prepare_grad_weights(trainer.params["sdf"], differentiable=True)
        f["sdf_all_fn"] = lambda x: PlainCore.apply(wg, x, *wg.mats, *wg.biases)
        if all_plain:
            wb = K12.prepare_bf16_weights(trainer.params["sdf"])
            f["coarse_sdf_fn"] = lambda p: K12.sdf_only_bf16_plain(wb, p)
            f["coarse_march_fn"] = lambda *a: K12.coarse_march_plain(wb, *a, thr)
        return f

    g0 = np.random.default_rng((args.seed + 1) * 1_000_003)   # run()'s first crop
    crop = (int(g0.integers(0, 4)), int(g0.integers(0, 128)), int(g0.integers(0, 128)))
    eik_seed = 5
    eik = torch.rand((128 * 128 // 2, 3),
                     generator=torch.Generator(device=dev).manual_seed(eik_seed),
                     device=dev) * 2 - 1

    def one_step(trainer, fns=None):
        """loss, metrics and every gradient of one step of `trainer` on
        `crop` (with the crop's mask when the trainer has masks; no update)."""
        cam, gt, gt_mask = trainer.crop(*crop)
        named = list(trainer.params.named_parameters())
        for _, p in named:
            p.grad = None
        loss, m = stage2_loss(trainer.params, trainer.mat_cfgs, trainer.cfg, cam, gt, eik,
                              gt_mask, fns=fns)
        loss.backward()
        grads = {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                 for n, p in named}
        return float(loss.detach()), {k: float(v.detach()) for k, v in m.items()}, grads

    def one_loss(trainer, at=None, params=None) -> float:
        """The loss of `trainer` (with `params`, default its own) on the crop
        `at` (default `crop`) and `eik`: no graph, no update."""
        cam, gt, gt_mask = trainer.crop(*(crop if at is None else at))
        with torch.no_grad():
            return float(stage2_loss(trainer.params if params is None else params,
                                     trainer.mat_cfgs, trainer.cfg, cam, gt, eik, gt_mask)[0])

    bwd_calls = []
    kernels.reset_launch_counts()
    K3._FusedSdfCore.record = bwd_calls
    try:
        loss_k, m_k, g_k = one_step(tr)
    finally:
        K3._FusedSdfCore.record = None
    step_launches = kernels.launch_counts()
    loss_p3, m_p3, g_p3 = one_step(tr, plain_fns(all_plain=False))
    loss_pa, m_pa, g_pa = one_step(tr, plain_fns(all_plain=True))
    log(f"training step on crop {crop} (view, col, row): loss {loss_k:.6f} through the "
        f"kernels, {loss_p3:.6f} with K3 plain, {loss_pa:.6f} all plain; launches {step_launches}; "
        f"mask_frac {m_k['mask_frac']:.4f}, edge pixels {m_k['edge_pixel_count']:.0f}; "
        f"K3 calls {[tuple(c[1].shape[:-1]) for c in bwd_calls]}")
    step_path = ("coarse_march", "sdf_only_bf16", "sdf_value_feat_grad",
                 "sdf_value_feat_grad_bwd")
    assert all(step_launches[k] >= 1 for k in step_path), step_launches
    assert all(step_launches[k] == 0 for k in step_launches if k not in step_path), step_launches
    assert len(bwd_calls) == step_launches["sdf_value_feat_grad_bwd"]

    def leaf_errs(ga, gb, rel: float):
        """Each leaf's largest difference over its tolerance rel * (its
        largest entry + 1e-3 of the largest gradient entry of the step): a
        gradient is a sum of terms that can cancel to far below the terms,
        and f32 rounding follows the terms (the roughness head's gradients
        cancel so).  A ratio above 1 fails."""
        g_scale = max(float(g.abs().max()) for g in ga.values())
        return {n: float((ga[n] - gb[n]).abs().max())
                / (rel * (float(gb[n].abs().max()) + 1e-3 * g_scale)) for n in ga}

    def hold_retraced(label, ref, got, count_keys, hold_grads: bool = True) -> None:
        """(b) below: a step whose trace ran on other evaluators against the
        step through the kernels: masks within 1% and the loss within 1e-3
        always, every gradient leaf within 5e-3 when the masks agree (and
        hold_grads)."""
        (loss_a, m_a, g_a), (loss_b, m_b, g_b) = ref, got
        same = all(m_a[k] == m_b[k] for k in count_keys)
        errs_b = leaf_errs(g_a, g_b, 5e-3)
        worst_b = max(errs_b, key=errs_b.get)
        log(f"  {label}: masks agree {same} (mask_frac {m_b['mask_frac']:.4f}, edge pixels "
            f"{m_b['edge_pixel_count']:.0f}), loss rel diff {abs(loss_a - loss_b) / abs(loss_b):.3e} "
            f"(tol 1e-3), worst gradient leaf {worst_b} at {errs_b[worst_b]:.3f} of its "
            f"tolerance (5e-3 of its largest entry + 5e-6 of the step's; "
            f"{'held when the masks agree' if hold_grads else 'reported'})")
        assert abs(m_a["mask_frac"] - m_b["mask_frac"]) <= 0.01 * max(m_b["mask_frac"], 1e-6)
        assert abs(loss_a - loss_b) <= 1e-3 * abs(loss_b)
        if same and hold_grads:
            assert errs_b[worst_b] <= 1.0

    # (a) the same trace (K1, K2), K3 through its kernels or its plain
    # versions: the gradients differ only by K3's f32 sums in another order
    # (1e-6 relative on the card, phases 4 and 7), which the shading and
    # losses carry through unchanged in size; held at 1e-4.
    errs = leaf_errs(g_k, g_p3, 1e-4)
    worst = max(errs, key=errs.get)
    g_scale = max(float(g.abs().max()) for g in g_k.values())
    log(f"  kernels vs K3 plain (same trace): loss rel diff {abs(loss_k - loss_p3) / abs(loss_p3):.3e} "
        f"(tol 1e-5); gradients: largest entry of the step {g_scale:.3e}, worst leaf {worst} "
        f"(largest entry {float(g_p3[worst].abs().max()):.3e}) at {errs[worst]:.3f} of its "
        f"tolerance (1e-4 of its largest entry + 1e-7 of the step's)")
    assert abs(loss_k - loss_p3) <= 1e-5 * abs(loss_p3) and errs[worst] <= 1.0
    for k in ("mask_frac", "edge_pixel_count", "edge_seed_count"):
        assert m_k[k] == m_p3[k], k
    # (b) everything plain, the trace too: K1/K2's bf16 sums in another
    # order can move a root by up to the tracer's 5e-5 (phase 6), as between
    # the JAX package and the port on the CPU, where the step's gradients
    # are held to 2e-3 of each leaf's largest entry (tests/test_torch_train.py;
    # here 1.7e-3 on the card); held at 5e-3 when the masks agree, and always
    # the masks to 1% and the loss to 1e-3.
    counts = ("mask_frac", "edge_pixel_count", "edge_seed_count")
    hold_retraced("kernels vs all plain", (loss_k, m_k, g_k), (loss_pa, m_pa, g_pa), counts)
    for i, (w, x, cots) in enumerate(bwd_calls):
        check_k3_bwd(w, x, cots, f"training-step call {i}")

    def recorded_step(trainer) -> dict:
        """The inputs of every K1, K2 and K3-fwd call of one more step of
        `trainer` on `crop` (not counted): the step's shapes for phase 9."""
        f = build_stage2_fns(trainer.params, trainer.mat_cfgs, trainer.cfg)
        rec = {}
        for key, name in (("coarse_march_fn", "coarse_march"), ("coarse_sdf_fn", "sdf_only_bf16"),
                          ("sdf_all_fn", "sdf_value_feat_grad")):
            def call(*a, fn=f[key], calls=rec.setdefault(name, [])):
                calls.append(tuple(x.detach().clone() if isinstance(x, torch.Tensor) else x
                                   for x in a))
                return fn(*a)
            f[key] = call
        one_step(trainer, f)
        return rec

    step_calls = recorded_step(tr)
    step_calls["sdf_value_feat_grad_bwd"] = bwd_calls
    w12s, w3s = K12.prepare_bf16_weights(tr.params["sdf"]), K3.prepare_grad_weights(tr.params["sdf"])
    # K1 and K3-fwd against their plain versions on every call of the step
    k1_step_stats = [check_k1(c, f"training-step call {i}", w12s)
                     for i, c in enumerate(step_calls["coarse_march"])]
    for i, (x,) in enumerate(step_calls["sdf_value_feat_grad"]):
        check_k3(x, f"training-step call {i}", w3s)
    for i, (p,) in enumerate(step_calls["sdf_only_bf16"]):
        check_k2(p, f"training-step call {i}", tr.params["sdf"])

    # K1's cooperative launch.  (a) A grid one CTA larger than the card holds
    # at once is refused with an error that names the cooperative launch,
    # and nothing runs.  (b) The step's and the view's marches, launched
    # while ~50 ms kernels on other streams hold part of the card (a block
    # on each of 8 SMs, so that those SMs take one CTA of K1 where they take
    # two), give the outputs of the same marches alone, bit for bit: the
    # grid waits until it is resident as a whole, and no CTA spins at the
    # grid barrier for one that cannot start.
    marches = [(w12s, c) for c in step_calls["coarse_march"]] + [(w12, calls["coarse_march"][0])]
    with torch.no_grad():
        alone = [K12.coarse_march(w, *c, thr) for w, c in marches]
        torch.cuda.synchronize()
        # the view's march, its rays repeated to one 64-ray tile a CTA and more
        ro_v, rd_v, acc0_v, work_v, md_v, n_it_v = calls["coarse_march"][0]
        dev_k1 = work_v.device
        card_ctas = K12._MARCH_CTAS[dev_k1]
        rep = -(-64 * (card_ctas + 1) // work_v.numel())
        big = (ro_v.reshape(-1, 3).repeat(rep, 1), rd_v.reshape(-1, 3).repeat(rep, 1),
               acc0_v.reshape(-1).repeat(rep), work_v.reshape(-1).repeat(rep),
               torch.broadcast_to(md_v, work_v.shape).reshape(-1).repeat(rep), n_it_v)
        K12._MARCH_CTAS[dev_k1] = card_ctas + 1
        try:
            K12.coarse_march(w12, *big, thr)
            torch.cuda.synchronize()
            refused = None
        except RuntimeError as e:
            refused = str(e)
        finally:
            K12._MARCH_CTAS[dev_k1] = card_ctas
        log(f"K1 with a grid of {card_ctas + 1} CTAs ({card_ctas} held at once): "
            f"{'refused: ' + refused if refused else 'NOT refused'}")
        assert refused is not None and "cooperative launch" in refused
        side = [torch.cuda.Stream() for _ in range(8)]
        t_side = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_side[0].record(side[0])
        for st in side:
            with torch.cuda.stream(st):
                torch.cuda._sleep(100_000_000)   # ~50 ms at 2 GHz
        t_side[1].record(side[0])
        t0 = time.perf_counter()
        beside = [K12.coarse_march(w, *c, thr) for w, c in marches]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same = [all(torch.equal(a, b) for a, b in zip(x, y)) for x, y in zip(alone, beside)]
    log(f"K1 beside 8 kernels of {t_side[0].elapsed_time(t_side[1]):.1f} ms on other streams: "
        f"{len(marches)} marches (the step's and view 0's) done {wall * 1e3:.1f} ms after their "
        f"launch, outputs bit-equal to the marches alone: {same}")
    assert all(same)

    # the run: 8 warm-up steps, then args.train_steps more, each timed and
    # its launches counted; no plain version may see a CUDA tensor
    plain_names = [(K12, "sdf_only_bf16_plain"), (K12, "coarse_march_plain"),
                   (K12, "sdf_only_3pass_plain"), (K3, "sdf_value_feat_grad_plain"),
                   (K3, "sdf_value_feat_grad_bwd_plain"), (K3, "sdf_full_plain")]

    def refuse(name, fn):
        def call(*a, **k):
            for t in list(a) + list(k.values()):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    raise AssertionError(f"{name} reached with a CUDA tensor on the main path")
            return fn(*a, **k)
        return call

    def train_run(trainer, path, label: str, n_warm: int = 8, n_timed: int = None,
                  window_falls: bool = True):
        """n_warm + n_timed (default args.train_steps) steps of trainer.run:
        every kernel of `path` launched at every step and no other, finite
        losses, falling (the mean img_loss of the last 10 steps below that
        of the first 10) unless window_falls is False.  Returns (launches of
        the run, median step seconds)."""
        n_timed = args.train_steps if n_timed is None else n_timed
        step_s, per_step, history = [], [], []
        train_step = trainer.train_step
        saved = {(m, n): getattr(m, n) for m, n in plain_names}

        def timed_step(*a):
            before = kernels.launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = train_step(*a)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            after = kernels.launch_counts()
            per_step.append({k: after[k] - before[k] for k in after})
            return out

        trainer.train_step = timed_step
        for (m, n), fn in saved.items():
            setattr(m, n, refuse(n, fn))
        kernels.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            trainer.run(num_iters=n_warm, seed=args.seed, history=history)
            trainer.run(num_iters=n_timed, seed=args.seed, history=history)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            for (m, n), fn in saved.items():
                setattr(m, n, fn)
            trainer.train_step = train_step
        run_launches = kernels.launch_counts()
        img = [float(h["img_loss"]) for h in history]
        losses = [float(h["loss"]) for h in history]
        timed = step_s[n_warm:]
        med = float(np.median(timed))
        log(f"Stage2Trainer.run{label}, {len(history)} steps ({n_warm} warm-up + {n_timed}): "
            f"{run_s:.2f} s; launches {run_launches}; img_loss first 10 "
            f"{[round(v, 4) for v in img[:10]]}, last 10 {[round(v, 4) for v in img[-10:]]}")
        log(f"training step{label}: median {med * 1e3:.2f} ms over {len(timed)} timed steps "
            f"(host clock with a synchronise after each step; min {min(timed) * 1e3:.2f}, max "
            f"{max(timed) * 1e3:.2f}), {128 * 128 / med:.1f} rays/s; card {card}")
        assert all(np.isfinite(v) for v in losses + img)
        assert np.mean(img[-10:]) < np.mean(img[:10]) or not window_falls, \
            (np.mean(img[:10]), np.mean(img[-10:]))
        for i, d in enumerate(per_step):
            assert all(d[k] >= 1 for k in path) and all(d[k] == 0 for k in d if k not in path), \
                (i, d)
        for p in trainer.params.parameters():
            assert torch.isfinite(p).all()
        return run_launches, med

    launches, s2_median = train_run(tr, step_path, "")

    # ---- 8b. the training step with trace_pallas, the dataset's masks and
    # the silhouette term: the trace, the edge-side traces and the
    # silhouette sweep run on K4 ----
    tcfg_tp = dataclasses.replace(tcfg, trace_pallas=True, silhouette_weight=0.3)
    tr_tp = Stage2Trainer(tcfg_tp, data["images"], data["Ks"], data["W2Cs"],
                          generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
                          masks=data["masks"], device=dev)
    step_path_tp = step_path + ("sdf_only_3pass",)
    fns_step = build_stage2_fns(tr_tp.params, tr_tp.mat_cfgs, tcfg_tp)
    k4_step_calls = []
    trace_k4 = fns_step["trace_sdf_fn"]
    fns_step["trace_sdf_fn"] = lambda p: k4_step_calls.append(p.detach().clone()) or trace_k4(p)
    kernels.reset_launch_counts()
    loss_t, m_t, g_t = one_step(tr_tp, fns_step)
    tp_step_launches = kernels.launch_counts()
    w4s = K12.prepare_3pass_weights(tr_tp.params["sdf"])
    fns_plain4 = build_stage2_fns(tr_tp.params, tr_tp.mat_cfgs, tcfg_tp)
    fns_plain4["trace_sdf_fn"] = lambda p: K12.sdf_only_3pass_plain(w4s, p)
    loss_t4, m_t4, g_t4 = one_step(tr_tp, fns_plain4)
    sweep = (tcfg_tp.silhouette_budget, tcfg_tp.silhouette_samples, 3)
    k4_shapes = [tuple(p.shape) for p in k4_step_calls]
    log(f"training step with trace_pallas and the silhouette term on crop {crop}: loss "
        f"{loss_t:.6f} through K4, {loss_t4:.6f} through its plain version; launches "
        f"{tp_step_launches}; {len(k4_step_calls)} K4 calls, the silhouette sweep {sweep} "
        f"among them: {sweep in k4_shapes}; silhouette loss {m_t['silhouette_loss']:.4e}, "
        f"mask miss / excess {m_t['mask_miss_count']:.0f} / {m_t['mask_excess_count']:.0f}")
    assert all(tp_step_launches[k] >= 1 for k in step_path_tp), tp_step_launches
    assert sweep in k4_shapes and len(k4_step_calls) == tp_step_launches["sdf_only_3pass"]
    step_calls["sdf_only_3pass"] = k4_step_calls
    hold_retraced("K4 vs its plain version", (loss_t, m_t, g_t), (loss_t4, m_t4, g_t4),
                  counts + ("mask_miss_count", "mask_excess_count"))
    # K4 against its plain version on every call of the step, and on ragged
    # sizes; the JAX criteria against the f32 SDF on all the step's points
    errs4s = [k4_err(p, w4s) for p in k4_step_calls]
    n4s = [p.numel() // 3 for p in k4_step_calls]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas = [K12.k4_width(k, sms) * -(-k // 64) for k in n4s]
    log(f"K4 on the {len(k4_step_calls)} calls of the trace_pallas step ({sum(n4s)} points, "
        f"{min(n4s)} to {max(n4s)} a call, median {int(np.median(n4s))}; CTAs a call: median "
        f"{int(np.median(ctas))}, {min(ctas)} to {max(ctas)}): max|K4 - plain| "
        f"{max(errs4s):.3e} (tol {K4_PLAIN_TOL:.0e})")
    for n in (1, 63, 65):
        xr = torch.as_tensor(rng.uniform(-1, 1, size=(n, 3)).astype(np.float32), device=dev)
        log(f"K4 on {n} random points: max|K4 - plain| {k4_err(xr):.3e} (tol "
            f"{K4_PLAIN_TOL:.0e})")
    check_k4(torch.cat([p.reshape(-1, 3) for p in k4_step_calls]), "on all points of the step",
             tr_tp.params["sdf"])
    launches_tp, _ = train_run(tr_tp, step_path_tp, " with trace_pallas")

    # ---- 8c. the SDF sweep of make_sdf_fn (K5, the counterpart of the JAX
    # package's make_pallas_sdf_fn) on 262,144 points ----
    kernels.reset_launch_counts()
    with torch.no_grad():
        swept = kernels.make_sdf_fn(net)(x_u)
    sweep_launches = kernels.launch_counts()
    log(f"make_sdf_fn sweep of {tuple(x_u.shape)}: output {tuple(swept.shape)}, launches "
        f"{sweep_launches}")
    assert sweep_launches["sdf_full"] == 1 and sum(sweep_launches.values()) == 1
    assert swept.shape == (x_u.shape[0], cfg.sdf.d_out) and torch.isfinite(swept).all()
    check_k5(calls["sdf_value_feat_grad"][0][0], "on the render's shading points")
    launches.update(sdf_only_3pass=launches_tp["sdf_only_3pass"],
                    sdf_full=sweep_launches["sdf_full"])

    # ---- 8d. stage 1: NeuS volume training at the womask_iron width (SDF,
    # colour net and background NeRF 8x256, 512 rays of 64 + 64 samples and
    # 32 background samples a step) on phase 8's synthetic sphere ----
    s1 = stage1_phase(args, dev, card, data, kernels, K12, K3, PlainCore, leaf_errs, check_k3,
                      check_k3_bwd, refuse, plain_names, tcfg, crop, eik)

    # ---- 8e. the user's run through the CLIs (train_volume, validate_mesh,
    # train_surface with its final export, --render_all, evaluate) ----
    cli = cli_phase(args, dev, card, kernels, refuse, plain_names)

    # ---- 8f. the research paths: the multi and disney flavours, the
    # rgb -> refrac -> env curriculum, RGB + NIR stage 1 and the hash-grid
    # runner ----
    research = research_phase(args, dev, card, data, kernels, {
        "one_step": one_step, "one_loss": one_loss, "plain_fns": plain_fns,
        "hold_retraced": hold_retraced,
        "leaf_errs": leaf_errs, "train_run": train_run, "refuse": refuse,
        "plain_names": plain_names, "step_path": step_path, "tcfg": tcfg, "crop": crop})

    # ---- 8g. data-parallel training and rendering (dist/): NCCL at a world
    # of 1, then two ranks on the card over gloo ----
    dp = dp_phase(args, dev, card, data, kernels, {
        "leaf_errs": leaf_errs, "step_path": step_path, "crop": crop, "eik_seed": eik_seed,
        "s1_median_s": s1["median_s"], "s2_median_s": s2_median})

    # ---- 8h. the chunked runs (stage 1 as a replayed CUDA graph, stage 2's
    # crops drawn on the device), orbax, the video and tp ----
    graph = graph_phase(args, dev, card, data, kernels)

    # ---- 8i. the image formats the JAX package reads through OpenCV: a
    # stage-1 run from tests/data_formats/ ----
    formats = formats_phase(args, dev, card, kernels)

    # ---- 8j. WebP and PAM: the same stage-1 run from tests/data_webp/ ----
    webp = webp_phase(args, dev, card, kernels)

    # ---- 8k. JPEG 2000: the same stage-1 run from tests/data_jp2/ ----
    jp2 = jp2_phase(args, dev, card, kernels)

    # ---- 8l. TIFF as libtiff reads it: the same stage-1 run from tests/data_tiff/ ----
    tiff = tiff_phase(args, dev, card, kernels)

    # ---- 8m. the image writers and preprocess, and a render through them ----
    writers = writers_phase(args, dev, card, kernels)

    # ---- 8n. the JPEG 2000 writer: the fixture's bytes, and a render through it ----
    writers2 = writers2_phase(args, dev, card, kernels)

    # ---- 8o. damaged files as cv2.imread reads them: a stage-1 run from
    # tests/data_damaged/ ----
    damaged = damaged_phase(args, dev, card, kernels)

    # ---- 8p. the TIFF corners OpenCV reads: a stage-1 run from
    # tests/data_tiff_wide/, and the plots without matplotlib ----
    tiff_wide = tiff_wide_phase(args, dev, card, kernels)

    # ---- 8q. damaged headers as cv2.imread reads them: a stage-1 run from
    # tests/data_header/ ----
    header = header_phase(args, dev, card, kernels)

    # ---- 8r. the JPEG 2000 corners OpenCV reads: a stage-1 run from
    # tests/data_jp2_corners/ ----
    jp2_corners = jp2_corners_phase(args, dev, card, kernels)

    # ---- 8s. the quality path: e2e validation, the PSNR decomposition and
    # the relighting eval on the blobby scene ----
    quality = quality_phase(args, dev, card, kernels)

    # ---- 8t. the research scripts: the single-view fit, the tracer's
    # coverage, the torus diagnostics, the resume experiment and the
    # silhouette A/B ----
    scripts = scripts_phase(args, dev, card, kernels)

    # ---- 9. timings at the slice's shapes ----
    kernel_rows = []
    work = sdf_work(cfg.sdf)
    bw = bwd_work(cfg.sdf)
    wbytes12 = work["weights_value"] * 2
    wbytes4 = 2 * work["weights_value"] * 2      # the hi and the lo halves

    # each kernel's bound on one call's inputs: (ms, 'bytes' or 'operations')
    def bound_k1(w, margs):
        n = margs[0].numel() // 3
        with torch.no_grad():
            evals = K12.coarse_march_schedule(w, *margs, thr)[3]["evaluations"]
        return bound(n * (3 * 4 * 2 + 4 * 2 + 1) + n * (4 * 2 + 1) + wbytes12,
                     evals * 2 * work["value"], BF16_FLOPS, evals * work["transc"])

    def bound_k2(pts):
        n = pts.numel() // 3
        return bound(n * (12 + 4) + wbytes12, n * 2 * work["value"], BF16_FLOPS,
                     n * work["transc"])

    def bound_k3(x, flop_rate=F32_FLOPS, passes=1):
        """K3-fwd's bound in f32 on the CUDA cores; bound_k3(x, TF32_FLOPS,
        3) is that of its route, three tf32 tensor-core products a MAC."""
        n = x.numel() // 3
        return bound(n * (12 + 4 + (cfg.sdf.d_out - 1) * 4 + 12) + work["weights_all"] * 4,
                     n * 2 * passes * work["value_grad"], flop_rate, n * work["transc"])

    def fwd_tiling(x):
        dev_ = x.device
        lib3 = K3._lib()
        return K3.fwd_tiling(x.numel() // 3,
                             lambda cs: K3._fwd_place(lib3, dev_, 64, cs, w3.n_layers, False)[1])

    def bound_k3_bwd(x, flop_rate=TF32_FLOPS, passes=3):
        """K3-bwd runs its products as three tf32 tensor-core products a MAC
        (3xTF32); bound_k3_bwd(x, F32_FLOPS, 1) is the bound of the same
        work in f32 on the CUDA cores."""
        n = x.numel() // 3
        return bound(n * (12 + (cfg.sdf.d_out + 3) * 4 + 12) + 2 * bw["weights_all"] * 4,
                     n * 2 * passes * bw["macs"], flop_rate, n * bw["transc"])

    def bound_k4(pts):
        n = pts.numel() // 3
        return bound(n * (12 + 4) + wbytes4, n * 2 * 3 * work["value"], BF16_FLOPS,
                     n * work["transc"])

    if not args.no_timing:
        torch.cuda.synchronize()
        with torch.no_grad():
            # K1: the image march of view 0
            margs = calls["coarse_march"][0]
            ms = cuda_ms(lambda: K12.coarse_march(w12, *margs, thr))
            plain_ms = cuda_ms(lambda: K12.coarse_march_plain(w12, *margs, thr),
                               iters=3, warmup=1)
            st = k1_view_stats[0]
            log(f"K1 image march: the data needs {st['evaluations']} SDF evaluations, "
                f"{st['tile_evals']} 64-ray tile-evaluations, {ms / st['tile_evals'] * 1e3:.2f} us "
                f"of the call a tile-evaluation")
            kernel_rows.append(("coarse_march", "iron_tpu_torch/kernels/csrc/fused_sdf.cu",
                                "iron_tpu/kernels/fused_sdf.py:571", ms, plain_ms,
                                *bound_k1(w12, margs)))

            # K2: the fallback sweep of the image trace
            pts = calls["sdf_only_bf16"][0][0]
            ms = cuda_ms(lambda: K12.sdf_only_bf16(w12, pts))
            log(f"K2 on the view's fallback sweep ({pts.numel() // 3} points): (rows a CTA, "
                f"grid) {K12.k2_tiling(pts.numel() // 3, K12._K2_CTAS[pts.device])}")
            plain_ms = cuda_ms(lambda: K12.sdf_only_bf16_plain(w12, pts), iters=5)
            kernel_rows.append(("sdf_only_bf16", "iron_tpu_torch/kernels/csrc/fused_sdf.cu",
                                "iron_tpu/kernels/fused_sdf.py:277", ms, plain_ms,
                                *bound_k2(pts)))

            # K3: interior shading, every pixel of the view
            x_img = calls["sdf_value_feat_grad"][0][0]
            ms = cuda_ms(lambda: K3.sdf_value_feat_grad(w3, x_img), iters=5)
            plain_ms = cuda_ms(lambda: K3.sdf_value_feat_grad_plain(w3, x_img), iters=3)
            kernel_rows.append(("sdf_value_feat_grad",
                                "iron_tpu_torch/kernels/csrc/fused_sdf_grad.cu",
                                "iron_tpu/kernels/fused_sdf_grad.py:423", ms, plain_ms,
                                *bound_k3(x_img, TF32_FLOPS, 3)))
            log(f"K3-fwd bound on the render's {x_img.numel() // 3} points: "
                f"{bound_k3(x_img, TF32_FLOPS, 3)[0]:.4f} ms as 3xTF32 on the tensor cores (the "
                f"route it takes), {bound_k3(x_img)[0]:.4f} ms in f32 on the CUDA cores; tiling "
                f"(rows, width, clusters) {fwd_tiling(x_img)}")

        # K3-bwd: the training step's largest call (the interior budget)
        w, xb, cots = max(bwd_calls, key=lambda c: c[1].numel())
        ms = cuda_ms(lambda: K3.sdf_value_feat_grad_bwd(w, xb, *cots), iters=10)
        plain_ms = cuda_ms(lambda: K3.sdf_value_feat_grad_bwd_plain(w, xb, *cots), iters=5)
        kernel_rows.append(("sdf_value_feat_grad_bwd",
                            "iron_tpu_torch/kernels/csrc/fused_sdf_grad.cu",
                            "iron_tpu/kernels/fused_sdf_grad.py:502", ms, plain_ms,
                            *bound_k3_bwd(xb)))
        log(f"K3-bwd bound on the step's largest call ({xb.numel() // 3} points): "
            f"{bound_k3_bwd(xb)[0]:.4f} ms as 3xTF32 on the tensor cores (the route it takes), "
            f"{bound_k3_bwd(xb, F32_FLOPS, 1)[0]:.4f} ms in f32 on the CUDA cores; over the "
            f"step's {len(bwd_calls)} calls {sum(bound_k3_bwd(c[1])[0] for c in bwd_calls):.4f} "
            f"and {sum(bound_k3_bwd(c[1], F32_FLOPS, 1)[0] for c in bwd_calls):.4f} ms")

        # K4: its largest main-path call (a trace call of view 0) and 262,144
        # uniform points; beside each, the port's f32 sdf_only, the trace
        # evaluator that K4 replaces under trace_pallas
        for label, pts4 in (("largest main-path call", k4_big), ("uniform points", x_u)):
            with torch.no_grad():
                ms4 = cuda_ms(lambda: K12.sdf_only_3pass(w4, pts4))
                plain4 = cuda_ms(lambda: K12.sdf_only_3pass_plain(w4, pts4), iters=5)
                f32_ms = cuda_ms(lambda: sdf_only(net, pts4), iters=5)
            b4 = bound_k4(pts4)
            log(f"time sdf_only_3pass on the {label} ({pts4.numel() // 3} points): {ms4:.3f} ms, "
                f"plain {plain4:.3f} ms, f32 sdf_only {f32_ms:.3f} ms, bound {b4[0]:.4f} ms "
                f"({b4[1]}), {b4[0] / ms4:.1%} of the bound")
            if pts4 is k4_big:
                kernel_rows.append(("sdf_only_3pass", "iron_tpu_torch/kernels/csrc/fused_sdf.cu",
                                    "iron_tpu/kernels/fused_sdf.py:410", ms4, plain4, *b4))

        # K5: the sweep's 262,144 points; its route is three tf32
        # tensor-core products a MAC (3xTF32), the f32 bound beside it
        n5 = x_u.shape[0]
        with torch.no_grad():
            ms = cuda_ms(lambda: K3.sdf_full(w3, x_u), iters=5)
            plain_ms = cuda_ms(lambda: K3.sdf_full_plain(w3, x_u), iters=3)

        def bound_k5(flop_rate, passes):
            return bound(n5 * (12 + cfg.sdf.d_out * 4) + work["weights_all"] * 4,
                         n5 * 2 * passes * work["value_all"], flop_rate, n5 * work["transc"])

        kernel_rows.append(("sdf_full", "iron_tpu_torch/kernels/csrc/fused_sdf_grad.cu",
                            "iron_tpu/kernels/fused_sdf.py:460", ms, plain_ms,
                            *bound_k5(TF32_FLOPS, 3)))
        log(f"K5 bound on the sweep's {n5} points: {bound_k5(TF32_FLOPS, 3)[0]:.4f} ms as 3xTF32 "
            f"on the tensor cores (the route it takes), {bound_k5(F32_FLOPS, 1)[0]:.4f} ms in f32 "
            f"on the CUDA cores; {K3.K5_ROWS}-row tiles on "
            f"{K3.k5_grid(n5, K3._K5_HELD[x_u.device])} CTAs")
        log(f"counted a point: {work['value']} MACs for the sdf alone (K1, K2; three times "
            f"that for K4), {work['value_all']} for all {cfg.sdf.d_out} outputs (K5; three tf32 "
            f"products each), "
            f"{work['value_grad']} for value, feature and gradient, {bw['macs']} for their "
            f"adjoint (K3-bwd), {work['transc']} transcendentals")
        for r in kernel_rows:
            log(f"time {r[0]}: {r[3]:.3f} ms, plain {r[4]:.3f} ms, bound {r[5]:.4f} ms "
                f"({r[6]}), {r[5] / r[3]:.1%} of the bound")
        log(f"render_full per view: {np.median(render_s):.3f} s median of {len(render_s)}, "
            f"with trace_pallas {np.median(tp_s):.3f} s (host clock, first view includes "
            f"warm-up)")

        # the training step's shapes: every call of one step (the trace_pallas
        # step for K4), each timed alone, summed, against its bounds summed:
        # launches x (time - bound), the redesign queue's order
        with torch.no_grad():
            per_call = {
                "coarse_march": (lambda c: K12.coarse_march(w12s, *c, thr),
                                 lambda c: bound_k1(w12s, c)),
                "sdf_only_bf16": (lambda c: K12.sdf_only_bf16(w12s, c[0]),
                                  lambda c: bound_k2(c[0])),
                "sdf_value_feat_grad": (lambda c: K3.sdf_value_feat_grad_fwd(w3s, c[0]),
                                        lambda c: bound_k3(c[0], TF32_FLOPS, 3)),
                "sdf_value_feat_grad_bwd": (lambda c: K3.sdf_value_feat_grad_bwd(*c[:2], *c[2]),
                                            lambda c: bound_k3_bwd(c[1])),
                "sdf_only_3pass": (lambda c: K12.sdf_only_3pass(w4s, c),
                                   lambda c: bound_k4(c)),
            }
            step_cost = []
            for name, (run, bnd) in per_call.items():
                cs = step_calls[name]
                ts = [cuda_ms(lambda c=c: run(c), iters=5, warmup=1) for c in cs]
                t = sum(ts)
                b = sum(bnd(c)[0] for c in cs)
                step_cost.append((t - b, name, len(cs), t, b))
                if name == "sdf_value_feat_grad_bwd":
                    log("K3-bwd on the step's calls: " + ", ".join(
                        f"{c[1].numel() // 3} points {tc:.4f} ms (bound {bnd(c)[0]:.4f} ms)"
                        for c, tc in zip(cs, ts)))
                elif name == "sdf_value_feat_grad":
                    log("K3-fwd on the step's calls: " + ", ".join(
                        f"{c[0].numel() // 3} points {tc:.4f} ms (tiling {fwd_tiling(c[0])}; "
                        f"bound {bnd(c)[0]:.4f} ms as 3xTF32, {bound_k3(c[0])[0]:.4f} ms in f32)"
                        for c, tc in zip(cs, ts)))
                elif name == "coarse_march":
                    log("K1 on the step's calls (the chain: the slowest ray's iterations + 1 "
                        "evaluations in a row): " + ", ".join(
                            f"{st['rays']} rays, {st['iterations'] + 1} evaluations in a row, "
                            f"{tc:.4f} ms, {tc / (st['iterations'] + 1) * 1e3:.1f} us an "
                            f"evaluation (bound {bnd(c)[0]:.4f} ms)"
                            for c, tc, st in zip(cs, ts, k1_step_stats)))
        log("the training step's shapes, each kernel over the calls of one step "
            "(launches x (time - bound), largest first): " + "; ".join(
                f"{name} {n} launches, {t:.3f} ms against a bound of {b:.4f} ms ({b / t:.1%}), "
                f"gap {gap:.3f} ms" for gap, name, n, t, b in sorted(step_cost, reverse=True)))

    # the stage-1 shapes (phase 8d): K3-fwd on a step's 65,536 points and a
    # render chunk's 131,072, K3-bwd on the step's 65,536, K2 on each
    # up-sample sweep of an upsample_pallas step (32,768, then 3 x 8,192)
    stage1 = {"step_ms_median": s1["median_s"] * 1e3, "rays_per_s": s1["cfg"].batch_size
              / s1["median_s"], "host_syncs_per_step": s1["syncs"],
              "sync_sites": s1["sync_sites"], "render_image_s": s1["render_s"],
              "k2_upsample": s1["k2_upsample"], "card": card}
    if not args.no_timing:
        w1 = K3.prepare_grad_weights(s1["trainer"].params["sdf"])
        wb = K12.prepare_bf16_weights(s1["up_trainer"].params["sdf"])
        w, xb, cots = s1["bwd"]
        timed = {}
        with torch.no_grad():
            for label, x in (("K3-fwd step", s1["fwd"]), ("K3-fwd render chunk", s1["render"])):
                timed[label] = (x.numel() // 3, cuda_ms(lambda: K3.sdf_value_feat_grad_fwd(w1, x)),
                                cuda_ms(lambda: K3.sdf_value_feat_grad_plain(w1, x), iters=3),
                                bound_k3(x, TF32_FLOPS, 3))
            timed["K3-bwd step"] = (
                xb.numel() // 3, cuda_ms(lambda: K3.sdf_value_feat_grad_bwd(w, xb, *cots)),
                cuda_ms(lambda: K3.sdf_value_feat_grad_bwd_plain(w, xb, *cots), iters=3),
                bound_k3_bwd(xb))
            for i, p in enumerate(s1["k2"]):
                timed[f"K2 up-sample sweep {i}"] = (
                    p.numel() // 3, cuda_ms(lambda: K12.sdf_only_bf16(wb, p)),
                    cuda_ms(lambda: K12.sdf_only_bf16_plain(wb, p), iters=5), bound_k2(p))
        for label, (n, ms, plain_ms, (b, by)) in timed.items():
            log(f"time {label} ({n} points): {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b:.4f} ms ({by}), {b / ms:.1%} of the bound")
        rows_k3 = K3.bwd_tiling(xb.numel() // 3, K3._lib().iron_grad_bwd_clusters())
        log(f"K3-bwd on the stage-1 step: {rows_k3[0]}-row tiles on {rows_k3[1]} clusters, "
            f"{-(-xb.numel() // 3 // rows_k3[0]) / rows_k3[1]:.1f} rounds; K3-fwd tiling (rows, "
            f"width, clusters) {fwd_tiling(s1['fwd'])}, render chunk {fwd_tiling(s1['render'])}")
        stage1["kernels"] = {k: {"points": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                                 "bound_by": by} for k, (n, ms, plain_ms, (b, by)) in timed.items()}
        k2 = [v for k, v in timed.items() if k.startswith("K2")]
        stage1["k2_step_ms"] = sum(v[1] for v in k2)
        stage1["k2_step_bound_ms"] = sum(v[3][0] for v in k2)
    log(json.dumps({"stage1": stage1}))

    # ---- 9b. the device traces of the graph replays (phases 8e and 8h),
    # last, after every timed phase ----
    run_deferred_traces()

    # ---- 10. the kernels line (launches: the training run of phase 8 for K1-K3,
    # of phase 8b for K4, the sweep of phase 8c for K5) ----
    # each kernel's launches on phase 8f's paths beside those of phase 8
    research_launches = {name: {
        "multi": research["multi"]["run_launches"][name],
        "disney": research["disney"]["run_launches"][name],
        "curriculum": sum(research["curriculum"][p]["launches"][name]
                          for p in ("rgb", "refrac", "env")),
        "multispectral": research["multispectral"]["launches_total"][name],
        "runner": 0} for name in kernels.KERNELS}
    # and each kernel's launches a rank a step on phase 8g's dp paths
    dp_launches = {name: {
        "stage1_step": dp["stage1"]["launches_a_rank_a_step"][name],
        "stage2_step": dp["stage2"]["launches_a_rank_a_step"][name],
        "stage1_render": dp["render1"]["launches"][name],
        "stage2_band_render": dp["render2"]["launches"][name]} for name in kernels.KERNELS}
    # and a step's launches on phase 8h's paths
    graph_launches = {name: {
        "stage1_replay_a_step": graph["stage1"]["launches_a_replay"].get(name, 0),
        "stage1_upsample_replay_a_step":
            graph["upsample_pallas_chunk"]["launches_a_replay"].get(name, 0),
        "stage2_chunk_a_step": graph["stage2"]["launches_a_step"][-1][name],
        "video_16_frames": graph["video"]["launches"].get(name, 0),
        "tp_a_rank_a_step": graph["tp"]["launches_a_step"].get(name, 0)}
        for name in kernels.KERNELS}
    rows = [{"name": r[0], "route": "cuda", "source": r[1], "replaces": r[2],
             "launches": launches[r[0]], "max_abs_err": max_err[r[0]], "ms": r[3],
             "plain_ms": r[4], "bound_ms": r[5], "bound_by": r[6], "library_ms": None,
             "research_launches": research_launches[r[0]], "dp_launches": dp_launches[r[0]],
             "graph_launches": graph_launches[r[0]],
             "webp_launches": webp["launches"].get(r[0], 0),
             "jp2_launches": jp2["launches"].get(r[0], 0),
             "tiff_launches": tiff["launches"].get(r[0], 0),
             "writers_launches": writers["launches"].get(r[0], 0),
             "writers2_launches": writers2["launches"].get(r[0], 0),
             "damaged_launches": damaged["launches"].get(r[0], 0),
             "tiff_wide_launches": tiff_wide["launches"].get(r[0], 0),
             "header_launches": header["launches"].get(r[0], 0),
             "jp2_corners_launches": jp2_corners["launches"].get(r[0], 0),
             "quality_launches": {k: v[r[0]] for k, v in quality["launches"].items()},
             "scripts_launches": {k: v[r[0]] for k, v in scripts["launches"].items()}}
            for r in kernel_rows]
    log(json.dumps({"cli": cli}))
    log(json.dumps({"research": research}))
    log(json.dumps({"dp": dp}))
    log(json.dumps({"graph": graph}))
    log(json.dumps({"formats": formats}))
    log(json.dumps({"webp": webp}))
    log(json.dumps({"jp2": jp2}))
    log(json.dumps({"tiff": tiff}))
    log(json.dumps({"writers": writers}))
    log(json.dumps({"writers2": writers2}))
    log(json.dumps({"damaged": damaged}))
    log(json.dumps({"tiff_wide": tiff_wide}))
    log(json.dumps({"header": header}))
    log(json.dumps({"jp2_corners": jp2_corners}))
    log(json.dumps({"quality": quality}))
    log(json.dumps({"scripts": scripts}))
    log(json.dumps({"kernels": rows}))
    log(card)
    # ---- 11. result ----
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
