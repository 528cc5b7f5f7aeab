#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the full run: 4 views at 512x512, 2 x 38 training steps

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
    gives it, then 8 + 30 steps of Stage2Trainer.run with every kernel of
    the path launched at every step, finite and falling losses, and no
    plain version reached by a CUDA tensor;
  * the same training with trace_pallas, the dataset's masks and
    silhouette_weight 0.3 (the silhouette sweep runs on K4 too): one step
    against the same step through K4's plain version, then 8 + 30 steps;
  * the SDF sweep of iron_tpu_torch.kernels.make_sdf_fn (K5) on 262,144
    points, held against its plain version and the f32 sdf_apply;

then times each kernel beside its plain version and its bound, and prints:

  * the card's name and power limit (nvidia-smi);
  * one JSON line {"kernels": [...]} on the six kernels (launches: K1-K3
    from the default training run, K4 from the trace_pallas training run,
    K5 from the sweep);
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


def march_evaluations(w, ro, rd, acc0, work, max_dis, n_iters, thr) -> int:
    """SDF evaluations the coarse march needs on these rays: every ray once,
    then every active ray once per iteration (plain arithmetic)."""
    import torch
    from iron_tpu_torch.kernels.fused_sdf import sdf_only_bf16_plain
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    max_dis = torch.broadcast_to(max_dis, work.shape).reshape(-1)
    work = work.reshape(-1)
    acc = acc0.reshape(-1).clone()
    s = sdf_only_bf16_plain(w, ro + rd * acc[:, None])
    act = work & (s.abs() > thr) & (acc < max_dis)
    evals = ro.shape[0]
    for _ in range(n_iters):
        k = int(act.sum())
        if k == 0:
            break
        evals += k
        acc = acc + torch.where(act, s, 0.0)
        s = torch.where(act, sdf_only_bf16_plain(w, ro + rd * acc[:, None]), s)
        act = act & (s.abs() > thr) & (acc < max_dis)
    return evals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512, help="render resolution (square)")
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=30,
                    help="timed training steps after the 8 warm-up steps (at least 10)")
    ap.add_argument("--no-timing", action="store_true", help="skip phase 9")
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

    def check_k2(pts, what: str, against_f32: bool = False) -> None:
        with torch.no_grad():
            k2 = K12.sdf_only_bf16(w12, pts)
            torch.cuda.synchronize()
            k2_plain = K12.sdf_only_bf16_plain(w12, pts)
            f32 = sdf_only(net, pts)
        assert k2.shape == pts.shape[:-1] and torch.isfinite(k2).all()
        err = float((k2 - k2_plain).abs().max())
        msg = f"K2 sdf_only_bf16 {what} {tuple(pts.shape)}: max|K2 - plain| {err:.3e} (tol 5e-3)"
        if against_f32:
            err_f32 = float((k2 - f32).abs().max())
            msg += f", max|K2 - f32 sdf| {err_f32:.3e} (tol 1.2e-2, the bf16 coarse budget)"
            assert err_f32 <= 1.2e-2
        log(msg)
        assert err <= BF16_REORDER_TOL
        max_err["sdf_only_bf16"] = max(max_err.get("sdf_only_bf16", 0.0), err)

    def check_k3(x, what: str) -> None:
        with torch.no_grad():
            got = K3.sdf_value_feat_grad(w3, x)
            torch.cuda.synchronize()
            ref = K3.sdf_value_feat_grad_plain(w3, x)
        errs = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        scale = [float(b.abs().max()) for b in ref]
        log(f"K3 sdf_value_feat_grad {what} {tuple(x.shape)}: max err value {errs[0]:.3e} "
            f"feature {errs[1]:.3e} grad {errs[2]:.3e} (magnitudes {scale[0]:.2f}, "
            f"{scale[1]:.2f}, {scale[2]:.2f}; tol 1e-5 + 1e-5 relative: f32 sums in another "
            f"order)")
        for a, e, s in zip(got, errs, scale):
            assert torch.isfinite(a).all() and e <= 1e-5 + 1e-5 * s
        max_err["sdf_value_feat_grad"] = max(max_err.get("sdf_value_feat_grad", 0.0), *errs)

    def check_k1(margs, what: str) -> None:
        """K1 against its plain version on one march.  A ray may stop up to
        one coarse step (< 2e-2) apart.  A ray that passes the surface with
        |sdf| near the 2e-2 threshold (a graze) stops there in one version
        and marches on in the other when the two sum orders round an
        activation apart, so its distances can differ by much more.  Held:
        the active masks agree on 99.9% of the rays, and of the rays further
        apart than 3e-2, every one whose earlier stop lies inside the sphere
        has |sdf| <= threshold + 5e-3 (the bf16 reordering error) there
        under both evaluators: it is a graze within the evaluators' error of
        the threshold.  The others left the sphere in both versions or are
        still marching in both (the same outcome, at other distances)."""
        ro, rd, acc0, work, max_dis, n_it = margs
        with torch.no_grad():
            a_k, acc_k, _ = K12.coarse_march(w12, *margs, thr)
            torch.cuda.synchronize()
            a_p, acc_p, _ = K12.coarse_march_plain(w12, *margs, thr)
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
            p = ro.reshape(-1, 3)[graze] + rd.reshape(-1, 3)[graze] * early[graze][:, None]
            s_k = s_p = s_f32 = p.new_zeros(0)
            if p.shape[0]:
                s_k = K12.sdf_only_bf16(w12, p).abs()
                s_p = K12.sdf_only_bf16_plain(w12, p).abs()
                s_f32 = sdf_only(net, p).abs()
        n_apart, n_graze = int(apart.sum()), int(graze.sum())
        n_left = int((apart & (early >= md)).sum())
        top = lambda t: float(t.max()) if t.numel() else 0.0
        log(f"K1 coarse_march {what} ({wk.numel()} rays, {int(wk.sum())} marching, {n_it} "
            f"iters): max|acc K1 - plain| {err:.3e}, active masks agree {agree:.6f} (tol >= "
            f"0.999); rays apart by > 3e-2: {n_apart} ({n_apart / max(int(wk.sum()), 1):.2e} "
            f"of the marching), {n_graze} of them stopped inside the sphere first; at that "
            f"stop max |sdf| K1-arithmetic {top(s_k):.3e}, plain {top(s_p):.3e} (tol "
            f"{thr + BF16_REORDER_TOL:.3e}), f32 {top(s_f32):.3e}, min plain "
            f"{float(s_p.min()) if n_graze else 0.0:.3e}; of the others {n_left} left the "
            f"sphere in both, {n_apart - n_graze - n_left} are still marching in both")
        assert agree >= 0.999
        assert top(s_k) <= thr + BF16_REORDER_TOL and top(s_p) <= thr + BF16_REORDER_TOL
        max_err["coarse_march"] = max(max_err.get("coarse_march", 0.0), err)

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
            f"{K5_TOL:.0e}), max|K5 - f32 sdf_apply| {err_f32:.3e} (tol {K5_TOL:.0e} + 1e-5 "
            f"relative; magnitude {float(f32.abs().max()):.2f})")
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
        check_k2(pts, "on random rays", against_f32=True)

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
    for i, margs in enumerate(calls["coarse_march"]):
        check_k1(margs, f"main-path call {i}")
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

    def plain_fns(all_plain: bool) -> dict:
        f = build_stage2_fns(tr.params, tr.mat_cfgs, tcfg)
        wg = K3.prepare_grad_weights(tr.params["sdf"], differentiable=True)
        f["sdf_all_fn"] = lambda x: PlainCore.apply(wg, x, *wg.mats, *wg.biases)
        if all_plain:
            wb = K12.prepare_bf16_weights(tr.params["sdf"])
            f["coarse_sdf_fn"] = lambda p: K12.sdf_only_bf16_plain(wb, p)
            f["coarse_march_fn"] = lambda *a: K12.coarse_march_plain(wb, *a, thr)
        return f

    g0 = np.random.default_rng((args.seed + 1) * 1_000_003)   # run()'s first crop
    crop = (int(g0.integers(0, 4)), int(g0.integers(0, 128)), int(g0.integers(0, 128)))
    eik = torch.rand((128 * 128 // 2, 3), generator=torch.Generator(device=dev).manual_seed(5),
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

    def hold_retraced(label, ref, got, count_keys) -> None:
        """(b) below: a step whose trace ran on other evaluators against the
        step through the kernels: masks within 1% and the loss within 1e-3
        always, every gradient leaf within 5e-3 when the masks agree."""
        (loss_a, m_a, g_a), (loss_b, m_b, g_b) = ref, got
        same = all(m_a[k] == m_b[k] for k in count_keys)
        errs_b = leaf_errs(g_a, g_b, 5e-3)
        worst_b = max(errs_b, key=errs_b.get)
        log(f"  {label}: masks agree {same} (mask_frac {m_b['mask_frac']:.4f}, edge pixels "
            f"{m_b['edge_pixel_count']:.0f}), loss rel diff {abs(loss_a - loss_b) / abs(loss_b):.3e} "
            f"(tol 1e-3), worst gradient leaf {worst_b} at {errs_b[worst_b]:.3f} of its "
            f"tolerance (5e-3 of its largest entry + 5e-6 of the step's; held when the masks "
            f"agree)")
        assert abs(m_a["mask_frac"] - m_b["mask_frac"]) <= 0.01 * max(m_b["mask_frac"], 1e-6)
        assert abs(loss_a - loss_b) <= 1e-3 * abs(loss_b)
        if same:
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

    def train_run(trainer, path, label: str):
        """8 + args.train_steps steps of trainer.run: every kernel of `path`
        launched at every step and no other, finite and falling losses.
        Returns (launches of the run, median step seconds)."""
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
            trainer.run(num_iters=8, seed=args.seed, history=history)
            trainer.run(num_iters=args.train_steps, seed=args.seed, history=history)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            for (m, n), fn in saved.items():
                setattr(m, n, fn)
            trainer.train_step = train_step
        run_launches = kernels.launch_counts()
        img = [float(h["img_loss"]) for h in history]
        losses = [float(h["loss"]) for h in history]
        timed = step_s[8:]
        med = float(np.median(timed))
        log(f"Stage2Trainer.run{label}, {len(history)} steps (8 warm-up + {args.train_steps}): "
            f"{run_s:.2f} s; launches {run_launches}; img_loss first 10 "
            f"{[round(v, 4) for v in img[:10]]}, last 10 {[round(v, 4) for v in img[-10:]]}")
        log(f"training step{label}: median {med * 1e3:.2f} ms over {len(timed)} timed steps "
            f"(host clock with a synchronise after each step; min {min(timed) * 1e3:.2f}, max "
            f"{max(timed) * 1e3:.2f}), {128 * 128 / med:.1f} rays/s; card {card}")
        assert all(np.isfinite(v) for v in losses + img)
        assert np.mean(img[-10:]) < np.mean(img[:10]), (np.mean(img[:10]), np.mean(img[-10:]))
        for i, d in enumerate(per_step):
            assert all(d[k] >= 1 for k in path) and all(d[k] == 0 for k in d if k not in path), \
                (i, d)
        for p in trainer.params.parameters():
            assert torch.isfinite(p).all()
        return run_launches, med

    launches, _ = train_run(tr, step_path, "")

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
            evals = march_evaluations(w, *margs, thr)
        return bound(n * (3 * 4 * 2 + 4 * 2 + 1) + n * (4 * 2 + 1) + wbytes12,
                     evals * 2 * work["value"], BF16_FLOPS, evals * work["transc"])

    def bound_k2(pts):
        n = pts.numel() // 3
        return bound(n * (12 + 4) + wbytes12, n * 2 * work["value"], BF16_FLOPS,
                     n * work["transc"])

    def bound_k3(x):
        n = x.numel() // 3
        return bound(n * (12 + 4 + (cfg.sdf.d_out - 1) * 4 + 12) + work["weights_all"] * 4,
                     n * 2 * work["value_grad"], F32_FLOPS, n * work["transc"])

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
            log(f"K1 image march: the data needs {march_evaluations(w12, *margs, thr)} SDF "
                f"evaluations")
            kernel_rows.append(("coarse_march", "iron_tpu_torch/kernels/csrc/fused_sdf.cu",
                                "iron_tpu/kernels/fused_sdf.py:571", ms, plain_ms,
                                *bound_k1(w12, margs)))

            # K2: the fallback sweep of the image trace
            pts = calls["sdf_only_bf16"][0][0]
            ms = cuda_ms(lambda: K12.sdf_only_bf16(w12, pts))
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
                                *bound_k3(x_img)))

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

        # K5: the sweep's 262,144 points
        n5 = x_u.shape[0]
        with torch.no_grad():
            ms = cuda_ms(lambda: K3.sdf_full(w3, x_u), iters=5)
            plain_ms = cuda_ms(lambda: K3.sdf_full_plain(w3, x_u), iters=3)
        b_ms, b_by = bound(n5 * (12 + cfg.sdf.d_out * 4) + work["weights_all"] * 4,
                           n5 * 2 * work["value_all"], F32_FLOPS, n5 * work["transc"])
        kernel_rows.append(("sdf_full", "iron_tpu_torch/kernels/csrc/fused_sdf_grad.cu",
                            "iron_tpu/kernels/fused_sdf.py:460", ms, plain_ms, b_ms, b_by))
        log(f"counted a point: {work['value']} MACs for the sdf alone (K1, K2; three times "
            f"that for K4), {work['value_all']} for all {cfg.sdf.d_out} outputs (K5), "
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
                                        lambda c: bound_k3(c[0])),
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
        log("the training step's shapes, each kernel over the calls of one step "
            "(launches x (time - bound), largest first): " + "; ".join(
                f"{name} {n} launches, {t:.3f} ms against a bound of {b:.4f} ms ({b / t:.1%}), "
                f"gap {gap:.3f} ms" for gap, name, n, t, b in sorted(step_cost, reverse=True)))

    # ---- 10. the kernels line (launches: the training run of phase 8 for K1-K3,
    # of phase 8b for K4, the sweep of phase 8c for K5) ----
    rows = [{"name": r[0], "route": "cuda", "source": r[1], "replaces": r[2],
             "launches": launches[r[0]], "max_abs_err": max_err[r[0]], "ms": r[3],
             "plain_ms": r[4], "bound_ms": r[5], "bound_by": r[6], "library_ms": None}
            for r in kernel_rows]
    log(json.dumps({"kernels": rows}))
    log(card)
    # ---- 11. result ----
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
