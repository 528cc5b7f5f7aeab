#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the full run: 4 views at 512x512

Builds the port's CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, drives the port's main path
(Stage2Trainer.render_full, the stage-2 surface render with the comp
renderer, at the full default SDF width, random weights from a seed) and
shows that the path launched every kernel, checks the render against the
same render through the plain versions, holds every kernel against its plain
version again on the very inputs the main path gives it, times each kernel
beside its plain version and its bound, and prints:

  * the card's name and power limit (nvidia-smi);
  * one JSON line {"kernels": [...]} on the kernels of the path;
  * last, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any failed phase raises, so the script exits non-zero and prints no result.
It imports nothing of JAX.  Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of an H100 SXM at its 700 W limit (dense): HBM bytes/s,
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# K2's tolerance against its plain version: the same bf16 arithmetic in
# another f32 sum order, where a sum on a bf16 rounding boundary rounds an
# activation one unit apart, moves the sdf by a few 1e-3 at most.
BF16_REORDER_TOL = 5e-3


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

      value:       MACs of the chain to the sdf column alone (K1 / K2);
      value_grad:  MACs of the chain to all d_out columns plus the reverse
                   sweep u @ W^T through every hidden layer (K3-fwd);
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
            "value_grad": hidden + dims[-2] * dims[-1] + hidden,
            "weights_value": hidden + dims[-2] + units + 1,
            "weights_all": hidden + dims[-2] * dims[-1] + units + dims[-1],
            "transc": 2 * units + 2 * sdf_cfg.multires * sdf_cfg.d_in}


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
    ap.add_argument("--no-timing", action="store_true", help="skip phase 7")
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
    from iron_tpu_torch.fields.sdf import sdf_only
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

    # ---- 6. the slice: render_full of every view at full width ----
    kernels.reset_launch_counts()
    render_s = []
    outs = []
    for i in range(args.views):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(trainer.render_full(i))
        render_s.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()
    log(f"render_full x{args.views} at {args.res}x{args.res}: "
        + ", ".join(f"{s:.2f} s" for s in render_s) + f"; launches {launches}")
    assert all(n > 0 for n in launches.values()), launches
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
                     coarse_march_fn=None) -> dict:
        cam, surf = view0(res)
        with torch.no_grad():
            out = render_camera(fns["sdf_fn"], sdf_all_fn or fns["sdf_all_fn"], fns["shade_fn"],
                                cam, surf, trace_sdf_fn=fns["trace_sdf_fn"],
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
    calls = {name: [] for name in kernels.KERNELS}

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

    # ---- 7. timings at the slice's shapes ----
    kernel_rows = []
    work = sdf_work(cfg.sdf)
    if not args.no_timing:
        torch.cuda.synchronize()
        # K1: the image march of view 0
        margs = calls["coarse_march"][0]
        n1 = margs[0].numel() // 3
        with torch.no_grad():
            evals = march_evaluations(w12, *margs, thr)
            ms = cuda_ms(lambda: K12.coarse_march(w12, *margs, thr))
            plain_ms = cuda_ms(lambda: K12.coarse_march_plain(w12, *margs, thr),
                               iters=3, warmup=1)
        log(f"K1 image march: the data needs {evals} SDF evaluations")
        wbytes12 = work["weights_value"] * 2
        b_ms, b_by = bound(n1 * (3 * 4 * 2 + 4 * 2 + 1) + n1 * (4 * 2 + 1) + wbytes12,
                           evals * 2 * work["value"], BF16_FLOPS, evals * work["transc"])
        kernel_rows.append(("coarse_march", "iron_tpu_torch/kernels/csrc/fused_sdf.cu",
                            "iron_tpu/kernels/fused_sdf.py:571", ms, plain_ms, b_ms, b_by))

        # K2: the fallback sweep of the image trace
        pts = calls["sdf_only_bf16"][0][0]
        n2 = pts.numel() // 3
        with torch.no_grad():
            ms = cuda_ms(lambda: K12.sdf_only_bf16(w12, pts))
            plain_ms = cuda_ms(lambda: K12.sdf_only_bf16_plain(w12, pts), iters=5)
        b_ms, b_by = bound(n2 * (12 + 4) + wbytes12, n2 * 2 * work["value"], BF16_FLOPS,
                           n2 * work["transc"])
        kernel_rows.append(("sdf_only_bf16", "iron_tpu_torch/kernels/csrc/fused_sdf.cu",
                            "iron_tpu/kernels/fused_sdf.py:277", ms, plain_ms, b_ms, b_by))

        # K3: interior shading, every pixel of the view
        x_img = calls["sdf_value_feat_grad"][0][0]
        n3 = x_img.numel() // 3
        with torch.no_grad():
            ms = cuda_ms(lambda: K3.sdf_value_feat_grad(w3, x_img), iters=5)
            plain_ms = cuda_ms(lambda: K3.sdf_value_feat_grad_plain(w3, x_img), iters=3)
        b_ms, b_by = bound(n3 * (12 + 4 + (cfg.sdf.d_out - 1) * 4 + 12)
                           + work["weights_all"] * 4,
                           n3 * 2 * work["value_grad"], F32_FLOPS, n3 * work["transc"])
        kernel_rows.append(("sdf_value_feat_grad", "iron_tpu_torch/kernels/csrc/fused_sdf_grad.cu",
                            "iron_tpu/kernels/fused_sdf_grad.py:423", ms, plain_ms, b_ms, b_by))
        log(f"counted a point: {work['value']} MACs for the sdf alone, {work['value_grad']} "
            f"for value, feature and gradient, {work['transc']} transcendentals")
        for r in kernel_rows:
            log(f"time {r[0]}: {r[3]:.3f} ms, plain {r[4]:.3f} ms, bound {r[5]:.4f} ms "
                f"({r[6]}), {r[5] / r[3]:.1%} of the bound")
        log(f"render_full per view: {np.median(render_s):.3f} s median of {len(render_s)} "
            f"(host clock, first view includes warm-up)")

    # ---- 8. the kernels line ----
    rows = [{"name": r[0], "route": "cuda", "source": r[1], "replaces": r[2],
             "launches": launches[r[0]], "max_abs_err": max_err[r[0]], "ms": r[3],
             "plain_ms": r[4], "bound_ms": r[5], "bound_by": r[6], "library_ms": None}
            for r in kernel_rows]
    log(json.dumps({"kernels": rows}))
    log(card)
    # ---- 9. result ----
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
