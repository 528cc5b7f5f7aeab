"""Evaluation metrics: PSNR / SSIM / LPIPS on image folders, Chamfer on
meshes (counterpart of iron_tpu/eval/metrics.py).

Behavioral specs:
  * eval_image_folder (evaluation/eval_image_folder.py:10-64): per-image
    PSNR = -10 log10 MSE, SSIM (win 11, sigma 1.5), LPIPS-alex; writes a
    metrics table + averages;
  * eval_mesh (evaluation/eval_mesh.py:6-26): symmetric Chamfer =
    0.5 * (mean dist(verts1 -> mesh2) + mean dist(verts2 -> mesh1)).

PSNR is host numpy in f64.  SSIM (the port's `ssim_loss`) runs in f64 on
`device`: in f32, PyTorch's depthwise convolution on the CPU sums the 121
taps with errors up to ~1e-5 in the sigma = E[x^2] - mu^2 cancellation, 100x
the JAX package's f32 convolution, which lands within ~2e-7 of the f64
value.  The perceptual filters' convolution runs in f32 on `device` (TF32
off, as `resolve_device` leaves it).  LPIPS needs pretrained AlexNet weights, which
nothing here downloads: `lpips_np` returns None unless the `lpips` package
and torchvision's AlexNet checkpoint are already on the machine, and
`eval_image_folder` then reports `perceptual_distance_np`, a fixed-seed
random-feature metric (the LPIPS paper's random-network baseline), never
labeled "lpips".  Chamfer uses the native BVH (iron_tpu_torch/native).
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from iron_tpu_torch import resolve_device
from iron_tpu_torch.data.io import read_image
from iron_tpu_torch.losses.image import ssim_loss
from iron_tpu_torch.native import point_mesh_sq_distances

# torchvision's AlexNet weights, read by lpips.LPIPS(net="alex")
_ALEXNET_CKPT = "alexnet-owt-7be5be79.pth"


def psnr_np(pred: np.ndarray, gt: np.ndarray) -> float:
    mse = float(np.mean((pred.astype(np.float64) - gt.astype(np.float64)) ** 2))
    return -10.0 * np.log10(mse + 1e-12)


def _nchw(img: np.ndarray, dev: torch.device, dtype=np.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(img, np.float32).astype(dtype).transpose(2, 0, 1)[None]
                           .copy(), device=dev)


def ssim_np(pred: np.ndarray, gt: np.ndarray, device="cuda") -> float:
    """Mean SSIM (window 11, sigma 1.5) of f32 images, computed in f64."""
    dev = resolve_device(device)
    with torch.no_grad():
        return 1.0 - float(ssim_loss(_nchw(pred, dev, np.float64), _nchw(gt, dev, np.float64)))


_LPIPS = None
_LPIPS_TRIED = False


def lpips_np(pred: np.ndarray, gt: np.ndarray, device="cuda") -> Optional[float]:
    """LPIPS-alex if the `lpips` package and AlexNet's weights are already
    on this machine (nothing is downloaded), else None."""
    global _LPIPS, _LPIPS_TRIED
    dev = resolve_device(device)
    if not _LPIPS_TRIED:
        _LPIPS_TRIED = True
        ckpt = os.path.join(torch.hub.get_dir(), "checkpoints", _ALEXNET_CKPT)
        try:
            import lpips
        except ImportError:
            lpips = None
        if lpips is not None and os.path.isfile(ckpt):
            _LPIPS = lpips.LPIPS(net="alex", verbose=False)
    if _LPIPS is None:
        return None
    model = _LPIPS.to(dev)
    with torch.no_grad():
        return float(model(_nchw(pred, dev) * 2 - 1, _nchw(gt, dev) * 2 - 1))


_PERC_FILTERS = None


def _perceptual_filters():
    """Fixed-seed random conv banks for the perceptual metric."""
    global _PERC_FILTERS
    if _PERC_FILTERS is None:
        g = np.random.default_rng(1234)
        banks = []
        for _ in range(3):  # one bank per pyramid scale
            w = g.normal(size=(24, 3, 5, 5)).astype(np.float32)
            w -= w.mean(axis=(2, 3), keepdims=True)       # zero-mean taps
            w /= np.linalg.norm(w.reshape(24, -1), axis=1)[:, None, None, None]
            banks.append(w)
        _PERC_FILTERS = banks
    return _PERC_FILTERS


def perceptual_distance_np(pred: np.ndarray, gt: np.ndarray, device="cuda") -> float:
    """Self-contained LPIPS substitute: multi-scale random-feature distance.

    LPIPS-alex needs pretrained weights, which nothing here downloads.
    Zhang et al. (CVPR 2018, the LPIPS paper, Tab. 5) showed that
    *randomly initialized* conv features already track human perceptual
    judgments far better than PSNR/SSIM; this implements that baseline
    deterministically: 3 pyramid scales, each filtered by a fixed-seed
    zero-mean 24x3x5x5 conv bank, unit-normalized along channels, L2
    feature difference averaged over space/scales.  Documented substitute,
    not LPIPS — reported as "perceptual" (never "lpips").
    """
    dev = resolve_device(device)

    def feats(x, w):
        y = F.conv2d(_nchw(x, dev) * 2 - 1, torch.as_tensor(w, device=dev))
        y = torch.clamp(y, min=0.0)
        return y / (torch.linalg.norm(y, dim=1, keepdim=True) + 1e-10)

    def down2(x):
        H, W = x.shape[:2]
        return x[:2 * (H // 2), :2 * (W // 2)].reshape(
            H // 2, 2, W // 2, 2, -1).mean(axis=(1, 3))

    total = 0.0
    p, g = pred.astype(np.float32), gt.astype(np.float32)
    with torch.no_grad():
        for w in _perceptual_filters():
            d = feats(p, w) - feats(g, w)
            total += float(torch.mean(torch.sum(d * d, dim=1)))
            p, g = down2(p), down2(g)
    return total / 3.0


def chamfer_distance(verts1: np.ndarray, tris1: np.ndarray,
                     verts2: np.ndarray, tris2: np.ndarray) -> float:
    """Symmetric Chamfer, mean of means (eval_mesh.py:6-26)."""
    d12 = np.sqrt(point_mesh_sq_distances(verts1, verts2, tris2))
    d21 = np.sqrt(point_mesh_sq_distances(verts2, verts1, tris1))
    return 0.5 * (float(d12.mean()) + float(d21.mean()))


def eval_image_folder(pred_dir: str, gt_dir: str, out_path: Optional[str] = None,
                      device="cuda") -> Dict[str, float]:
    """Folder-vs-folder image metrics (eval_image_folder.py:36-64)."""
    preds = sorted(sum([glob.glob(os.path.join(pred_dir, f"*.{e}"))
                        for e in ("png", "jpg", "exr")], []))
    rows = []
    for pp in preds:
        name = os.path.basename(pp)
        stem = os.path.splitext(name)[0]
        cands = sum([glob.glob(os.path.join(gt_dir, f"{stem}.{e}"))
                     for e in ("png", "jpg", "exr")], [])
        if not cands:
            continue
        pred = read_image(pp)
        gt = read_image(cands[0])
        if pred.shape != gt.shape:
            continue
        row = {"name": name, "psnr": psnr_np(pred, gt), "ssim": ssim_np(pred, gt, device)}
        lp = lpips_np(pred, gt, device)
        if lp is not None:
            row["lpips"] = lp
        else:
            row["perceptual"] = perceptual_distance_np(pred, gt, device)
        rows.append(row)

    keys = [k for k in ("psnr", "ssim", "lpips", "perceptual")
            if rows and k in rows[0]]
    summary = {k: float(np.mean([r[k] for r in rows])) for k in keys}
    summary["n_images"] = len(rows)
    if out_path:
        with open(out_path, "w") as f:
            for r in rows:
                f.write("  ".join(f"{k}={v}" if isinstance(v, str) else f"{k}={v:.4f}"
                                  for k, v in r.items()) + "\n")
            f.write("AVG  " + "  ".join(f"{k}={v:.4f}" for k, v in summary.items()
                                        if k != "n_images") + "\n")
    return summary
