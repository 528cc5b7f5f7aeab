"""Single-view silhouette fit (counterpart of scripts/singleview_demo.py, with
its flags and its output).

Optimizes ONLY the SDF from one 512x512 photo (tests/data_singleview/12.png)
with a constant pink shade: MSE on the edge-mask pixels plus 0.1 x the
eikonal term, Adam(1e-4), random 128^2 crops, edge sampling on.  Steps run in
blocks of 16, so --iters is reached or passed by a whole block; a log line
and a mosaic (gt | render | normals | edge mask of a quarter-resolution
render) are written when step % log_every < 16.  Ends with the checkpoint
(the SDF tree in the JAX package's format) and one JSON line: the steps,
the IoU of the pixel-centre hit mask against the photo's nonzero region at
a quarter of the resolution, the wall time and `device`.

    python -m iron_tpu_torch.scripts.singleview_demo [--iters 15000] [--out_dir D] [--device cuda]

On a CUDA device the shading path's SDF core runs through K3 (K3-fwd, and
K3-bwd in the backward), built anew for each step; the trace is the plain
f32 `sdf_only` (accurate only: the JAX demo passes no coarse evaluator), the
edge walk the plain f32 `sdf_value_feat_grad` (as stage 2 walks) and the
eikonal points go through the plain second-order `sdf_grad`.  The init is
drawn from a torch.Generator seeded 0, the crops and eikonal points from one
seeded 1, where the JAX script seeds its PRNGKeys.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from iron_tpu_torch import resolve_device
from iron_tpu_torch.core.camera import Camera, crop_camera, make_camera, resize_camera
from iron_tpu_torch.fields.sdf import (SDFConfig, SDFNetwork, init_sdf, sdf_grad, sdf_only,
                                       sdf_value_feat_grad)
from iron_tpu_torch.surface.render import SurfaceRenderConfig, render_camera

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "tests", "data_singleview")
PINK = (237.0 / 255.0, 61.0 / 255.0, 100.0 / 255.0)
BLOCK = 16          # steps a block (the JAX script's lax.scan)


def arg_parser() -> argparse.ArgumentParser:
    """The JAX script's flags, and --device."""
    p = argparse.ArgumentParser(description="Single-view silhouette optimization of the SDF.")
    p.add_argument("--iters", type=int, default=15000)
    p.add_argument("--patch", type=int, default=128)
    p.add_argument("--out_dir", default="./exp_singleview")
    p.add_argument("--log_every", type=int, default=500)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    return p


def load_view(data_dir: str = DATA) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """(photo [H, W, 3] in [0, 1], K, W2C, H, W) of view 12.png."""
    from iron_tpu_torch.data.io import read_image
    gt = read_image(os.path.join(data_dir, "12.png"))
    with open(os.path.join(data_dir, "cam_dict_norm.json")) as fh:
        cam = json.load(fh)["12.png"]
    K = np.asarray(cam["K"], np.float32).reshape(4, 4)
    W2C = np.asarray(cam["W2C"], np.float32).reshape(4, 4)
    W, H = cam["img_size"]
    return gt, K, W2C, H, W


def surface_config() -> SurfaceRenderConfig:
    """The JAX script's render configuration: no hole filling, edges on,
    1,024 edge candidates."""
    return SurfaceRenderConfig(fill_holes=False, handle_edges=True, edge_budget=1024)


def shade_fn(ray_o, ray_d, pts, normals, feats) -> Dict[str, torch.Tensor]:
    """The constant pink colour and the unit normal."""
    n = normals / (torch.linalg.norm(normals, dim=-1, keepdim=True) + 1e-10)
    color = torch.tensor(PINK, dtype=torch.float32, device=pts.device)
    return {"color": torch.broadcast_to(color, pts.shape[:-1] + (3,)), "normal": n}


def evaluators(net: SDFNetwork):
    """(sdf_fn, sdf_all_fn, walk_fn): the plain f32 trace evaluator, the
    shading core (K3 on a CUDA device, built now: under grad mode its result
    is differentiable through K3-bwd) and the plain f32 edge walk."""
    plain_all = lambda p: sdf_value_feat_grad(net, p)
    sdf_all_fn = plain_all
    if next(net.parameters()).is_cuda:
        from iron_tpu_torch.kernels.fused_sdf_grad import make_fused_sdf_grad_fn
        sdf_all_fn = make_fused_sdf_grad_fn(net)
    return (lambda p: sdf_only(net, p)), sdf_all_fn, plain_all


def render(net: SDFNetwork, cam: Camera, scfg: SurfaceRenderConfig,
           is_training: bool) -> Dict[str, torch.Tensor]:
    sdf_fn, sdf_all_fn, walk_fn = evaluators(net)
    return render_camera(sdf_fn, sdf_all_fn, shade_fn, cam, scfg, is_training=is_training,
                         trace_sdf_all_fn=walk_fn)


def singleview_loss(net: SDFNetwork, gt: torch.Tensor, base: Camera, ul_col: int, ul_row: int,
                    eik_pts: torch.Tensor, ps: int, scfg: SurfaceRenderConfig
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The loss of one crop (scripts/singleview_demo.py:68-93): MSE on the
    edge-mask pixels + 0.1 x the eikonal mean over the uniform points
    `eik_pts`, the shaded and walked pixels and the edge side points.
    Returns (loss, (img_loss, eik))."""
    cam = crop_camera(base, ul_col, ul_row, ps, ps)
    gt_crop = gt[ul_row:ul_row + ps, ul_col:ul_col + ps, :3]
    res = render(net, cam, scfg, is_training=True)
    mask = res["edge_mask"]
    m = mask[..., None].to(torch.float32)
    img_loss = torch.sum(((res["color"] - gt_crop) ** 2) * m) / torch.clamp(m.sum(), min=1.0)
    g1 = sdf_grad(net, eik_pts)
    all_mask = mask | res["convergent_mask"]
    e1 = (torch.linalg.norm(g1, dim=-1) - 1) ** 2
    e2 = (torch.linalg.norm(res["raw_grad"], dim=-1) - 1) ** 2 * all_mask
    e3 = ((torch.linalg.norm(res["edge_pos_neg_normal"], dim=-1) - 1) ** 2
          * res["edge_pos_neg_mask"])
    cnt = e1.numel() + all_mask.sum() + res["edge_pos_neg_mask"].sum()
    eik = (e1.sum() + e2.sum() + e3.sum()) / torch.clamp(cnt.to(torch.float32), min=1.0)
    return img_loss + 0.1 * eik, (img_loss, eik)


def train_block(net: SDFNetwork, opt: torch.optim.Optimizer, gt: torch.Tensor, base: Camera,
                gen: torch.Generator, ps: int, scfg: SurfaceRenderConfig, n: int = BLOCK):
    """`n` steps, each on a crop whose corner is drawn in [0, W - ps) x
    [0, H - ps) and on (ps^2 / 2) eikonal points drawn from U(-1, 1)^3,
    all from `gen` (the corners of the block in one draw, read back at
    once).  Returns the last step's (loss, (img_loss, eik)) as tensors."""
    dev = gt.device
    cols = torch.randint(0, base.W - ps, (n,), generator=gen, device=dev)
    rows = torch.randint(0, base.H - ps, (n,), generator=gen, device=dev)
    out = None
    for col, row in zip(cols.tolist(), rows.tolist()):
        eik_pts = torch.rand((ps * ps // 2, 3), generator=gen, device=dev) * 2 - 1
        opt.zero_grad(set_to_none=True)
        loss, aux = singleview_loss(net, gt, base, col, row, eik_pts, ps, scfg)
        loss.backward()
        opt.step()
        out = (loss.detach(), (aux[0].detach(), aux[1].detach()))
    return out


def validation_render(net: SDFNetwork, base: Camera, scfg: SurfaceRenderConfig
                      ) -> Dict[str, np.ndarray]:
    """The render of the whole view at a quarter of its resolution, without
    a graph, as numpy arrays."""
    with torch.no_grad():
        res = render(net, resize_camera(base, 0.25), scfg, is_training=False)
    return {k: v.cpu().numpy() for k, v in res.items() if isinstance(v, torch.Tensor)}


def mosaic(gt: np.ndarray, res: Dict[str, np.ndarray]) -> np.ndarray:
    """gt | render | normals | edge mask, each at a quarter of the
    resolution."""
    from iron_tpu_torch.utils.logging import concatenate_result
    normal = res["normal"]
    normal = normal / (np.linalg.norm(normal, axis=-1, keepdims=True) + 1e-10)
    return concatenate_result([gt[::4, ::4], res["color"], (normal + 1) / 2,
                               res["edge_mask"].astype(np.float32)], 4)


def silhouette_iou(hit_mask: np.ndarray, gt: np.ndarray) -> float:
    """IoU of the pixel-centre hit mask against the photo's nonzero region
    (the sum of its channels above 0.05) at a quarter of the resolution."""
    photo = gt[::4, ::4].sum(-1) > 0.05
    inter = (hit_mask & photo).sum()
    union = (hit_mask | photo).sum()
    return float(inter / max(union, 1))


def run(args, sdf_cfg: SDFConfig, device, data_dir: str = DATA) -> Dict:
    """The fit into args.out_dir (mosaics, then the checkpoint); prints the
    log lines and returns the final record (also printed as JSON)."""
    from iron_tpu_torch.data.io import write_image
    from iron_tpu_torch.eval.e2e_validation import device_record
    from iron_tpu_torch.fields.sdf import sdf_to_numpy
    from iron_tpu_torch.train.checkpoints import save_checkpoint

    dev = resolve_device(device)
    os.makedirs(args.out_dir, exist_ok=True)
    gt_np, K, W2C, H, W = load_view(data_dir)
    gt = torch.as_tensor(gt_np, device=dev)
    base = make_camera(K, W2C, H, W, device=dev)
    net = init_sdf(sdf_cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)
    scfg = surface_config()
    gen = torch.Generator(device=dev).manual_seed(1)

    t0 = time.time()
    step = 0
    while step < args.iters:
        loss, (il, el) = train_block(net, opt, gt, base, gen, args.patch, scfg)
        step += BLOCK
        if step % args.log_every < BLOCK:
            print(f"[{step}] loss={float(loss):.5f} img={float(il):.5f} "
                  f"eik={float(el):.5f} it/s={step / (time.time() - t0):.1f}", flush=True)
            write_image(os.path.join(args.out_dir, f"logim_{step:06d}.png"),
                        mosaic(gt_np, validation_render(net, base, scfg)))
    save_checkpoint(args.out_dir, step, sdf_to_numpy(net))
    res = validation_render(net, base, scfg)
    rec = {"iters": step, "iou": silhouette_iou(res["hit_mask"], gt_np),
           "wall_s": time.time() - t0, "device": device_record(dev)}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> Dict:
    args = arg_parser().parse_args(argv)
    return run(args, SDFConfig(), args.device)


if __name__ == "__main__":
    main()
