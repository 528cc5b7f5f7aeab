"""Data-parallel and tensor-parallel training steps and renders
(counterpart of iron_tpu/dist/train.py).

Every rank holds the whole parameter tree; a step runs the port's
single-device loss on this rank's share of the work, then one coalesced
all-reduce over the dp axis carries every optimised parameter's gradient
(zeros where a rank's graph gave it none: every rank calls the same
collectives every step) and the step's metric sums, and every rank takes
the same optimiser step, so the parameters stay bit-equal across ranks.

  * stage 1 (`make_dp_stage1_step`): the rays of one global batch are split
    over the ranks.  The JAX step is the single-device step on the whole
    batch (pjit), so the port computes the global loss's gradient: the
    loss's normalisers (the mask sum, the eikonal count) are reduced over
    the ranks before it divides (`stage1_loss(reduce_sums=...)`), each rank
    backpropagates its share of the global loss, and the gradients are
    summed;
  * stage 2 (`make_dp_stage2_step`): each rank runs the exact single-device
    `stage2_loss` on its own crop and the gradients and metrics are averaged
    (shard_map + pmean in the JAX package); GroupAdam's clipping acts on the
    averaged gradients;
  * the renders split stage 1's rays, or stage 2's image rows as bands
    (`crop_camera`), and all-gather the results on every rank.

Unlike the JAX package, which turns its Pallas kernels off under dp
(`pallas_call` does not partition under pjit: normals_mode 'vjp',
upsample_pallas False), each rank here runs the config as given: K3-fwd and
K3-bwd on stage 1's core, K2 with upsample_pallas, and K1-K3 (K4 with
trace_pallas) on stage 2, as the single-device trainers do.

tp (stage 1 on a mesh with tp > 1, JAX's make_dp_stage1_step(tp_shard=
True)): Adam holds, for each leaf that `stage1_param_shardings` splits,
this rank's tp slice (`tp_shards`), and its moments only for that slice.
The step runs on the whole tree (the fused kernels take whole layers),
all-reduces the gradients over dp, gives each shard its slice of the
gradient, takes Adam's step on the shards and all-gathers them over tp
into the whole tree.  Adam works element by element, so the step is
bit-equal to the tp = 1 step on the same batch.  The stage-2 step and the
renders run over dp and are replicated over tp: the ranks of one tp group
pass the same crop.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from iron_tpu_torch.core.camera import crop_camera, make_camera
from iron_tpu_torch.dist.mesh import Mesh, shard_batch
from iron_tpu_torch.train.schedules import cos_anneal_ratio, warmup_cosine_schedule
from iron_tpu_torch.train.stage1 import (Stage1Config, Stage1Draws, build_stage1_fns,
                                         draw_stage1, set_lr, stage1_loss,
                                         stage1_render_color_normal)
from iron_tpu_torch.train.stage2 import Stage2Config, render_with_fns, stage2_loss


def stage1_param_shardings(params: nn.Module, mesh: Mesh, tp_shard: bool = True
                           ) -> Dict[str, Tuple]:
    """Each stage-1 parameter's partition spec by name, the JAX package's
    rule: with tp_shard, a [d_in, d_out] matrix whose d_out divides by tp
    and is at least 128 is split on its output axis, (None, "tp"), a vector
    of such a length on its only axis, ("tp",); anything else is replicated,
    ()."""
    tp = mesh.shape["tp"]

    def spec(x: torch.Tensor) -> Tuple:
        if tp_shard and x.ndim == 2 and x.shape[1] % tp == 0 and x.shape[1] >= 128:
            return (None, "tp")
        if tp_shard and x.ndim == 1 and x.shape[0] % tp == 0 and x.shape[0] >= 128:
            return ("tp",)
        return ()

    return {name: spec(p) for name, p in params.named_parameters()}


def tp_dims(params: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """Each stage-1 parameter's axis split over tp under
    stage1_param_shardings, by name; None for a leaf kept whole (every leaf
    when tp = 1)."""
    if mesh.shape["tp"] == 1:
        return {name: None for name, _ in params.named_parameters()}
    return {name: spec.index("tp") if "tp" in spec else None
            for name, spec in stage1_param_shardings(params, mesh).items()}


def tp_shards(params: nn.Module, mesh: Mesh) -> Dict[str, nn.Parameter]:
    """This rank's share of the stage-1 parameters, by name, for the Adam
    of make_dp_stage1_step: a leaf split over tp (tp_dims) becomes a new
    parameter holding this rank's tp slice of it; every other leaf is the
    module's own parameter."""
    out = {}
    for (name, p), d in zip(params.named_parameters(), tp_dims(params, mesh).values()):
        if d is None:
            out[name] = p
        else:
            k = p.shape[d] // mesh.shape["tp"]
            out[name] = nn.Parameter(p.detach().narrow(d, mesh.tp_rank * k, k).clone())
    return out


def _reduce_grads(leaves, mesh: Mesh, metrics: Dict[str, torch.Tensor],
                  average: bool) -> Dict[str, torch.Tensor]:
    """One all-reduce over dp (sum; with `average`, over dp's size) of the
    gradients of `leaves` and of the metrics; the results become the
    leaves' gradients.  A leaf without a gradient takes part with zeros and
    leaves with the reduced ones.  Returns the reduced metrics."""
    keys = sorted(metrics)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in leaves]
                     + [torch.stack([metrics[k].detach().to(torch.float32) for k in keys])])
    mesh.all_reduce_sum(flat)
    if average:
        flat.div_(mesh.shape["dp"])
    o = 0
    for p in leaves:
        p.grad = flat[o:o + p.numel()].view_as(p)
        o += p.numel()
    return dict(zip(keys, flat[o:].clone()))


def draw_dp_stage1(cfg: Stage1Config, dataset, generator: torch.Generator, mesh: Mesh
                   ) -> Tuple[torch.Tensor, Stage1Draws]:
    """(batch rows [B / D, 10], draws) of this rank: every rank draws the
    step's global Stage1Draws and ray batch and keeps its rows, so ranks
    whose generators are seeded alike split the very step a single device
    would take.  On per-host shards (RayDataset.from_folder(per_host_shard=
    True)) each rank draws from its own views."""
    d = draw_stage1(cfg, dataset, generator)
    batch = dataset.gen_random_rays(d.img_idx, cfg.batch_size, px=d.px, py=d.py)
    rows = lambda t: None if t is None else shard_batch(t, mesh)
    return shard_batch(batch, mesh), Stage1Draws(
        img_idx=d.img_idx, px=rows(d.px), py=rows(d.py), t_rand=rows(d.t_rand),
        t_rand_outside=rows(d.t_rand_outside), occ_u=rows(d.occ_u))


def make_dp_stage1_step(cfg: Stage1Config, mesh: Mesh) -> Callable:
    """(params, opt, batch [B / D, 10], step, draws) -> metrics: one
    stage-1 step on this rank's rows of the global batch, with this rank's
    rows of the draws (draw_dp_stage1), without the occupancy grid (as the
    JAX dp step).  The metrics are the global batch's (0-d tensors), the
    same on every rank.  opt is a torch.optim.Adam over
    tp_shards(params, mesh).values() (params.parameters() when
    tp = 1), in that order, as train.stage1.stage1_adam builds the
    trainer's (capturable on a CUDA device); its learning rate is the
    trainer's warm-up + cosine schedule at the count of updates Adam has
    applied (optax's count) and step sets the cos anneal, both computed as
    the trainer computes them (f32 on the device).  After the step params
    hold the whole updated tree on every rank."""
    schedule = warmup_cosine_schedule(cfg.learning_rate, cfg.warm_up_end, cfg.end_iter,
                                      cfg.learning_rate_alpha)

    def step_fn(params: nn.ModuleDict, opt: torch.optim.Adam, batch: torch.Tensor, step: int,
                draws: Stage1Draws) -> Dict[str, torch.Tensor]:
        named = list(params.named_parameters())
        shards = [q for g in opt.param_groups for q in g["params"]]
        dims = list(tp_dims(params, mesh).values())
        want = [tuple(p.shape[:d]) + (p.shape[d] // mesh.shape["tp"],) + tuple(p.shape[d + 1:])
                if d is not None else tuple(p.shape) for (_, p), d in zip(named, dims)]
        if [tuple(q.shape) for q in shards] != want:
            raise ValueError("the optimizer's parameters are not tp_shards(params, mesh) in "
                             "named_parameters order")
        st = opt.state.get(shards[0])
        dev = shards[0].device
        count = st["step"] if st else torch.zeros((), device=dev)
        set_lr(opt, schedule(count))
        opt.zero_grad(set_to_none=True)
        for _, p in named:
            p.grad = None
        step_t = torch.full((), step, dtype=torch.int64, device=dev)
        loss, shares = stage1_loss(params, cfg, batch, cos_anneal_ratio(step_t, cfg.anneal_end),
                                   t_rand=draws.t_rand, t_rand_outside=draws.t_rand_outside,
                                   reduce_sums=mesh.all_reduce_sum)
        loss.backward()
        metrics = _reduce_grads([p for _, p in named], mesh, shares, average=False)
        for (_, p), q, d in zip(named, shards, dims):
            if d is not None:
                k = q.shape[d]
                q.grad = p.grad.narrow(d, mesh.tp_rank * k, k).contiguous()
        opt.step()
        with torch.no_grad():
            for (_, p), q, d in zip(named, shards, dims):
                if d is not None:
                    p.copy_(mesh.all_gather(q.detach(), "tp", d))
        return metrics

    return step_fn


def make_dp_stage2_step(cfg: Stage2Config, mat_cfgs, mesh: Mesh, images=None, Ks=None,
                        W2Cs=None, per_shard_data: bool = False) -> Callable:
    """One stage-2 step on one crop a rank: each rank runs stage2_loss on
    its own crop and eikonal points, the gradients (every parameter of the
    GroupAdam) and the metrics are averaged over the ranks, and every rank
    takes the same GroupAdam step (its clipping on the averaged gradients).

    per_shard_data=False: the views [N, H, W, 3] (with Ks, W2Cs [N, 4, 4])
    are given here and held whole by every rank;
      (params, opt, img_idx, ul_col, ul_row, eik_pts) -> metrics.
    per_shard_data=True: each rank passes its own views at each call (from
    host_sharded_views) and a local view index;
      (params, opt, images, Ks, W2Cs, img_idx, ul_col, ul_row, eik_pts) -> metrics.
    eik_pts [(ps ps) / 2, 3] are this rank's uniform-cube eikonal points.
    The metrics (0-d tensors) are the ranks' mean, the same on every rank."""
    ps = cfg.patch_size

    def step_fn(params, opt, imgs, Ks_, W2Cs_, img_idx, ul_col, ul_row, eik_pts):
        H, W = imgs.shape[1:3]
        cam = crop_camera(make_camera(Ks_[img_idx], W2Cs_[img_idx], H, W, device=mesh.device),
                          ul_col, ul_row, ps, ps)
        gt = imgs[img_idx, ul_row:ul_row + ps, ul_col:ul_col + ps, :3]
        opt.zero_grad()
        loss, metrics = stage2_loss(params, mat_cfgs, cfg, cam, gt, eik_pts)
        loss.backward()
        adam = opt if isinstance(opt, torch.optim.Optimizer) else opt.opt    # GroupAdam's
        updated = {id(p) for g in adam.param_groups for p in g["params"]}
        metrics = _reduce_grads([p for _, p in params.named_parameters() if id(p) in updated],
                                mesh, metrics, average=True)
        opt.step()
        return metrics

    if per_shard_data:
        return step_fn
    images, Ks, W2Cs = host_sharded_views(images, Ks, W2Cs, mesh)
    return lambda params, opt, img_idx, ul_col, ul_row, eik_pts: step_fn(
        params, opt, images, Ks, W2Cs, img_idx, ul_col, ul_row, eik_pts)


def host_sharded_views(images, Ks, W2Cs, mesh: Mesh):
    """This rank's views for make_dp_stage2_step(per_shard_data=True):
    (images [n, H, W, 3] f32 on the mesh's device, Ks and W2Cs [n, 4, 4] f32
    on the host).  Each rank passes its own views and no rank holds the
    others'; local index i on a rank addresses its i-th view.  On one rank
    these are the whole stack."""
    return (torch.as_tensor(np.asarray(images, np.float32), device=mesh.device),
            np.asarray(Ks, np.float32), np.asarray(W2Cs, np.float32))


def make_dp_stage1_render(cfg: Stage1Config, mesh: Mesh) -> Callable:
    """(params, rays_o [N, 3], rays_d [N, 3]) -> (colour [N, 3], normal
    [N, 3]) on every rank: each rank renders its rows of the rays
    (stage1_render_color_normal in chunks of 1,024 rays, as
    Stage1Trainer.render_image does) and the rows are all-gathered.  N must
    divide by dp."""
    chunk = 1024

    def render(params, rays_o, rays_d):
        ro, rd = shard_batch(rays_o, mesh), shard_batch(rays_d, mesh)
        n = ro.shape[0]
        pad = (-n) % chunk
        ro = torch.cat([ro, torch.zeros((pad, 3), device=ro.device)])
        rd = torch.cat([rd, torch.ones((pad, 3), device=rd.device)])
        with torch.no_grad():
            fns = build_stage1_fns(params, cfg)
            local = torch.cat([torch.cat(stage1_render_color_normal(
                params, cfg, ro[i:i + chunk], rd[i:i + chunk], fns=fns), dim=-1)
                for i in range(0, ro.shape[0], chunk)])[:n]
        out = mesh.all_gather(local)
        return out[:, :3], out[:, 3:]

    return render


def make_dp_stage2_render(cfg: Stage2Config, mat_cfgs, mesh: Mesh, H: int, W: int
                          ) -> Callable:
    """(params, K [4, 4], W2C [4, 4]) -> {color, normal [H, W, 3], depth,
    convergent_mask [H, W]} on every rank: rank r renders rows
    [r H / D, (r + 1) H / D) through crop_camera with the trainer's
    evaluators (the kernels on a CUDA device), in eval mode on
    cfg.surface, and the bands are all-gathered.  The tracer's budgets are
    per call, so each band has its own (as in the JAX package); edges are
    detected within a band."""
    D = mesh.shape["dp"]
    if H % D:
        raise ValueError(f"image height {H} must divide by dp={D}")
    band = H // D

    def render(params, K, W2C):
        cam = crop_camera(make_camera(K, W2C, H, W, device=mesh.device), 0,
                          mesh.dp_rank * band, W, band)
        with torch.no_grad():
            res = render_with_fns(params, mat_cfgs, cfg, cam, cfg.surface)
        local = torch.cat([res["color"], res["normal"], res["depth"][..., None],
                           res["convergent_mask"].to(torch.float32)[..., None]], dim=-1)
        out = mesh.all_gather(local)
        return {"color": out[..., :3], "normal": out[..., 3:6], "depth": out[..., 6],
                "convergent_mask": out[..., 7]}

    return render
