"""Stage 1: NeuS volumetric SDF training (counterpart of
iron_tpu/train/stage1.py).

Per step: one random image, `batch_size` random pixels, near / far from the
unit sphere, the NeuS render with the cos anneal, loss = L1(colour) /
mask_sum + igr_weight * eikonal + mask_weight * BCE, one Adam over every
parameter (b1 0.9, b2 0.999, eps 1e-8) whose learning rate is set from the
warm-up + cosine schedule at optax's count before each update.  Checkpoints
are the JAX package's pickles, readable by both packages.

On a CUDA device `build_stage1_fns` routes the render's differentiable SDF
core through K3 (`normals_mode='pallas'`, the only mode on the card: K3-fwd
forward, K3-bwd backward) and, with `upsample_pallas`, the up-sample SDF
sweeps through K2; without it they run the f32 `sdf_only`, a plain product,
as the JAX package runs them outside Pallas.  On the CPU the core runs the
plain f32 functions with autograd, as the JAX package uses XLA there.
`remat_core` recomputes the colour network in the backward
(torch.utils.checkpoint).

Randomness is drawn on the device from a torch.Generator (`draw`): the
image, the pixels, the per-ray and background jitter and the
occupancy-guided samples' u, all passed to `train_step` as a Stage1Draws,
so that a check can inject other draws (JAX's).  The step's shapes are
static and its host code reads no device value: the learning rate and the
cos anneal are computed on the device, in f32 as the JAX package computes
them, from step counters held there, and on a CUDA device Adam is
`capturable` (its step counts on the device too).

`run` takes `steps_per_call` steps a call (16 by default, as the JAX
package's lax.scan): on a CUDA device one step (`draw` + the step) is
captured once as a torch.cuda.CUDAGraph, after one eager warm-up step, and
replayed once a step with no host work between replays; the occupancy grid
is refreshed at a chunk's start, as in the JAX package.  On the CPU a chunk
is a loop of `train_step` calls.

Checkpoints: `ckpt_<step>.pkl` pickles, written on a background thread
with `async_ckpt` (train/checkpoints.py::AsyncCheckpointer); `resume` also
reads the JAX package's orbax saves.  `interpolate_view_video` writes the
ping-pong novel-view video as MPEG-4 Part 2 (`mp4v`, data/video.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from iron_tpu_torch import resolve_device
from iron_tpu_torch.data.dataset import RayDataset, near_far_from_sphere
from iron_tpu_torch.data.video import write_mpeg4_video
from iron_tpu_torch.fields.nerf import NeRFConfig, init_nerf, nerf_apply, nerf_from_numpy
from iron_tpu_torch.fields.rendering import (RenderingConfig, init_rendering, rendering_apply,
                                             rendering_from_numpy)
from iron_tpu_torch.fields.scalars import init_variance, variance_apply, variance_from_numpy
from iron_tpu_torch.fields.sdf import (SDFConfig, init_sdf, sdf_from_numpy, sdf_only,
                                       sdf_value_feat_grad)
from iron_tpu_torch.kernels.fused_sdf import make_sdf_only_bf16_fn
from iron_tpu_torch.kernels.fused_sdf_grad import make_fused_sdf_grad_fn
from iron_tpu_torch.losses.regularizers import mask_bce_loss
from iron_tpu_torch.train.checkpoints import (AsyncCheckpointer, ScaleByAdamState,
                                              ScaleByScheduleState, resume_checkpoint,
                                              save_checkpoint)
from iron_tpu_torch.train.schedules import cos_anneal_ratio, warmup_cosine_schedule
from iron_tpu_torch.volume.integrator import NeuSRenderConfig, neus_render
from iron_tpu_torch.volume.occupancy import (OccupancyGridConfig, occupancy_guided_z,
                                             update_occupancy_grid)

# the stage-1 colour network (confs/womask_iron.conf rendering_network)
STAGE1_COLOR = RenderingConfig(d_feature=256, mode="idr", d_in=9, d_out=3, d_hidden=256,
                               n_layers=8, multires=10, multires_view=4, squeeze_out=True,
                               skip_in=(4,))


@dataclass(frozen=True)
class Stage1Config:
    """The JAX package's Stage1Config with the same defaults, less the
    fields nothing in the port reads: `upsample_precision` and
    `core_precision` (the port's products are f32, K3 at f32 class, except
    K2's bf16 under upsample_pallas).  `val_freq` and `report_freq` are read
    by the CLI (cli/train_volume.py)."""
    learning_rate: float = 5e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 100001
    batch_size: int = 512
    warm_up_end: int = 5000
    anneal_end: int = 50000
    use_white_bkgd: bool = False
    igr_weight: float = 0.1
    mask_weight: float = 0.0
    variance_init: float = 0.3
    save_freq: int = 10000
    val_freq: int = 500
    report_freq: int = 100
    # the up-sample SDF sweeps through K2 (bf16) on a CUDA device
    upsample_pallas: bool = False
    # occupancy-guided initial samples, the grid refreshed every
    # occupancy_update_every steps
    use_occupancy: bool = False
    occupancy_update_every: int = 256
    # 'pallas': the render's SDF core through K3 on a CUDA device (the only
    # mode there); on the CPU every mode is the plain f32 core with autograd
    normals_mode: str = "pallas"
    # recompute the colour network in the backward instead of keeping its
    # activations
    remat_core: bool = False
    async_ckpt: bool = False
    sdf: SDFConfig = field(default_factory=SDFConfig)
    nerf: NeRFConfig = field(default_factory=NeRFConfig)
    color: RenderingConfig = STAGE1_COLOR
    render: NeuSRenderConfig = field(default_factory=NeuSRenderConfig)


def init_stage1_params(cfg: Stage1Config, generator: torch.Generator,
                       device="cuda") -> nn.ModuleDict:
    """{"sdf", "color", "variance"[, "nerf" when the render has background
    samples]}, drawn from `generator`."""
    params = {"sdf": init_sdf(cfg.sdf, generator, device),
              "color": init_rendering(cfg.color, generator, device),
              "variance": init_variance(cfg.variance_init, device)}
    if cfg.render.n_outside > 0:
        params["nerf"] = init_nerf(cfg.nerf, generator, device)
    return nn.ModuleDict(params)


# ---------------------------------------------------------------------------
# the JAX parameter tree
# ---------------------------------------------------------------------------

def _jax_path(name: str):
    """The JAX tree path of a parameter of the port's stage-1 ModuleDict
    (nerf heads sit at the top of the NeRF's tree)."""
    return [int(k) if k.isdigit() else k for k in name.split(".") if k != "heads"]


def _tree(items) -> Dict:
    """A nested tree from (path, leaf) pairs; integer keys make lists."""
    root: Dict = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def stage1_params_to_numpy(params: nn.ModuleDict, value=None) -> Dict:
    """The JAX stage-1 parameter tree of `params` as numpy arrays, or of
    value(p) for each parameter p (an optimizer moment, a gradient)."""
    value = value or (lambda p: p)
    return _tree((_jax_path(n), np.asarray(value(p).detach().cpu().numpy(), np.float32))
                 for n, p in params.named_parameters())


def stage1_params_from_numpy(tree: Dict, cfg: Stage1Config, device="cuda") -> nn.ModuleDict:
    """The port's stage-1 parameters from a JAX stage-1 tree."""
    params = {"sdf": sdf_from_numpy(tree["sdf"], cfg.sdf, device),
              "color": rendering_from_numpy(tree["color"], cfg.color, device),
              "variance": variance_from_numpy(tree["variance"], device)}
    if cfg.render.n_outside > 0:
        params["nerf"] = nerf_from_numpy(tree["nerf"], cfg.nerf, device)
    return nn.ModuleDict(params)


# ---------------------------------------------------------------------------
# render and loss
# ---------------------------------------------------------------------------

def build_stage1_fns(params: nn.ModuleDict, cfg: Stage1Config) -> Dict:
    """The render's SDF evaluators {"sdf_fn", "sdf_all_fn"}: on a CUDA
    device K3 for the core (differentiable through K3-bwd when built under
    grad mode) and, with upsample_pallas, K2 for the up-sample sweeps; on
    the CPU the plain f32 functions."""
    sdf = params["sdf"]
    if next(sdf.parameters()).is_cuda:
        if cfg.normals_mode != "pallas":
            raise NotImplementedError("on a CUDA device the SDF core runs through its kernel "
                                      "(normals_mode must be 'pallas')")
        sdf_fn = (make_sdf_only_bf16_fn(sdf) if cfg.upsample_pallas
                  else (lambda p: sdf_only(sdf, p)))
        return {"sdf_fn": sdf_fn, "sdf_all_fn": make_fused_sdf_grad_fn(sdf)}
    return {"sdf_fn": lambda p: sdf_only(sdf, p),
            "sdf_all_fn": lambda p: sdf_value_feat_grad(sdf, p)}


def stage1_render(params: nn.ModuleDict, cfg: Stage1Config, rays_o, rays_d, near, far,
                  cos_anneal, background_rgb=None, perturb_overwrite: float = -1.0,
                  init_z=None, generator: Optional[torch.Generator] = None, t_rand=None,
                  t_rand_outside=None, fns: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """neus_render with the stage-1 networks; `fns` replaces the evaluators
    of build_stage1_fns (a check that runs the render through others)."""
    f = fns if fns is not None else build_stage1_fns(params, cfg)
    color_net = params["color"]

    def color_fn(pts, grads, dirs, feat):
        if cfg.remat_core and torch.is_grad_enabled():
            return checkpoint(rendering_apply, color_net, cfg.color, pts, grads, dirs, feat,
                              use_reentrant=False)
        return rendering_apply(color_net, cfg.color, pts, grads, dirs, feat)

    nerf_fn = None
    if cfg.render.n_outside > 0:
        nerf_fn = lambda pts4, dirs: nerf_apply(params["nerf"], cfg.nerf, pts4, dirs)
    return neus_render(rays_o, rays_d, near, far, sdf_fn=f["sdf_fn"],
                       sdf_all_fn=f["sdf_all_fn"], color_fn=color_fn,
                       inv_s=variance_apply(params["variance"]), nerf_fn=nerf_fn,
                       cfg=cfg.render, generator=generator, t_rand=t_rand,
                       t_rand_outside=t_rand_outside, background_rgb=background_rgb,
                       cos_anneal_ratio=cos_anneal, perturb_overwrite=perturb_overwrite,
                       init_z=init_z)


def stage1_loss(params: nn.ModuleDict, cfg: Stage1Config, batch: torch.Tensor,
                cos_anneal, t_rand=None, t_rand_outside=None,
                generator: Optional[torch.Generator] = None, occ_grid=None, occ_u=None,
                fns: Optional[Dict] = None,
                reduce_sums: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch [B, 10] = rays_o | rays_d | rgb | mask -> (loss, metrics), as
    tensors.  The jitter (t_rand, t_rand_outside) and the occupancy-guided
    samples' u (occ_u, with occ_grid) are the tensors given or are drawn
    from `generator`.

    `reduce_sums` sums a 1-D tensor over the ranks of a data-parallel step
    (dist/train.py); without it the sum is over this process alone.  The
    normalisers (the mask sum, the eikonal count, the rows) and the squared
    colour error go through it in one call, so with it, where batch is this
    rank's rows of the step's global batch, the loss and each metric are
    this rank's share: summed over the ranks they give the global batch's
    (psnr, the global batch's, times this rank's share of the rows).  On one
    process every share is the whole."""
    rays_o, rays_d = batch[:, :3], batch[:, 3:6]
    true_rgb, mask = batch[:, 6:9], batch[:, 9:10]
    near, far = near_far_from_sphere(rays_o, rays_d)
    background_rgb = torch.ones((1, 3), device=batch.device) if cfg.use_white_bkgd else None
    mask = (mask > 0.5).to(torch.float32) if cfg.mask_weight > 0.0 else torch.ones_like(mask)

    init_z = None
    if occ_grid is not None:
        init_z = occupancy_guided_z(occ_grid, OccupancyGridConfig(), rays_o, rays_d, near, far,
                                    cfg.render.n_samples, generator=generator, u=occ_u)
    out = stage1_render(params, cfg, rays_o, rays_d, near, far, cos_anneal, background_rgb,
                        init_z=init_z, generator=generator, t_rand=t_rand,
                        t_rand_outside=t_rand_outside, fns=fns)

    color_err = (out["color_fine"] - true_rgb) * mask
    rows = torch.full((), float(batch.shape[0]), device=batch.device)
    sums = torch.stack([torch.sum(mask), out["eik_count"], rows,
                        torch.sum(color_err ** 2)]).detach()
    if reduce_sums is not None:
        sums = reduce_sums(sums)
    mask_sum = sums[0] + 1e-5
    share = rows / sums[2]     # the means over rows: this rank's rows over all
    color_loss = torch.sum(torch.abs(color_err)) / mask_sum
    psnr = 20.0 * torch.log10(1.0 / torch.sqrt(sums[3] / (mask_sum * 3.0) + 1e-12))
    eik_loss = out["eik_sum"] / (sums[1] + 1e-5)
    m_loss = mask_bce_loss(out["weight_sum"], mask) * share
    loss = color_loss + eik_loss * cfg.igr_weight + m_loss * cfg.mask_weight
    metrics = {"loss": loss, "color_loss": color_loss, "eikonal_loss": eik_loss,
               "mask_loss": m_loss, "psnr": psnr * share,
               "s_val": torch.mean(out["s_val"]) * share,
               "cdf": torch.sum(out["cdf_fine"][:, :1] * mask) / mask_sum,
               "weight_max": torch.sum(out["weight_max"] * mask) / mask_sum}
    return loss, metrics


def stage1_render_color_normal(params: nn.ModuleDict, cfg: Stage1Config, rays_o, rays_d,
                               fns: Optional[Dict] = None):
    """Eval-mode render of a flat ray batch -> (colour [N, 3], normal [N, 3]):
    no jitter, the anneal at 1, the normal the weighted sum of the SDF
    gradients.  Call under torch.no_grad()."""
    near, far = near_far_from_sphere(rays_o, rays_d)
    out = stage1_render(params, cfg, rays_o, rays_d, near, far, 1.0, None,
                        perturb_overwrite=0.0, fns=fns)
    grads = out["gradients"]
    normal = torch.sum(grads * out["weights"][:, :grads.shape[1], None], dim=1)
    return out["color_fine"], normal


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def stage1_adam(params, device) -> torch.optim.Adam:
    """Stage 1's Adam (b1 0.9, b2 0.999, eps 1e-8) over `params`:
    capturable on a CUDA device (its step count on the device, a tensor
    learning rate read at each step), as the trainer and the dp step take
    it."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            capturable=torch.device(device).type == "cuda")


def set_lr(opt: torch.optim.Adam, lr: torch.Tensor) -> None:
    """Give Adam the learning rate `lr` (an f32 tensor): as it is when Adam
    is capturable, else as the host float of its value (a CPU tensor's)."""
    value = lr if opt.defaults["capturable"] else float(lr)
    for g in opt.param_groups:
        g["lr"] = value


@dataclass
class Stage1Draws:
    """The random inputs of one training step, on the device."""
    img_idx: torch.Tensor                 # 0-d int64, the image
    px: torch.Tensor                      # [B] int64, pixel columns
    py: torch.Tensor                      # [B] int64, pixel rows
    t_rand: Optional[torch.Tensor] = None          # [B, 1] in [-0.5, 0.5): per-ray jitter
    t_rand_outside: Optional[torch.Tensor] = None  # [B, n_outside] in [0, 1)
    occ_u: Optional[torch.Tensor] = None           # [B, n_samples] in [0, 1)


def draw_stage1(cfg: Stage1Config, dataset: RayDataset,
                generator: torch.Generator) -> Stage1Draws:
    """The random inputs of one step on `dataset`, drawn on its device from
    `generator` (no host sync)."""
    dev = dataset.device
    B, (H, W) = cfg.batch_size, dataset.hw
    u = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    d = Stage1Draws(
        img_idx=torch.randint(0, dataset.n_images, (), generator=generator, device=dev),
        px=torch.randint(0, W, (B,), generator=generator, device=dev),
        py=torch.randint(0, H, (B,), generator=generator, device=dev))
    if cfg.render.perturb > 0:
        d.t_rand = u(B, 1) - 0.5
        if cfg.render.n_outside > 0:
            d.t_rand_outside = u(B, cfg.render.n_outside)
    if cfg.use_occupancy:
        d.occ_u = u(B, cfg.render.n_samples)
    return d


@dataclass
class StepGraph:
    """A stage-1 step captured as a CUDA graph (Stage1Trainer.run_chunk):
    each replay draws from `generator` into `draws` and overwrites
    `metrics`."""
    graph: "torch.cuda.CUDAGraph"
    generator: torch.Generator
    metrics: Dict[str, torch.Tensor]
    draws: Stage1Draws


class Stage1Trainer:
    """Stage-1 training of one scene on one device: parameters (drawn from
    `generator`, or resumed from `out_dir`), one Adam, `run`, checkpoints and
    the validation renders."""

    def __init__(self, cfg: Stage1Config, dataset: RayDataset,
                 generator: Optional[torch.Generator] = None, out_dir: Optional[str] = None,
                 device="cuda"):
        self.cfg = cfg
        self.dataset = dataset
        self.out_dir = out_dir
        self.device = resolve_device(device)
        if self.device.type == "cuda" and cfg.normals_mode != "pallas":
            raise NotImplementedError("on a CUDA device the SDF core runs through its kernel "
                                      "(normals_mode must be 'pallas')")
        if dataset.device.type != self.device.type:
            raise ValueError(f"the dataset lies on {dataset.device}, the trainer runs on "
                             f"{self.device}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.params = init_stage1_params(cfg, generator, self.device)
        self.schedule = warmup_cosine_schedule(cfg.learning_rate, cfg.warm_up_end,
                                               cfg.end_iter, cfg.learning_rate_alpha)
        self.opt = self._adam()
        self.opt_count = 0        # optax's count: the updates applied so far
        self.step = 0
        # the step and optax's count on the device, set from the host values
        # before a step or a chunk's replays and advanced by the step itself
        self._counts = torch.zeros(2, dtype=torch.int64, device=self.device)
        self._occ_grid: Optional[torch.Tensor] = None
        self._async: Optional[AsyncCheckpointer] = None
        self._gen: Optional[torch.Generator] = None
        self._graph: Optional[StepGraph] = None

    def _adam(self) -> torch.optim.Adam:
        # the graph is of this optimizer's state: a new one needs a new capture
        self._graph = None
        return stage1_adam(self.params.parameters(), self.device)

    def _seed_adam(self, count: int, mu: Dict, nu: Dict) -> None:
        """Adam's state from an optax state: exp_avg = mu, exp_avg_sq = nu,
        step = count, each leaf at its parameter's path (the step on the
        device when Adam is capturable)."""
        step_dev = self.device if self.opt.defaults["capturable"] else "cpu"
        self._graph = None        # the state tensors a capture read are replaced
        for name, p in self.params.named_parameters():
            path = _jax_path(name)
            as_p = lambda tree: torch.as_tensor(np.asarray(_leaf(tree, path), np.float32),
                                                device=p.device).reshape(p.shape).clone()
            self.opt.state[p] = {"step": torch.tensor(float(count), device=step_dev),
                                 "exp_avg": as_p(mu), "exp_avg_sq": as_p(nu)}

    def warm_start(self, tree: Dict) -> None:
        """Take the parameters of a JAX stage-1 tree (of either package's
        checkpoint) and start a fresh Adam."""
        self.params = stage1_params_from_numpy(tree, self.cfg, self.device)
        self.opt = self._adam()
        self.opt_count = 0

    def resume(self) -> int:
        """Load the newest checkpoint of out_dir (written by either
        package), as the JAX trainer resumes: with async_ckpt the newest
        orbax step first, else (or when there is none) the newest
        `ckpt_<step>.pkl`.  The parameters, Adam's moments and count (from
        the JAX package's optax state, or from the port's own record) and
        the step."""
        if self.out_dir:
            ck = resume_checkpoint(self.out_dir, orbax_first=self.cfg.async_ckpt)
            if ck is not None:
                self.warm_start(ck["params"])
                adam = (ck.get("extra") or {}).get("adam")
                if ck.get("opt_state") is not None:
                    st = {type(s): s for s in ck["opt_state"]}
                    a = st[ScaleByAdamState]
                    adam = {"count": int(a.count), "mu": a.mu, "nu": a.nu,
                            "lr_count": int(st[ScaleByScheduleState].count)}
                if adam is not None:
                    self._seed_adam(adam["count"], adam["mu"], adam["nu"])
                    self.opt_count = adam.get("lr_count", adam["count"])
                self.step = int(ck["step"])
        return self.step

    def save(self) -> None:
        """`<out_dir>/ckpt_<step>.pkl` in the JAX package's stage-1 schema:
        the parameters and the field configs; opt_state None, which the JAX
        trainer's resume takes as a fresh optimizer, and the port's Adam
        moments under extra["adam"], which it does not read.  With
        async_ckpt the file is written on a background thread from a host
        copy taken before this returns."""
        if not self.out_dir:
            return
        st = lambda key: (lambda p: self.opt.state[p][key] if p in self.opt.state
                          else torch.zeros_like(p))
        extra = {"sdf_config": dataclasses.asdict(self.cfg.sdf),
                 "color_config": dataclasses.asdict(self.cfg.color),
                 "adam": {"count": self.opt_count,
                          "mu": stage1_params_to_numpy(self.params, st("exp_avg")),
                          "nu": stage1_params_to_numpy(self.params, st("exp_avg_sq"))}}
        params = stage1_params_to_numpy(self.params)
        if self.cfg.async_ckpt:
            if self._async is None:
                self._async = AsyncCheckpointer(self.out_dir)
            self._async.save(self.step, params, None, extra=extra)
        else:
            save_checkpoint(self.out_dir, self.step, params, None, extra=extra)

    def wait_for_saves(self) -> None:
        """Join the async checkpoint in flight, if any (raises its error)."""
        if self._async is not None:
            self._async.wait()

    def update_occupancy(self) -> None:
        """Refresh the occupancy grid from the current SDF (f32 sdf_only),
        in place once it exists (a captured step reads it where it lies)."""
        sdf = self.params["sdf"]
        grid = update_occupancy_grid(lambda p: sdf_only(sdf, p), OccupancyGridConfig(),
                                     self.device)
        if self._occ_grid is None:
            self._occ_grid, self._graph = grid, None
        else:
            self._occ_grid.copy_(grid)

    def draw(self, generator: torch.Generator) -> Stage1Draws:
        """One step's random inputs, drawn on the device (no host sync)."""
        return draw_stage1(self.cfg, self.dataset, generator)

    def _step(self, draws: Stage1Draws) -> Dict[str, torch.Tensor]:
        """The step on the device: the learning rate at optax's count and
        the anneal at the step, both from the device counters, the loss,
        backward, the Adam update, the counters advanced.  What a CUDA
        graph captures."""
        cfg = self.cfg
        batch = self.dataset.gen_random_rays(draws.img_idx, cfg.batch_size, px=draws.px,
                                             py=draws.py)
        set_lr(self.opt, self.schedule(self._counts[1]))
        self.opt.zero_grad(set_to_none=True)
        loss, metrics = stage1_loss(self.params, cfg, batch,
                                    cos_anneal_ratio(self._counts[0], cfg.anneal_end),
                                    t_rand=draws.t_rand, t_rand_outside=draws.t_rand_outside,
                                    occ_grid=self._occ_grid, occ_u=draws.occ_u)
        loss.backward()
        self.opt.step()
        self._counts.add_(1)
        return {k: v.detach() for k, v in metrics.items()}

    def _set_counts(self) -> None:
        """The device counters from the host's step and count (two fills,
        no host sync)."""
        self._counts[0].fill_(self.step)
        self._counts[1].fill_(self.opt_count)

    def train_step(self, draws: Stage1Draws) -> Dict[str, torch.Tensor]:
        """One step on the given draws: loss, backward, the Adam update at
        the schedule's learning rate.  Returns the metrics as tensors."""
        self._set_counts()
        metrics = self._step(draws)
        self.opt_count += 1
        self.step += 1
        return metrics

    def _capture(self, generator: torch.Generator, history: Optional[list]):
        """One eager warm-up step (a real step: the kernels built, their
        device queries cached, Adam's state made) on a side stream, then the
        step captured on that stream as a CUDA graph with `generator`
        registered, so that each replay draws anew.  Returns the warm-up
        step's metrics."""
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            metrics = self.train_step(self.draw(generator))
        torch.cuda.current_stream(dev).wait_stream(stream)
        if history is not None:
            history.append(metrics)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        self.opt.zero_grad(set_to_none=True)     # the gradients from the graph's pool
        self._set_counts()
        with torch.cuda.graph(graph, stream=stream):
            draws = self.draw(generator)
            static = self._step(draws)
        self._graph = StepGraph(graph, generator, static, draws)
        return metrics

    def run_chunk(self, n: int, generator: torch.Generator,
                  history: Optional[list] = None) -> Dict[str, torch.Tensor]:
        """n steps on draws from `generator`: on a CUDA device (n > 1) the
        captured step replayed n times (captured at the first call, or
        again for another generator or optimizer), else n train_step calls.
        Returns the last step's metrics as tensors; `history`, if given,
        receives every step's."""
        if self.device.type != "cuda" or n == 1:
            for _ in range(n):
                metrics = self.train_step(self.draw(generator))
                if history is not None:
                    history.append(metrics)
            return metrics
        if self._graph is None or self._graph.generator is not generator:
            metrics = self._capture(generator, history)
            n -= 1
        g = self._graph
        self._set_counts()
        for _ in range(n):
            g.graph.replay()
            metrics = {k: v.clone() for k, v in g.metrics.items()}
            if history is not None:
                history.append(metrics)
        self.opt_count += n
        self.step += n
        return metrics

    def _generator(self, seed: int) -> torch.Generator:
        """run's generator, seeded from `seed` and the step: one generator a
        trainer, re-seeded at each run (on a CUDA device the graph's,
        registered at its capture)."""
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
        return self._gen.manual_seed(seed * 1_000_003 + self.step)

    def run(self, num_iters: Optional[int] = None, log_every: int = 0, seed: int = 0,
            steps_per_call: int = 16, history: Optional[list] = None) -> Dict[str, float]:
        """Train `num_iters` steps (the rest of cfg.end_iter by default) in
        chunks of `steps_per_call` (run_chunk), each bounded so that the
        log and save cadence falls on a chunk's end, as the JAX package's
        chunked run.  The occupancy grid is refreshed at a chunk's start
        when one of its steps is due (step % occupancy_update_every <
        chunk).  The draws come from a generator on the device seeded from
        `seed` and the step.  Returns the last step's metrics; `history`,
        if given, receives every step's metrics as device tensors (no host
        sync)."""
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be at least 1, got {steps_per_call}")
        cfg = self.cfg
        n = num_iters if num_iters is not None else (cfg.end_iter - self.step)
        gen = self._generator(seed)
        metrics, done = {}, 0
        while done < n:
            chunk = min(steps_per_call, n - done)
            if log_every:
                chunk = min(chunk, log_every - self.step % log_every)
            if self.out_dir:
                chunk = min(chunk, cfg.save_freq - self.step % cfg.save_freq)
            chunk = max(chunk, 1)
            if cfg.use_occupancy and (self._occ_grid is None or
                                      self.step % cfg.occupancy_update_every < chunk):
                self.update_occupancy()
            metrics = self.run_chunk(chunk, gen, history)
            done += chunk
            if log_every and self.step % log_every == 0:
                print(f"[stage1 {self.step}] " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in metrics.items()))
            if self.out_dir and self.step % cfg.save_freq == 0:
                self.save()
        return {k: float(v) for k, v in metrics.items()}

    def interpolate_view_video(self, idx_0: int, idx_1: int, out_path: str,
                               n_frames: int = 60, resolution_level: int = 4,
                               fps: int = 30) -> None:
        """The ping-pong interpolation video of the JAX trainer
        (render_volume.py:815-848): n_frames novel views at ratios
        sin((i / n - 0.5) pi) / 2 + 1 / 2 between the two cameras, clipped
        to [0, 1] and cast to uint8, then the same frames reversed; written
        as cv2.VideoWriter's fourcc "mp4v" writes them, MPEG-4 Part 2 in
        .avi or .mp4 / .mov (data/video.py)."""
        frames = []
        for i in range(n_frames):
            ratio = np.sin(((i / n_frames) - 0.5) * np.pi) * 0.5 + 0.5
            img = self.render_novel_view(idx_0, idx_1, ratio, resolution_level)
            frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
        write_mpeg4_video(out_path, frames + frames[::-1], fps)

    def render_novel_view(self, idx_0: int, idx_1: int, ratio: float,
                          resolution_level: int = 4, chunk: int = 1024) -> np.ndarray:
        """Render from a pose slerp-interpolated between two cameras."""
        rays_o, rays_d = self.dataset.gen_rays_between(idx_0, idx_1, ratio, resolution_level)
        return self._render_rays_grid(rays_o, rays_d, chunk)["color"]

    def render_image(self, img_idx: int, resolution_level: int = 4, chunk: int = 1024,
                     fns: Optional[Dict] = None) -> Dict[str, np.ndarray]:
        """Chunked full-image validation render -> {"color", "normal"}
        [H // l, W // l, 3]."""
        rays_o, rays_d = self.dataset.gen_rays_grid(img_idx, resolution_level)
        return self._render_rays_grid(rays_o, rays_d, chunk, fns)

    def _render_rays_grid(self, rays_o, rays_d, chunk: int = 1024,
                          fns: Optional[Dict] = None) -> Dict[str, np.ndarray]:
        h, w = rays_o.shape[:2]
        ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        n = ro.shape[0]
        pad = (-n) % chunk
        ro = torch.cat([ro, torch.zeros((pad, 3), device=ro.device)])
        rd = torch.cat([rd, torch.ones((pad, 3), device=rd.device)])
        colors, normals = [], []
        with torch.no_grad():
            f = fns if fns is not None else build_stage1_fns(self.params, self.cfg)
            for i in range(0, ro.shape[0], chunk):
                c, nm = stage1_render_color_normal(self.params, self.cfg, ro[i:i + chunk],
                                                   rd[i:i + chunk], fns=f)
                colors.append(c)
                normals.append(nm)
        color = torch.cat(colors)[:n].reshape(h, w, 3)
        normal = torch.cat(normals)[:n].reshape(h, w, 3)
        return {"color": color.cpu().numpy(), "normal": normal.cpu().numpy()}
