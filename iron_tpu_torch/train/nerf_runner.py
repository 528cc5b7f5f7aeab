"""The hash-grid NeRF runner, the `render_volume_tcnn.py` equivalent
(counterpart of iron_tpu/train/nerf_runner.py): a hash-grid NeRF trained
with a plain L1 colour loss over random ray batches, one Adam at the
warm-up + cosine schedule.

Scene switches:
  * use_background: the hash-grid NeRF, rendered alone by
    `nerf_density_render`;
  * use_foreground: a hash-grid SDF and rendering head rendered NeuS-style
    inside the unit sphere (`neus_render`, no importance rounds, the
    eikonal term at igr_weight), over the background NeRF when both are on;
  * use_envmap: a learnable equirectangular environment map as the
    residual-transmittance background.
The constructor raises when neither geometry switch is on.

Plain PyTorch throughout: the hash grid is no kernel in the JAX package
either.  Randomness is drawn on the device (`draw`, a Stage1Draws: the
image, the pixels, the per-ray jitter and the background jitter) and passed
to `train_step`, so that a check can inject JAX's draws.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from iron_tpu_torch import resolve_device
from iron_tpu_torch.data.dataset import RayDataset, near_far_from_sphere
from iron_tpu_torch.fields.hashgrid import (HashNeRFConfig, HashRenderingConfig,
                                            HashSDFConfig, hash_nerf_apply,
                                            hash_nerf_from_numpy, hash_nerf_to_numpy,
                                            hash_rendering_apply, hash_rendering_from_numpy,
                                            hash_rendering_to_numpy, hash_sdf_from_numpy,
                                            hash_sdf_only, hash_sdf_to_numpy,
                                            hash_sdf_value_feat_grad, init_hash_nerf,
                                            init_hash_rendering, init_hash_sdf)
from iron_tpu_torch.fields.scalars import (init_variance, variance_apply, variance_from_numpy,
                                           variance_to_numpy)
from iron_tpu_torch.train.schedules import warmup_cosine_schedule
from iron_tpu_torch.train.stage1 import Stage1Draws
from iron_tpu_torch.volume.integrator import (NeuSRenderConfig, nerf_density_render,
                                              neus_render)


@dataclass(frozen=True)
class NeRFRunnerConfig:
    nerf: HashNeRFConfig = field(default_factory=HashNeRFConfig)
    n_samples: int = 64
    learning_rate: float = 1e-2     # hash grids like large learning rates
    warm_up_end: int = 200
    end_iter: int = 20000
    batch_size: int = 1024
    use_white_bkgd: bool = False
    use_background: bool = True
    use_foreground: bool = False
    use_envmap: bool = False
    envmap_hw: tuple = (16, 32)
    sdf: HashSDFConfig = field(default_factory=HashSDFConfig)
    rendering: HashRenderingConfig = field(default_factory=HashRenderingConfig)
    variance_init: float = 0.3
    igr_weight: float = 0.1

    @property
    def neus(self) -> NeuSRenderConfig:
        """The foreground render: n_samples, no importance rounds, and
        max(n_samples // 2, 8) background samples over the NeRF when it is
        on."""
        return NeuSRenderConfig(n_samples=self.n_samples, n_importance=0,
                                n_outside=max(self.n_samples // 2, 8)
                                if self.use_background else 0)


def envmap_color(env: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Differentiable bilinear equirectangular lookup, z up: [B, 3] from
    env [He, We, 3]; the azimuth wraps."""
    He, We = env.shape[:2]
    d = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-10)
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    r = torch.clamp(theta / math.pi * He - 0.5, 0.0, He - 1.0)
    c = (phi + math.pi) / (2 * math.pi) * We - 0.5
    r0 = torch.floor(r).to(torch.int64)
    c0f = torch.floor(c)
    fr, fc = r - r0, c - c0f
    r1 = torch.clamp(r0 + 1, 0, He - 1)
    c0 = torch.remainder(c0f.to(torch.int64), We)
    c1 = torch.remainder(c0 + 1, We)
    v00, v01 = env[r0, c0], env[r0, c1]
    v10, v11 = env[r1, c0], env[r1, c1]
    fr, fc = fr[..., None], fc[..., None]
    return ((1 - fr) * ((1 - fc) * v00 + fc * v01)
            + fr * ((1 - fc) * v10 + fc * v11))


class EnvMap(nn.Module):
    """The learnable environment map [He, We, 3] (its |.| is looked up)."""

    def __init__(self, env: torch.Tensor):
        super().__init__()
        self.env = nn.Parameter(env)


def runner_params_to_numpy(params: nn.ModuleDict) -> Dict:
    """The JAX runner's parameter tree {"nerf", "sdf", "color", "variance",
    "envmap"} (the entries present) as numpy arrays."""
    to_np = {"nerf": hash_nerf_to_numpy, "sdf": hash_sdf_to_numpy,
             "color": hash_rendering_to_numpy, "variance": variance_to_numpy,
             "envmap": lambda m: m.env.detach().cpu().numpy()}
    return {k: to_np[k](m) for k, m in params.items()}


def runner_params_from_numpy(tree: Dict, device="cuda") -> nn.ModuleDict:
    """The port's runner parameters from a JAX runner tree."""
    from_np = {"nerf": hash_nerf_from_numpy, "sdf": hash_sdf_from_numpy,
               "color": hash_rendering_from_numpy, "variance": variance_from_numpy,
               "envmap": lambda t, dev: EnvMap(torch.tensor(np.asarray(t, np.float32),
                                                            device=dev))}
    return nn.ModuleDict({k: from_np[k](t, device) for k, t in tree.items()})


class HashNeRFTrainer:
    """Training of the hash-grid scene on one device: parameters drawn from
    `generator`, one Adam, `draw`, `train_step` and `run`."""

    def __init__(self, cfg: NeRFRunnerConfig, dataset: RayDataset,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        if not (cfg.use_background or cfg.use_foreground):
            # the envmap only adds a background emitter over a field
            raise ValueError("enable at least one of use_background/use_foreground "
                             "(use_envmap only adds a background emitter on top of them)")
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        if dataset.device.type != self.device.type:
            raise ValueError(f"the dataset lies on {dataset.device}, the trainer runs on "
                             f"{self.device}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = {}
        if cfg.use_background:
            params["nerf"] = init_hash_nerf(cfg.nerf, generator, self.device)
        if cfg.use_foreground:
            params["sdf"] = init_hash_sdf(cfg.sdf, generator, self.device)
            params["color"] = init_hash_rendering(cfg.rendering, generator, self.device)
            params["variance"] = init_variance(cfg.variance_init, self.device)
        if cfg.use_envmap:
            params["envmap"] = EnvMap(0.5 * torch.ones(tuple(cfg.envmap_hw) + (3,),
                                                       device=self.device))
        self.params = nn.ModuleDict(params)
        self.schedule = warmup_cosine_schedule(cfg.learning_rate, cfg.warm_up_end,
                                               cfg.end_iter)
        self.opt = self._adam()
        self.opt_count = 0        # optax's count: the updates applied so far
        self.step = 0

    def _adam(self) -> torch.optim.Adam:
        return torch.optim.Adam(self.params.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)

    def draw(self, generator: torch.Generator) -> Stage1Draws:
        """One step's random inputs, drawn on the device (no host sync): the
        image, the pixels, the per-ray jitter and, with a foreground over
        the background, the background jitter."""
        cfg, dev, ds = self.cfg, self.device, self.dataset
        B, (H, W) = cfg.batch_size, ds.hw
        d = Stage1Draws(
            img_idx=torch.randint(0, ds.n_images, (), generator=generator, device=dev),
            px=torch.randint(0, W, (B,), generator=generator, device=dev),
            py=torch.randint(0, H, (B,), generator=generator, device=dev),
            t_rand=torch.rand((B, 1), generator=generator, device=dev) - 0.5)
        if cfg.use_foreground and cfg.neus.n_outside > 0:
            d.t_rand_outside = torch.rand((B, cfg.neus.n_outside), generator=generator,
                                          device=dev)
        return d

    def loss(self, batch: torch.Tensor, draws: Stage1Draws):
        """(loss, metrics) of a ray batch [B, >= 9] = rays_o | rays_d | rgb."""
        cfg, p = self.cfg, self.params
        rays_o, rays_d, true_rgb = batch[:, :3], batch[:, 3:6], batch[:, 6:9]
        near, far = near_far_from_sphere(rays_o, rays_d)
        if cfg.use_envmap:
            bg = envmap_color(torch.abs(p["envmap"].env), rays_d)
        elif cfg.use_white_bkgd:
            bg = torch.ones((1, 3), device=batch.device)
        else:
            bg = None
        nerf_fn = None
        if cfg.use_background:
            nerf_fn = lambda pts, dirs: hash_nerf_apply(p["nerf"], cfg.nerf, pts, dirs)
        eik = 0.0
        if cfg.use_foreground:
            out = neus_render(
                rays_o, rays_d, near, far,
                sdf_fn=lambda x: hash_sdf_only(p["sdf"], x, cfg.sdf),
                sdf_all_fn=lambda x: hash_sdf_value_feat_grad(p["sdf"], x, cfg.sdf),
                color_fn=lambda pts, nrm, dirs, feat: hash_rendering_apply(
                    p["color"], cfg.rendering, pts, nrm, dirs, feat),
                inv_s=variance_apply(p["variance"]), nerf_fn=nerf_fn, cfg=cfg.neus,
                t_rand=draws.t_rand, t_rand_outside=draws.t_rand_outside,
                background_rgb=bg)
            color = out["color_fine"]
            eik = cfg.igr_weight * out["gradient_error"]
        else:
            color = nerf_density_render(rays_o, rays_d, near, far, nerf_fn, cfg.n_samples,
                                        background_rgb=bg, t_rand=draws.t_rand)["color"]
        loss = torch.mean(torch.abs(color - true_rgb)) + eik
        psnr = 20.0 * torch.log10(1.0 / torch.sqrt(torch.mean((color - true_rgb) ** 2) + 1e-12))
        return loss, {"loss": loss, "psnr": psnr}

    def train_step(self, draws: Stage1Draws) -> Dict[str, torch.Tensor]:
        """One step on the given draws: loss, backward, the Adam update at the
        schedule's learning rate.  Returns the metrics as tensors."""
        batch = self.dataset.gen_random_rays(draws.img_idx, self.cfg.batch_size, px=draws.px,
                                             py=draws.py)
        for g in self.opt.param_groups:
            g["lr"] = self.schedule(self.opt_count)
        self.opt.zero_grad(set_to_none=True)
        loss, metrics = self.loss(batch, draws)
        loss.backward()
        self.opt.step()
        self.opt_count += 1
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def run(self, num_iters: int, log_every: int = 0, seed: int = 0,
            history: Optional[list] = None) -> Dict[str, float]:
        """`num_iters` steps, the draws from a generator on the device seeded
        from `seed` and the step.  Returns the last step's metrics;
        `history`, if given, receives every step's metrics as device
        tensors."""
        gen = torch.Generator(device=self.device).manual_seed(seed * 1_000_003 + self.step)
        metrics = {}
        for _ in range(num_iters):
            metrics = self.train_step(self.draw(gen))
            if history is not None:
                history.append(metrics)
            if log_every and self.step % log_every == 0:
                print(f"[nerf {self.step}] " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in metrics.items()))
        return {k: float(v) for k, v in metrics.items()}
