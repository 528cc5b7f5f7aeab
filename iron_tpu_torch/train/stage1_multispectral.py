"""Dual-spectrum (RGB + NIR) stage-1 training (counterpart of
iron_tpu/train/stage1_multispectral.py):

  * a shared SDF and variance, a colour network and a background NeRF per
    modality;
  * one Adam over the whole tree, at the warm-up + cosine schedule;
  * the curriculum: 'rgb' for rgb_iters steps, then 'nir' for nir_iters
    (base.end_iter each by default);
  * the cross-modality hand-off: an RGB checkpoint gives the SDF (and the
    RGB nets), an NIR checkpoint the NIR nets.

Each modality's step is the port's stage-1 step (`stage1_loss`) on a view
of the shared tree: {"sdf", "variance", "color": color_<m>, "nerf":
nerf_<m>}.  On a CUDA device it runs the render's SDF core through K3
(`build_stage1_fns`, built anew each step) and, with upsample_pallas, the
up-sample sweeps through K2.  The inactive modality's nets take zero
gradients, as JAX's adam over the whole tree gives them: their moments
decay and they move by momentum in the second phase (torch.optim.Adam
would skip a parameter whose gradient is None).  As in the JAX package the
occupancy grid is not used here.

Checkpoints follow the port's stage-1 convention: the JAX package's tree of
parameters, opt_state None and the Adam moments under extra["adam"].
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import torch
from torch import nn

from iron_tpu_torch import resolve_device
from iron_tpu_torch.data.dataset import RayDataset
from iron_tpu_torch.fields.nerf import init_nerf, nerf_from_numpy
from iron_tpu_torch.fields.rendering import (RenderingConfig, init_rendering,
                                             rendering_from_numpy)
from iron_tpu_torch.fields.scalars import init_variance, variance_from_numpy
from iron_tpu_torch.fields.sdf import init_sdf, sdf_from_numpy
from iron_tpu_torch.train.checkpoints import (latest_checkpoint, load_checkpoint,
                                              save_checkpoint)
from iron_tpu_torch.train.schedules import cos_anneal_ratio, warmup_cosine_schedule
from iron_tpu_torch.train.stage1 import (STAGE1_COLOR, Stage1Config, Stage1Draws,
                                         draw_stage1, stage1_loss, stage1_params_to_numpy)

MODALITIES = ("rgb", "nir")


@dataclass(frozen=True)
class MultiSpectralConfig:
    base: Stage1Config = field(default_factory=Stage1Config)
    nir_color: RenderingConfig = STAGE1_COLOR
    rgb_iters: Optional[int] = None   # default: base.end_iter
    nir_iters: Optional[int] = None   # default: base.end_iter more (2x in all)


def init_multispectral_params(cfg: MultiSpectralConfig, generator: torch.Generator,
                              device="cuda") -> nn.ModuleDict:
    """{"sdf", "variance", "color_rgb", "color_nir"[, "nerf_rgb",
    "nerf_nir"]}, drawn from `generator`."""
    base = cfg.base
    params = {"sdf": init_sdf(base.sdf, generator, device),
              "variance": init_variance(base.variance_init, device),
              "color_rgb": init_rendering(base.color, generator, device),
              "color_nir": init_rendering(cfg.nir_color, generator, device)}
    if base.render.n_outside > 0:
        params["nerf_rgb"] = init_nerf(base.nerf, generator, device)
        params["nerf_nir"] = init_nerf(base.nerf, generator, device)
    return nn.ModuleDict(params)


def multispectral_params_to_numpy(params: nn.ModuleDict, value=None) -> Dict:
    """The JAX multispectral tree of `params` as numpy arrays, or of value(p)
    for each parameter p (an optimizer moment, a gradient)."""
    return stage1_params_to_numpy(params, value)


def _net_from_numpy(key: str, tree: Dict, cfg: MultiSpectralConfig, device) -> nn.Module:
    """One top-level entry of the multispectral tree as the port's module."""
    base = cfg.base
    if key == "sdf":
        return sdf_from_numpy(tree, base.sdf, device)
    if key == "variance":
        return variance_from_numpy(tree, device)
    if key.startswith("color_"):
        return rendering_from_numpy(tree, base.color if key == "color_rgb" else cfg.nir_color,
                                    device)
    return nerf_from_numpy(tree, base.nerf, device)


def multispectral_params_from_numpy(tree: Dict, cfg: MultiSpectralConfig,
                                    device="cuda") -> nn.ModuleDict:
    """The port's multispectral parameters from a JAX multispectral tree."""
    keys = ["sdf", "variance", "color_rgb", "color_nir"]
    if cfg.base.render.n_outside > 0:
        keys += ["nerf_rgb", "nerf_nir"]
    return nn.ModuleDict({k: _net_from_numpy(k, tree[k], cfg, device) for k in keys})


def modality_view(params: nn.ModuleDict, modality: str) -> nn.ModuleDict:
    """The stage-1 tree of one modality, sharing the modules of `params`."""
    v = {"sdf": params["sdf"], "variance": params["variance"],
         "color": params[f"color_{modality}"]}
    if f"nerf_{modality}" in params:
        v["nerf"] = params[f"nerf_{modality}"]
    return nn.ModuleDict(v)


def _copy_in(module: nn.Module, fresh: nn.Module) -> None:
    """Copy fresh's parameters into module's, in place (the optimizer keeps
    its references)."""
    with torch.no_grad():
        for p, q in zip(module.parameters(), fresh.parameters(), strict=True):
            p.copy_(q.reshape(p.shape))


class MultiSpectralStage1Trainer:
    """RGB + NIR stage-1 training of one scene on one device: the shared
    tree (drawn from `generator`), one Adam, a step per modality, the
    phases, checkpoints and the cross-modality hand-off."""

    def __init__(self, cfg: MultiSpectralConfig, datasets: Dict[str, RayDataset],
                 generator: Optional[torch.Generator] = None, out_dir: Optional[str] = None,
                 device="cuda"):
        self.cfg = cfg
        self.datasets = datasets
        self.out_dir = out_dir
        self.device = resolve_device(device)
        for m, ds in datasets.items():
            if m not in MODALITIES:
                raise ValueError(f"unknown modality {m!r}: expected one of {MODALITIES}")
            if ds.device.type != self.device.type:
                raise ValueError(f"the {m} dataset lies on {ds.device}, the trainer runs on "
                                 f"{self.device}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.params = init_multispectral_params(cfg, generator, self.device)
        base = cfg.base
        self.schedule = warmup_cosine_schedule(base.learning_rate, base.warm_up_end,
                                               base.end_iter, base.learning_rate_alpha)
        self.opt = torch.optim.Adam(self.params.parameters(), lr=0.0, betas=(0.9, 0.999),
                                    eps=1e-8)
        self.opt_count = 0        # optax's count: the updates applied so far
        self.step = 0
        self.mod_cfgs = {"rgb": base, "nir": replace(base, color=cfg.nir_color)}

    def draw(self, modality: str, generator: torch.Generator) -> Stage1Draws:
        """One step's random inputs on the modality's dataset (no host sync)."""
        return draw_stage1(self.mod_cfgs[modality], self.datasets[modality], generator)

    def train_step(self, modality: str, draws: Stage1Draws) -> Dict[str, torch.Tensor]:
        """One step of `modality` on the given draws: the stage-1 loss on the
        modality's view, backward, zero gradients for the other modality's
        nets, the Adam update over the whole tree at the schedule's learning
        rate.  Returns the metrics as tensors."""
        cfg = self.mod_cfgs[modality]
        batch = self.datasets[modality].gen_random_rays(draws.img_idx, cfg.batch_size,
                                                        px=draws.px, py=draws.py)
        for g in self.opt.param_groups:
            g["lr"] = self.schedule(self.opt_count)
        self.opt.zero_grad(set_to_none=False)
        loss, metrics = stage1_loss(modality_view(self.params, modality), cfg, batch,
                                    cos_anneal_ratio(self.step, cfg.anneal_end),
                                    t_rand=draws.t_rand, t_rand_outside=draws.t_rand_outside)
        loss.backward()
        for p in self.params.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt.step()
        self.opt_count += 1
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def run_phase(self, modality: str, num_iters: int, log_every: int = 0, seed: int = 0,
                  history: Optional[list] = None) -> Dict[str, float]:
        """`num_iters` steps of `modality`, the draws from a generator on the
        device seeded from `seed` and the step.  Returns the last step's
        metrics; `history`, if given, receives every step's metrics as
        device tensors (no host sync)."""
        gen = torch.Generator(device=self.device).manual_seed(seed * 1_000_003 + self.step)
        metrics = {}
        for _ in range(num_iters):
            metrics = self.train_step(modality, self.draw(modality, gen))
            if history is not None:
                history.append(metrics)
            if log_every and self.step % log_every == 0:
                print(f"[stage1-{modality} {self.step}] " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in metrics.items()))
        return {k: float(v) for k, v in metrics.items()}

    def run_curriculum(self, log_every: int = 0, seed: int = 0) -> Dict[str, float]:
        """'rgb' for rgb_iters steps, then 'nir' for nir_iters when there is an
        NIR dataset."""
        base = self.cfg.base
        rgb_n = self.cfg.rgb_iters if self.cfg.rgb_iters is not None else base.end_iter
        nir_n = self.cfg.nir_iters if self.cfg.nir_iters is not None else base.end_iter
        m = self.run_phase("rgb", rgb_n, log_every, seed)
        if "nir" in self.datasets:
            m = self.run_phase("nir", nir_n, log_every, seed)
        return m

    def save(self) -> None:
        """`<out_dir>/ckpt_<step>.pkl`: the JAX multispectral tree, opt_state
        None and the Adam moments and count under extra["adam"]."""
        if not self.out_dir:
            return
        st = lambda key: (lambda p: self.opt.state[p][key] if p in self.opt.state
                          else torch.zeros_like(p))
        extra = {"adam": {"count": self.opt_count,
                          "mu": multispectral_params_to_numpy(self.params, st("exp_avg")),
                          "nu": multispectral_params_to_numpy(self.params, st("exp_avg_sq"))}}
        save_checkpoint(self.out_dir, self.step, multispectral_params_to_numpy(self.params),
                        None, extra=extra)

    def load_cross_modality(self, rgb_ckpt_dir: Optional[str] = None,
                            nir_ckpt_dir: Optional[str] = None) -> None:
        """The newest checkpoint of rgb_ckpt_dir gives the SDF (and the
        variance and RGB nets it holds), that of nir_ckpt_dir the NIR nets;
        pickles written by either package.  Copied into the parameters in
        place: the optimizer state stays."""
        def newest(d):
            path = latest_checkpoint(d) if d else None
            return load_checkpoint(path)["params"] if path else None

        tree = {}
        rgb, nir = newest(rgb_ckpt_dir), newest(nir_ckpt_dir)
        if rgb is not None:
            tree.update({k: rgb[k] for k in ("sdf", "variance", "color_rgb", "nerf_rgb")
                         if k in rgb})
        if nir is not None:
            tree.update({k: nir[k] for k in ("color_nir", "nerf_nir") if k in nir})
        for k, t in tree.items():
            if k in self.params:
                _copy_in(self.params[k], _net_from_numpy(k, t, self.cfg, "cpu"))
