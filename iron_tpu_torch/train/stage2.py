"""Stage 2: the sphere-traced surface render with material recovery
(counterpart of iron_tpu/train/stage2.py).

Ported so far: the configuration, parameter initialisation, the evaluator
set of `build_stage2_fns`, the plain evaluation render
`stage2_render_buffers`, and a `Stage2Trainer` that initialises or resumes
parameters and renders full frames (`render_full`).  Training (the loss,
the optimizer, `run`, `save`, validation) is not ported yet.

On a CUDA device `build_stage2_fns` routes the coarse march through K1, the
coarse fallback sweep through K2 and the shading-path SDF core through K3,
as the JAX package routes them through its Pallas kernels on a TPU; on the
CPU it uses the plain f32 functions, as the JAX package does there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from iron_tpu_torch import resolve_device
from iron_tpu_torch.core.camera import Camera, make_camera, resize_camera
from iron_tpu_torch.fields.sdf import SDFConfig, init_sdf, sdf_only, sdf_value_feat_grad
from iron_tpu_torch.kernels.fused_sdf import make_coarse_march_fn, make_sdf_only_bf16_fn
from iron_tpu_torch.kernels.fused_sdf_grad import make_fused_sdf_grad_fn
from iron_tpu_torch.shading.materials import init_material_networks, shade_points
from iron_tpu_torch.surface.render import (SurfaceRenderConfig, render_camera,
                                           scale_config_for_resolution)
from iron_tpu_torch.train.checkpoints import (latest_checkpoint, load_checkpoint,
                                              params_from_numpy)


@dataclass(frozen=True)
class Stage2Config:
    """The JAX package's Stage2Config, field for field with the same
    defaults (the training fields serve the trainer of a later slice)."""
    renderer_name: str = "comp"
    num_iters: int = 50001
    patch_size: int = 128
    eik_weight: float = 0.1
    ssim_weight: float = 1.0
    roughrange_weight: float = 0.1
    roughness_value: float = 0.5
    metal_eta_weight: float = 0.1
    metal_k_weight: float = 0.1
    dielectric_eta_weight: float = 0.1
    include_eta_priors: bool = False
    metal_eta_value: float = 1.0
    metal_k_value: float = 10.0
    is_metal: bool = False
    gamma_pred: bool = False
    inv_gamma_gt: bool = False
    init_light_scale: float = 8.0
    sdf_lr: float = 1e-5
    use_env_light: bool = False
    grad_clip: float = 0.0
    # the trace paths' precision: on a CUDA device 'high' and 'highest' are
    # both full f32 (the port never enables TF32)
    trace_precision: str = "high"
    eik_precision: str = "high"
    # None disables the coarse (bf16) phase of the tracer
    coarse_trace_precision: Optional[str] = "default"
    # coarse march and sweep through K1 / K2; the port has no other coarse
    # path on the card, so False raises there
    coarse_pallas: bool = True
    # shading-path SDF core through K3; False raises on the card, likewise
    shade_pallas: bool = True
    # accurate trace through the 3-pass kernel K4 (not ported yet: raises)
    trace_pallas: bool = False
    # bf16 material networks (not ported yet: raises)
    mat_bf16: bool = False
    silhouette_weight: float = 0.0
    silhouette_alpha: float = 50.0
    silhouette_samples: int = 32
    silhouette_budget: int = 1024
    surface: SurfaceRenderConfig = field(default_factory=SurfaceRenderConfig)
    sdf: SDFConfig = field(default_factory=SDFConfig)
    save_freq: int = 1000
    val_freq: int = 100
    async_ckpt: bool = False


def init_stage2_params(cfg: Stage2Config, generator: torch.Generator, device="cuda"
                       ) -> Tuple[nn.ModuleDict, Dict]:
    """({"sdf": SDFNetwork, "materials": ModuleDict}, material configs)."""
    sdf = init_sdf(cfg.sdf, generator, device)
    materials, mat_cfgs = init_material_networks(cfg.renderer_name, generator, device,
                                                 d_feature=cfg.sdf.d_out - 1)
    return nn.ModuleDict({"sdf": sdf, "materials": materials}), mat_cfgs


def init_light_from_cameras(W2Cs: np.ndarray, scale: float = 8.0) -> float:
    """scale * median(||camera origin||)^2."""
    dists = [np.linalg.norm(np.linalg.inv(w)[:3, 3]) for w in np.asarray(W2Cs)]
    d = float(np.median(dists))
    return scale * d * d


def build_stage2_fns(params: nn.ModuleDict, mat_cfgs, cfg: Stage2Config) -> Dict:
    """Evaluator closures for the surface pipeline: sdf / sdf_all, their
    trace variants, the coarse evaluators (K1, K2 on a CUDA device) and the
    shade closure.  Call under torch.no_grad() for a render."""
    sdf = params["sdf"]
    on_card = next(sdf.parameters()).is_cuda
    if cfg.mat_bf16:
        raise NotImplementedError("mat_bf16 (bf16 material networks) is not ported yet")
    if on_card and not (cfg.coarse_pallas and cfg.shade_pallas):
        raise NotImplementedError("on a CUDA device the coarse evaluators and the shading "
                                  "SDF core always run through their kernels "
                                  "(coarse_pallas and shade_pallas must stay True)")
    if on_card and cfg.trace_pallas:
        raise NotImplementedError("trace_pallas needs the 3-pass trace kernel, which is "
                                  "not ported yet")
    out = {
        "sdf_fn": lambda p: sdf_only(sdf, p),
        "sdf_all_fn": lambda p: sdf_value_feat_grad(sdf, p),
        "trace_sdf_fn": lambda p: sdf_only(sdf, p),
        "trace_sdf_all_fn": lambda p: sdf_value_feat_grad(sdf, p),
        "coarse_sdf_fn": None,
        "coarse_march_fn": None,
    }
    if on_card:
        out["sdf_all_fn"] = make_fused_sdf_grad_fn(sdf)
        if cfg.coarse_trace_precision is not None:
            out["coarse_sdf_fn"] = make_sdf_only_bf16_fn(sdf)
            out["coarse_march_fn"] = make_coarse_march_fn(
                sdf, threshold=cfg.surface.tracer.coarse_threshold)
    out["shade_fn"] = lambda ray_o, ray_d, pts, normals, feats: shade_points(
        cfg.renderer_name, params["materials"], mat_cfgs, ray_o, ray_d, pts, normals,
        feats, is_metal=cfg.is_metal, use_env_light=cfg.use_env_light)
    return out


def stage2_render_buffers(params: nn.ModuleDict, mat_cfgs, cfg: Stage2Config,
                          cam: Camera) -> Dict[str, torch.Tensor]:
    """The plain f32 evaluation render of one camera -> color / normal /
    depth / convergent_mask, [H, W, ...]."""
    sdf = params["sdf"]
    with torch.no_grad():
        res = render_camera(
            lambda p: sdf_only(sdf, p), lambda p: sdf_value_feat_grad(sdf, p),
            lambda ray_o, ray_d, pts, normals, feats: shade_points(
                cfg.renderer_name, params["materials"], mat_cfgs, ray_o, ray_d, pts,
                normals, feats, is_metal=cfg.is_metal, use_env_light=cfg.use_env_light),
            cam, cfg.surface)
    return {"color": res["color"], "normal": res["normal"], "depth": res["depth"],
            "convergent_mask": res["convergent_mask"].to(torch.float32)}


class Stage2Trainer:
    """Stage-2 state for one scene: parameters (initialised from
    `generator`, or resumed from `out_dir`) and the full-frame render."""

    def __init__(self, cfg: Stage2Config, images: np.ndarray, Ks: np.ndarray,
                 W2Cs: np.ndarray, generator: Optional[torch.Generator] = None,
                 out_dir: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.out_dir = out_dir
        self.device = resolve_device(device)
        if cfg.inv_gamma_gt:
            images = np.power(images, 2.2)
        self.images = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        self.Ks = np.asarray(Ks, np.float32)
        self.W2Cs = np.asarray(W2Cs, np.float32)
        self.H, self.W = images.shape[1:3]
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.params, self.mat_cfgs = init_stage2_params(cfg, generator, self.device)
        light = init_light_from_cameras(self.W2Cs, cfg.init_light_scale)
        with torch.no_grad():
            self.params["materials"]["point_light_network"].light.fill_(light)
        self.step = 0

    def resume(self) -> int:
        """Load the newest `ckpt_<step>.pkl` of out_dir (a JAX package
        checkpoint or one of the same schema); returns the step."""
        if self.cfg.async_ckpt:
            raise NotImplementedError("orbax checkpoints are not ported; resume reads "
                                      "the pickle checkpoints")
        if self.out_dir:
            path = latest_checkpoint(self.out_dir)
            if path:
                ck = load_checkpoint(path)
                self.params = params_from_numpy(ck["params"], self.device, self.cfg.sdf,
                                                self.cfg.renderer_name)
                self.step = ck["step"]
        return self.step

    def render_full(self, img_idx: int, factor: float = 1.0,
                    keys: Optional[Tuple[str, ...]] = None) -> Dict[str, np.ndarray]:
        """Full-frame evaluation render of view `img_idx` (its intrinsics
        scaled by `factor`); the edge budget scales with the resolution.
        Returns the buffers as numpy arrays, only `keys` if given."""
        cam = make_camera(self.Ks[img_idx], self.W2Cs[img_idx], self.H, self.W,
                          device=self.device)
        if factor != 1.0:
            cam = resize_camera(cam, factor)
        surf_cfg = scale_config_for_resolution(self.cfg.surface, cam.H, cam.W,
                                               train_patch=self.cfg.patch_size)
        with torch.no_grad():
            f = build_stage2_fns(self.params, self.mat_cfgs, self.cfg)
            res = render_camera(f["sdf_fn"], f["sdf_all_fn"], f["shade_fn"], cam, surf_cfg,
                                trace_sdf_fn=f["trace_sdf_fn"],
                                trace_sdf_all_fn=f["trace_sdf_all_fn"],
                                coarse_sdf_fn=f["coarse_sdf_fn"],
                                coarse_march_fn=f["coarse_march_fn"])
        return {k: v.cpu().numpy() for k, v in res.items()
                if isinstance(v, torch.Tensor) and (keys is None or k in keys)}
