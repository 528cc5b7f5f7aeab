"""Stage 2: the sphere-traced surface render with material recovery
(counterpart of iron_tpu/train/stage2.py).

Per step: a random patch crop (host numpy RNG) -> render_camera in training
mode (trace and edge walk without a graph, shading through the
implicit-function reparam, a differentiable edge uv) -> pyramid L2 + masked
SSIM, eikonal from three sources, the roughness hinge, the metal/dielectric
priors and the optional silhouette term -> backward -> one Adam per
parameter group.

On a CUDA device `build_stage2_fns` routes the coarse march through K1, the
coarse fallback sweep through K2, the shading-path SDF core through K3
(forward K3-fwd, backward K3-bwd) and, with `trace_pallas`, every accurate
trace evaluation through K4, as the JAX package routes them through its
Pallas kernels on a TPU; on the CPU it uses the plain f32 functions with
autograd, as the JAX package uses XLA there.  The uniform-cube eikonal term
runs on plain autograd (create_graph) on both, as in the JAX package, where
it is plain XLA.  `mat_bf16` runs the material networks in bf16 on both.

`async_ckpt` saves the same pickles on a background thread
(train/checkpoints.py::AsyncCheckpointer), where the JAX package uses orbax;
`resume` reads the JAX package's orbax saves too.  `run(steps_per_call >
1)` draws a chunk's crops on the device, as the JAX package's lax.scan over
steps does, and runs the chunk's steps eagerly: the tracer's masked loops
read a device value each iteration, so a stage-2 step is not captured as a
graph.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from iron_tpu_torch import resolve_device
from iron_tpu_torch.core.camera import Camera, crop_camera, make_camera, resize_camera
from iron_tpu_torch.core.rays import intersect_sphere
from iron_tpu_torch.fields.sdf import (SDFConfig, init_sdf, sdf_grad, sdf_only,
                                       sdf_value_feat_grad)
from iron_tpu_torch.kernels.fused_sdf import (make_coarse_march_fn, make_sdf_only_3pass_fn,
                                              make_sdf_only_bf16_fn)
from iron_tpu_torch.kernels.fused_sdf_grad import make_fused_sdf_grad_fn
from iron_tpu_torch.losses.image import pyramid_l2_loss, ssim_loss
from iron_tpu_torch.losses.regularizers import (dielectric_eta_loss, eikonal_loss,
                                                metal_eta_k_loss, roughness_range_loss)
from iron_tpu_torch.shading.materials import (init_material_networks, material_lr_map,
                                              shade_points)
from iron_tpu_torch.surface.render import (SurfaceRenderConfig, render_camera,
                                           scale_config_for_resolution)
from iron_tpu_torch.surface.tracer import budget_select, linspace01
from iron_tpu_torch.train.checkpoints import (AsyncCheckpointer, params_from_numpy,
                                              params_to_numpy, resume_checkpoint,
                                              save_checkpoint, stage1_to_stage2)


@dataclass(frozen=True)
class Stage2Config:
    """The JAX package's Stage2Config, field for field with the same
    defaults."""
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
    # every accurate no-grad trace evaluation (refine, stragglers, bisection,
    # fallback revalidation, edge-side traces, silhouette sweep) through the
    # 3-pass kernel K4 on a CUDA device; the plain f32 SDF on the CPU
    trace_pallas: bool = False
    # the material networks' products and activations in bf16
    # (RenderingConfig.compute_dtype), BRDF math in f32
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
    trace variants (trace_sdf through K4 on a CUDA device with
    trace_pallas; the edge walk's trace_sdf_all stays plain f32, as in the
    JAX package), the coarse evaluators (K1, K2 on a CUDA device) and the
    shade closure.  Call under torch.no_grad() for a render; built under
    grad mode, sdf_all on the card is differentiable through K3-bwd."""
    sdf = params["sdf"]
    on_card = next(sdf.parameters()).is_cuda
    if on_card and not (cfg.coarse_pallas and cfg.shade_pallas):
        raise NotImplementedError("on a CUDA device the coarse evaluators and the shading "
                                  "SDF core always run through their kernels "
                                  "(coarse_pallas and shade_pallas must stay True)")
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
        if cfg.trace_pallas:
            out["trace_sdf_fn"] = make_sdf_only_3pass_fn(sdf)
        if cfg.coarse_trace_precision is not None:
            out["coarse_sdf_fn"] = make_sdf_only_bf16_fn(sdf)
            out["coarse_march_fn"] = make_coarse_march_fn(
                sdf, threshold=cfg.surface.tracer.coarse_threshold)
    shade_cfgs = mat_cfgs
    if cfg.mat_bf16:
        shade_cfgs = {k: replace(v, compute_dtype="bfloat16")
                      for k, v in mat_cfgs.items()}
    out["shade_fn"] = lambda ray_o, ray_d, pts, normals, feats: shade_points(
        cfg.renderer_name, params["materials"], shade_cfgs, ray_o, ray_d, pts, normals,
        feats, is_metal=cfg.is_metal, use_env_light=cfg.use_env_light)
    return out


def render_with_fns(params: nn.ModuleDict, mat_cfgs, cfg: Stage2Config, cam: Camera,
                    surf_cfg: SurfaceRenderConfig, is_training: bool = False,
                    fns: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """render_camera of `cam` through the evaluators of build_stage2_fns
    (or the `fns` given)."""
    f = fns if fns is not None else build_stage2_fns(params, mat_cfgs, cfg)
    return render_camera(f["sdf_fn"], f["sdf_all_fn"], f["shade_fn"], cam, surf_cfg,
                         is_training=is_training, trace_sdf_fn=f["trace_sdf_fn"],
                         trace_sdf_all_fn=f["trace_sdf_all_fn"],
                         coarse_sdf_fn=f["coarse_sdf_fn"], coarse_march_fn=f["coarse_march_fn"])


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


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

class GroupAdam:
    """One Adam per parameter group, the counterpart of the JAX package's
    optax.multi_transform of optax.adam (b1 0.9, b2 0.999, eps 1e-8) with an
    optional clip_by_global_norm inside each group's chain.  A frozen group
    is left out and never updated."""

    def __init__(self, groups: Dict[str, Tuple[List[nn.Parameter], float]],
                 grad_clip: float = 0.0):
        self.grad_clip = float(grad_clip or 0.0)
        self.opt = torch.optim.Adam(
            [{"params": ps, "lr": lr, "name": name} for name, (ps, lr) in groups.items()],
            betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        if self.grad_clip > 0:
            for g in self.opt.param_groups:
                grads = [p.grad for p in g["params"] if p.grad is not None]
                if not grads:
                    continue
                norm = torch.sqrt(sum(torch.sum(t * t) for t in grads))
                # optax: t / norm * max_norm unless norm < max_norm
                factor = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                     self.grad_clip / norm)
                for t in grads:
                    t.mul_(factor)
        self.opt.step()


def make_optimizer(cfg: Stage2Config, params: nn.ModuleDict,
                   trainable: Optional[Dict[str, bool]] = None) -> GroupAdam:
    """Groups "sdf" (at sdf_lr) and "mat/<net>" for each material network
    and the light (material_lr_map); `trainable` freezes groups by name
    ("sdf" or a network's name)."""
    on = lambda name: trainable is None or trainable.get(name, True)
    lrs = material_lr_map(cfg.renderer_name)
    groups = {}
    if on("sdf"):
        groups["sdf"] = (list(params["sdf"].parameters()), cfg.sdf_lr)
    for name, net in params["materials"].items():
        if on(name):
            groups[f"mat/{name}"] = (list(net.parameters()), lrs[name])
    return GroupAdam(groups, cfg.grad_clip)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _gamma(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(x + 1e-6, 1.0 / 2.2)


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy."""
    return F.relu(logits) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _mask_disagreement(res: Dict, gt_mask: torch.Tensor):
    """(miss, excess, near, far): GT-covered pixels the render lost, render
    coverage beyond the GT mask, and each ray's span through the unit
    sphere."""
    hit = res["hit_mask"]
    gt = gt_mask > 0.5
    sph, min_dis, max_dis = intersect_sphere(res["ray_o"], res["ray_d"], r=1.0)
    return gt & ~hit & sph, hit & ~gt, min_dis, max_dis


def _silhouette_term(f: Dict, res: Dict, cfg: Stage2Config, gt_mask: torch.Tensor,
                     miss, excess, min_dis, max_dis) -> torch.Tensor:
    """The differentiable silhouette loss over mask / coverage
    disagreements: x* (the along-ray argmin of f for misses, the deeper of
    it and the hit point for excess pixels) is found without a graph; the
    single f(x*) carries the gradient into BCE(sigmoid(-alpha f), mask) /
    alpha, averaged over the (budget-capped) disagreeing pixels."""
    hit = res["hit_mask"]
    gt = gt_mask > 0.5
    disagree = miss | excess
    n_pix = hit.numel()
    K = min(cfg.silhouette_budget, n_pix)
    sel = budget_select(disagree.reshape(-1), K)
    valid = disagree.reshape(-1)[sel]
    ro = res["ray_o"].reshape(-1, 3)[sel]
    rd = res["ray_d"].reshape(-1, 3)[sel]
    mn, mx = min_dis.reshape(-1)[sel], max_dis.reshape(-1)[sel]
    hit_sel = hit.reshape(-1)[sel]
    with torch.no_grad():
        t = linspace01(cfg.silhouette_samples, ro.device)
        z = mn[:, None] + t * (mx - mn)[:, None]
        fv = f["trace_sdf_fn"](ro[:, None, :] + rd[:, None, :] * z[..., None])
        i_min = torch.argmin(fv, dim=-1, keepdim=True)
        f_min = torch.gather(fv, -1, i_min)[:, 0]
        z_min = torch.gather(z, -1, i_min)[:, 0]
        p_min = ro + rd * z_min[:, None]
        use_hit = hit_sel & (res["sdf"].reshape(-1)[sel] < f_min)
        x_star = torch.where(use_hit[:, None], res["points"].reshape(-1, 3)[sel], p_min)
    s_star = f["sdf_fn"](x_star)
    alpha = cfg.silhouette_alpha
    target = gt.reshape(-1)[sel].to(torch.float32)
    bce = _sigmoid_bce(-alpha * s_star, target) / alpha
    n = torch.clamp(valid.to(torch.float32).sum(), min=1.0)
    loss = torch.where(valid, bce, 0.0).sum() / n
    return loss * (disagree.any()).to(torch.float32)


def stage2_loss(params: nn.ModuleDict, mat_cfgs, cfg: Stage2Config, cam: Camera,
                gt_crop: torch.Tensor, eik_pts: torch.Tensor,
                gt_mask: Optional[torch.Tensor] = None,
                fns: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """The stage-2 loss of one crop and its metrics (tensors).  eik_pts
    [(H W) / 2, 3] are the uniform-cube eikonal points, drawn by the caller
    from U(-1, 1)^3.  `fns` replaces the evaluators of build_stage2_fns
    (a check that runs the step through other evaluators)."""
    f = fns if fns is not None else build_stage2_fns(params, mat_cfgs, cfg)
    res = render_with_fns(params, mat_cfgs, cfg, cam, cfg.surface, is_training=True, fns=f)
    color = res["color"]
    if cfg.gamma_pred:
        color = _gamma(color)
    mask = res["convergent_mask"]
    if cfg.surface.handle_edges:
        mask = mask | res["edge_mask"]
    any_mask = (mask.sum() > 0).to(torch.float32)

    pred = color.permute(2, 0, 1)[None]
    gt = gt_crop[..., :3].permute(2, 0, 1)[None]
    img_l2 = pyramid_l2_loss(pred, gt) * any_mask
    img_ssim = cfg.ssim_weight * ssim_loss(pred, gt, mask[None, None]) * any_mask
    img_loss = img_l2 + img_ssim

    # eikonal from three sources: the uniform cube (plain autograd, second
    # order), the shaded surface normals and the edge side normals
    e_sum, e_cnt = eikonal_loss(sdf_grad(params["sdf"], eik_pts))
    s_sum, s_cnt = eikonal_loss(res["raw_grad"], mask)
    e_sum, e_cnt = e_sum + s_sum, e_cnt + s_cnt
    if cfg.surface.handle_edges:
        p_sum, p_cnt = eikonal_loss(res["edge_pos_neg_normal"], res["edge_pos_neg_mask"])
        e_sum, e_cnt = e_sum + p_sum, e_cnt + p_cnt
    eik = e_sum / torch.clamp(e_cnt, min=1.0) * cfg.eik_weight

    rough = roughness_range_loss(res["specular_roughness"], mask,
                                 cfg.roughness_value) * cfg.roughrange_weight * any_mask
    loss = img_loss + eik + rough

    sil = None
    if gt_mask is not None:
        miss, excess, min_dis, max_dis = _mask_disagreement(res, gt_mask)
        n_miss, n_excess = miss.sum().to(torch.float32), excess.sum().to(torch.float32)
        if cfg.silhouette_weight > 0:
            sil = _silhouette_term(f, res, cfg, gt_mask, miss, excess, min_dis, max_dis)
            loss = loss + cfg.silhouette_weight * sil
        else:
            sil = torch.zeros((), device=loss.device)

    metrics = {"loss": loss, "img_loss": img_loss, "img_l2_loss": img_l2,
               "img_ssim_loss": img_ssim, "eik_loss": eik, "roughrange_loss": rough,
               "mask_frac": mask.to(torch.float32).mean()}
    if sil is not None:
        metrics.update({"silhouette_loss": sil, "mask_miss_count": n_miss,
                        "mask_excess_count": n_excess})
    if cfg.surface.handle_edges:
        metrics["edge_seed_count"] = res["edge_seed_count"].to(torch.float32)
        metrics["edge_seeds_dropped"] = res["edge_seeds_dropped"].to(torch.float32)
        metrics["edge_pixel_count"] = res["edge_mask"].to(torch.float32).sum()
    if cfg.renderer_name in ("comp", "comp2"):
        m_eta, m_k = metal_eta_k_loss(res["metallic_eta"], res["metallic_k"], mask,
                                      cfg.metal_eta_value, cfg.metal_k_value)
        metal = (m_eta * cfg.metal_eta_weight + m_k * cfg.metal_k_weight) * any_mask
        diel = dielectric_eta_loss(res["dielectric_eta"], mask) * \
            cfg.dielectric_eta_weight * any_mask
        metrics.update({"metallicness_loss": metal, "dielectricness_loss": diel})
        if cfg.include_eta_priors:
            loss = loss + metal + diel
            metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _shapes(tree) -> object:
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(np.shape(tree))


class Stage2Trainer:
    """Stage-2 training of one scene: parameters (initialised from
    `generator`, warm-started from `stage1_params`, or resumed from
    `out_dir`), one Adam per group, `run`, checkpoints and full-frame
    renders."""

    def __init__(self, cfg: Stage2Config, images: np.ndarray, Ks: np.ndarray,
                 W2Cs: np.ndarray, generator: Optional[torch.Generator] = None,
                 out_dir: Optional[str] = None, stage1_params: Optional[Dict] = None,
                 trainable: Optional[Dict[str, bool]] = None,
                 masks: Optional[np.ndarray] = None, device="cuda"):
        self.cfg = cfg
        self.out_dir = out_dir
        self.device = resolve_device(device)
        if cfg.inv_gamma_gt:
            images = np.power(images, 2.2)
        self.images = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        if masks is not None:
            m = np.asarray(masks, np.float32)
            if m.ndim == 4:
                m = m[..., 0]
            if m.shape[:3] != np.asarray(images).shape[:3]:
                raise ValueError(f"masks shape {m.shape[:3]} does not match images "
                                 f"{np.asarray(images).shape[:3]} (N, H, W must agree)")
            self.masks = torch.as_tensor(m, device=self.device)
        else:
            if cfg.silhouette_weight > 0:
                raise ValueError("silhouette_weight > 0 requires masks")
            self.masks = None
        self.Ks = np.asarray(Ks, np.float32)
        self.W2Cs = np.asarray(W2Cs, np.float32)
        self.H, self.W = images.shape[1:3]
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.params, self.mat_cfgs = init_stage2_params(cfg, generator, self.device)
        if stage1_params is not None:
            s1, s2 = _shapes(stage1_params["sdf"]), _shapes(params_to_numpy(self.params)["sdf"])
            if s1 != s2:
                raise ValueError(
                    "stage-1 SDF parameters do not match Stage2Config.sdf architecture: "
                    f"ckpt {s1} vs config {s2}. Pass the stage-1 run's SDFConfig as "
                    "Stage2Config.sdf.")
            tree = stage1_to_stage2(stage1_params, params_to_numpy(self.params))
            self.params = params_from_numpy(tree, self.device, cfg.sdf, cfg.renderer_name)
        light = init_light_from_cameras(self.W2Cs, cfg.init_light_scale)
        with torch.no_grad():
            self.params["materials"]["point_light_network"].light.fill_(light)
        self.trainable = trainable
        self.opt = make_optimizer(cfg, self.params, trainable)
        self.step = 0
        self.best_metric = float("-inf")
        self.best_step: Optional[int] = None
        self.val_history: list = []
        self._async: Optional[AsyncCheckpointer] = None

    def resume(self) -> int:
        """Load the newest checkpoint of out_dir (written by either
        package), as the JAX trainer resumes: with async_ckpt the newest
        orbax step first, else (or when there is none) the newest
        `ckpt_<step>.pkl`; returns the step.  The optimizer starts afresh,
        as the stage-2 checkpoints hold no optimizer state."""
        if self.out_dir:
            ck = resume_checkpoint(self.out_dir, orbax_first=self.cfg.async_ckpt)
            if ck is not None:
                self.params = params_from_numpy(ck["params"], self.device, self.cfg.sdf,
                                                self.cfg.renderer_name)
                self.opt = make_optimizer(self.cfg, self.params, self.trainable)
                self.step = ck["step"]
        return self.step

    def save(self) -> None:
        """`<out_dir>/ckpt_<step>.pkl` with the parameters (no optimizer
        state, as in the JAX package's stage 2); with async_ckpt written on a
        background thread from a host copy taken before this returns."""
        if not self.out_dir:
            return
        if self.cfg.async_ckpt:
            if self._async is None:
                self._async = AsyncCheckpointer(self.out_dir)
            self._async.save(self.step, self.params)
        else:
            save_checkpoint(self.out_dir, self.step, self.params)

    def wait_for_saves(self) -> None:
        """Join the async checkpoint in flight, if any (raises its error)."""
        if self._async is not None:
            self._async.wait()

    def _validate(self, val_fn) -> float:
        """Run `val_fn(self)` (a float metric, higher is better, or a dict
        with a 'metric' key); keep the best parameters as
        `<out_dir>/ckpt_best.pkl`."""
        rec = val_fn(self)
        if not isinstance(rec, dict):
            rec = {"metric": float(rec)}
        metric = float(rec["metric"])
        self.val_history.append({"step": self.step, **{k: float(v) for k, v in rec.items()}})
        if metric > self.best_metric:
            self.best_metric = metric
            self.best_step = self.step
            if self.out_dir:
                path = os.path.join(self.out_dir, "ckpt_best.pkl")
                payload = {"params": params_to_numpy(self.params), "opt_state": None,
                           "step": int(self.step), "extra": {"val": rec}}
                with open(path + ".tmp", "wb") as fh:
                    pickle.dump(payload, fh, protocol=4)
                os.replace(path + ".tmp", path)
        return metric

    def crop(self, img_idx: int, ul_col: int, ul_row: int):
        """(camera, gt [ps, ps, 3], gt mask or None) of one training crop."""
        ps = self.cfg.patch_size
        base = make_camera(self.Ks[img_idx], self.W2Cs[img_idx], self.H, self.W,
                           device=self.device)
        cam = crop_camera(base, ul_col, ul_row, ps, ps)
        gt = self.images[img_idx, ul_row:ul_row + ps, ul_col:ul_col + ps, :3]
        gt_mask = None
        if self.masks is not None:
            gt_mask = self.masks[img_idx, ul_row:ul_row + ps, ul_col:ul_col + ps]
        return cam, gt, gt_mask

    def train_step(self, img_idx: int, ul_col: int, ul_row: int,
                   eik_pts: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One step on one crop: loss, backward, the Adam update.  Returns
        the metrics as tensors; the gradients stay on the parameters until
        the next step."""
        cam, gt, gt_mask = self.crop(img_idx, ul_col, ul_row)
        self.opt.zero_grad()
        loss, metrics = stage2_loss(self.params, self.mat_cfgs, self.cfg, cam, gt, eik_pts,
                                    gt_mask)
        loss.backward()
        self.opt.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def run(self, num_iters: Optional[int] = None, log_every: int = 0, seed: int = 0,
            steps_per_call: int = 1, val_fn=None, val_every: int = 0,
            history: Optional[list] = None) -> Dict[str, float]:
        """Train `num_iters` steps (the rest of cfg.num_iters by default).
        One step a call draws its crop by the JAX package's host RNG
        formula; steps_per_call > 1 runs chunks of that many steps, each
        bounded so that the log, save and validation cadence falls on a
        chunk's end, with the chunk's crops (image in [0, n_imgs), corner in
        [0, max_col) x [0, max_row), JAX's bounds) drawn on the device in
        one [chunk, 3] draw from a torch.Generator seeded from `seed` and the
        step, and read back at once.  The eikonal points come from a
        torch.Generator seeded with seed + 1.  Returns the last step's
        metrics; `history`, if given, receives every step's metrics as
        device tensors."""
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be at least 1, got {steps_per_call}")
        n = num_iters if num_iters is not None else (self.cfg.num_iters - self.step)
        if val_fn is not None and not val_every:
            val_every = self.cfg.save_freq
        eik_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        n_imgs = self.images.shape[0]
        ps = self.cfg.patch_size
        max_col, max_row = max(self.W - ps, 1), max(self.H - ps, 1)
        n_eik = (ps * ps) // 2
        if steps_per_call == 1:
            g = np.random.default_rng((seed + 1) * 1_000_003 + self.step)
            crops = lambda k: [(int(g.integers(0, n_imgs)), int(g.integers(0, max_col)),
                                int(g.integers(0, max_row)))]
        else:
            crop_gen = torch.Generator(device=self.device).manual_seed(
                (seed + 1) * 1_000_003 + self.step)
            bounds = torch.tensor([n_imgs, max_col, max_row], device=self.device)
            crops = lambda k: (torch.randint(0, 1 << 31, (k, 3), generator=crop_gen,
                                             device=self.device) % bounds).tolist()
        metrics, done = {}, 0
        while done < n:
            chunk = min(steps_per_call, n - done)
            if log_every:
                chunk = min(chunk, log_every - self.step % log_every)
            if self.out_dir:
                chunk = min(chunk, self.cfg.save_freq - self.step % self.cfg.save_freq)
            if val_fn is not None:
                chunk = min(chunk, val_every - self.step % val_every)
            for idx, col, row in crops(chunk):
                eik_pts = torch.rand((n_eik, 3), generator=eik_gen, device=self.device) * 2 - 1
                metrics = self.train_step(idx, col, row, eik_pts)
                if history is not None:
                    history.append(metrics)
            done += chunk
            if log_every and self.step % log_every == 0:
                print(f"[stage2 {self.step}] " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in metrics.items()))
            if self.out_dir and self.step % self.cfg.save_freq == 0:
                self.save()
            if val_fn is not None and self.step % val_every == 0:
                self._validate(val_fn)
        return {k: float(v) for k, v in metrics.items()}

    def render_full(self, img_idx: int, factor: float = 1.0, is_training: bool = False,
                    keys: Optional[Tuple[str, ...]] = None) -> Dict[str, np.ndarray]:
        """Full-frame render of view `img_idx` (its intrinsics scaled by
        `factor`), without a graph; `is_training` renders the training
        path's forward.  The edge budget scales with the resolution.
        Returns the buffers as numpy arrays, only `keys` if given."""
        cam = make_camera(self.Ks[img_idx], self.W2Cs[img_idx], self.H, self.W,
                          device=self.device)
        if factor != 1.0:
            cam = resize_camera(cam, factor)
        surf_cfg = scale_config_for_resolution(self.cfg.surface, cam.H, cam.W,
                                               train_patch=self.cfg.patch_size)
        with torch.no_grad():
            res = render_with_fns(self.params, self.mat_cfgs, self.cfg, cam, surf_cfg,
                                  is_training=is_training)
        return {k: v.cpu().numpy() for k, v in res.items()
                if isinstance(v, torch.Tensor) and (keys is None or k in keys)}
