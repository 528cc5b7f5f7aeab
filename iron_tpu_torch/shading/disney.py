"""Disney-principled BRDF helpers, co-located (counterpart of
iron_tpu/shading/disney.py): the Schlick terms, the principled Fresnel
blend, the clearcoat lobe and the retro-reflective Disney diffuse, composed
into `disney_principled_colocated`, the renderer of the "disney" material
flavour (shading/materials.py).

All functions broadcast over leading dims; cos_theta is the single
co-located cosine (<n,v> = <n,l> = <n,h>).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from iron_tpu_torch.shading.brdf import (PLASTIC_ETA, _cos, _light_falloff,
                                         _table_diffuse)
from iron_tpu_torch.shading.fresnel import fresnel_dielectric, ggx_ndf, smith_g1


def _full(v, like: torch.Tensor) -> torch.Tensor:
    """v (a number or a tensor) broadcast to like's shape, as f32."""
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32, device=like.device),
                              like.shape)


def schlick_weight(cos_theta: torch.Tensor) -> torch.Tensor:
    """(1 - cos)^5."""
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return m ** 5


def schlick_r0_eta(eta: torch.Tensor) -> torch.Tensor:
    """Normal-incidence reflectance from the relative IOR."""
    return ((eta - 1.0) / (eta + 1.0)) ** 2


def calc_schlick(R0, cos_theta: torch.Tensor, eta) -> torch.Tensor:
    """Schlick approximation with the inside-the-surface branch.

    The reference clamps eta into [1e-4, 0.99999], treating the eta passed
    as already reciprocal; kept verbatim, as the JAX package keeps it."""
    eta = torch.clamp(_full(eta, cos_theta), 1e-4, 0.99999)
    rcp_eta = torch.clamp(1.0 / eta, 1e-4, 0.99999)
    outside = cos_theta > 0
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)

    cos_t_sqr = 1.0 - (1.0 - cos_theta * cos_theta) * eta_ti * eta_ti
    cos_t = torch.sqrt(torch.clamp(cos_t_sqr, min=0.0))
    val = schlick_weight(torch.abs(cos_theta)) * (1.0 - R0) + R0
    val_neq1 = schlick_weight(cos_t) * (1.0 - R0) + R0
    return torch.where(eta_it < 1.0, val_neq1, val)


def principled_fresnel(F_dielectric, metallic, spec_tint, base_color, intensity, cos_theta,
                       eta, has_metallic: bool = True,
                       has_spec_tint: bool = True) -> torch.Tensor:
    """Front-side principled Fresnel blend."""
    lum = intensity * torch.ones_like(cos_theta)
    F_schlick = torch.zeros_like(base_color)
    if has_metallic:
        F_schlick = F_schlick + metallic * calc_schlick(base_color, cos_theta, eta)
    if has_spec_tint:
        eta_b = _full(eta, cos_theta)
        rcp = 1.0 / eta_b
        eta_it = torch.where(cos_theta > 0, eta_b, rcp)
        c_tint = torch.where(lum > 0, base_color / torch.where(lum > 0, lum, 1.0), 1.0)
        F0_spec_tint = c_tint * schlick_r0_eta(eta_it)
        F_schlick = F_schlick + (1.0 - metallic) * spec_tint * \
            calc_schlick(F0_spec_tint, cos_theta, eta)
    return (1.0 - metallic) * (1.0 - spec_tint) * F_dielectric + F_schlick


def clearcoat_F(cos_theta: torch.Tensor, eta) -> torch.Tensor:
    """Clearcoat Fresnel: Schlick at R0 = 0.04."""
    return calc_schlick(0.04, cos_theta, eta)


def clearcoat_D(cos_theta: torch.Tensor, clearcoat: torch.Tensor) -> torch.Tensor:
    """Clearcoat GTR1-style NDF at roughness lerp(0.1, 0.001, clearcoat)."""
    dot = torch.clamp(cos_theta, 0.00001, 0.99999)
    cos2 = dot * dot
    v = (1.0 - clearcoat) * 0.1 + clearcoat * 0.001
    root = cos2 + (1.0 - cos2) / (v * v + 1e-10)
    return 1.0 / (math.pi * v * v * root * root + 1e-10)


def clearcoat_G(cos_theta: torch.Tensor, alpha_u: float = 0.25,
                alpha_v: float = 0.25) -> torch.Tensor:
    return smith_g1(cos_theta, alpha_u) * smith_g1(cos_theta, alpha_v)


def clearcoat_lobe(cos_theta: torch.Tensor, clearcoat: torch.Tensor, eta) -> torch.Tensor:
    """Secondary isotropic specular lobe."""
    Fcc = clearcoat_F(cos_theta, eta)
    Dcc = clearcoat_D(cos_theta, clearcoat)
    Gcc = clearcoat_G(cos_theta)
    return clearcoat * 0.25 * Fcc * Dcc * Gcc * torch.abs(cos_theta)


def disney_diffuse(cos_theta: torch.Tensor, alpha: torch.Tensor,
                   diffuse_albedo: torch.Tensor) -> torch.Tensor:
    """Disney retro-reflective diffuse."""
    alpha = torch.clamp(alpha, min=0.0001)
    F = schlick_weight(torch.abs(cos_theta))
    f_diff = (1.0 - 0.5 * F) * (1.0 - 0.5 * F)
    Rr = 2.0 * alpha * cos_theta * cos_theta
    f_retro = Rr * (F + F + F * F * (Rr - 1.0))
    return torch.abs(cos_theta) * diffuse_albedo / math.pi * (f_diff + f_retro)


def disney_principled_colocated(light, distance, normal, viewdir, params: Dict,
                                eta: float = PLASTIC_ETA,
                                use_ggx_table_diffuse: bool = False) -> Dict:
    """Co-located Disney-principled renderer: principled-Fresnel main
    specular + clearcoat + Disney diffuse (or the Mitsuba table diffuse).

    params: diffuse_albedo [.., 3], specular_albedo [.., 3],
    specular_roughness [.., 1], metallic [.., 1], spec_tint [.., 1],
    clearcoat [.., 1] (the last two default to 0)."""
    alpha = torch.clamp(params["specular_roughness"], min=0.0001)
    metallic = params["metallic"]
    spec_tint = params.get("spec_tint", torch.zeros_like(alpha))
    clearcoat = params.get("clearcoat", torch.zeros_like(alpha))
    base_color = params["diffuse_albedo"]

    cos = _cos(normal, viewdir)
    li = _light_falloff(light, distance)

    D = ggx_ndf(cos, alpha)
    G = smith_g1(cos, alpha) ** 2
    F_diel = fresnel_dielectric(cos, eta)
    lum = torch.mean(base_color, dim=-1, keepdim=True)
    F_p = principled_fresnel(F_diel, metallic, spec_tint, base_color, lum, cos, eta)
    main_spec = li * params["specular_albedo"] * F_p * D * G / (4.0 * torch.abs(cos))
    cc = li * clearcoat_lobe(cos, clearcoat, eta)

    if use_ggx_table_diffuse:
        diffuse = _table_diffuse(li, cos, alpha, base_color, eta=eta)
    else:
        diffuse = li * disney_diffuse(cos, alpha, base_color)
    diffuse = (1.0 - metallic) * diffuse

    specular = main_spec + cc
    return {"diffuse_rgb": diffuse, "specular_rgb": specular,
            "clearcoat_rgb": cc, "rgb": diffuse + specular}
