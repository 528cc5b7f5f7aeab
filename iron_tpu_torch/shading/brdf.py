"""Co-located camera+flash BRDF family (counterpart of
iron_tpu/shading/brdf.py): the const-Fresnel roughplastic `ggx_colocated`,
the exact-Fresnel `rough_plastic_colocated`, the smooth and thin
dielectrics, the smooth and rough conductors, their 4-way per-point
`mixture_colocated` and the fork's `composite_colocated`.

All take (light, distance, normal, viewdir, params) with normal and viewdir
pointing away from the surface; co-located, <n,v> = <n,l> = <n,h>, so each
BRDF is a function of one cosine.  Clamp constants are the reference's.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from iron_tpu_torch.shading.fresnel import (fresnel_conductor_exact, fresnel_dielectric,
                                            ggx_ndf, smith_g1)
from iron_tpu_torch.shading.tables import lookup_Fdr, lookup_T12

# conductor IOR (eta, k) at 850 nm
CONDUCTOR_IOR_850NM = {
    "Cu": (0.280000, 5.485625),
    "Au": (0.198125, 5.631250),
    "Al": (2.580000, 8.210000),
}

PLASTIC_ETA = 1.48958738  # IOR['polypropylene'] / IOR['air']


def _cos(normal, viewdir):
    dot = torch.sum(viewdir * normal, dim=-1, keepdim=True)
    return torch.clamp(dot, 0.00001, 0.99999)  # must be very precise; cannot be 0.999


def _light_falloff(light, distance):
    return light / (distance * distance + 1e-10)


def _table_diffuse(light_intensity, dot, alpha, diffuse_albedo, eta=PLASTIC_ETA):
    """Roughplastic internal-scattering diffuse term."""
    T12 = lookup_T12(dot, alpha)
    T21 = T12  # co-located
    Fdr = lookup_Fdr(alpha)
    inv_eta2 = 1.0 / (eta * eta)
    return (light_intensity * (diffuse_albedo / (1.0 - Fdr + 1e-10) / math.pi)
            * dot * T12 * T21 * inv_eta2)


def ggx_colocated(light, distance, normal, viewdir, params: Dict) -> Dict:
    """Constant-Fresnel roughplastic."""
    diffuse_albedo = params["diffuse_albedo"]
    specular_albedo = params["specular_albedo"]
    alpha = torch.clamp(params["specular_roughness"], min=0.0001)
    li = _light_falloff(light, distance)
    dot = _cos(normal, viewdir)

    D = ggx_ndf(dot, alpha)
    F = 0.03867
    G = smith_g1(dot, alpha) ** 2
    specular_rgb = li * specular_albedo * F * D * G / (4.0 * dot + 1e-10)
    diffuse_rgb = _table_diffuse(li, dot, alpha, diffuse_albedo)
    return {"diffuse_rgb": diffuse_rgb, "specular_rgb": specular_rgb,
            "rgb": diffuse_rgb + specular_rgb}


def rough_plastic_colocated(light, distance, normal, viewdir, params: Dict) -> Dict:
    """Exact-Fresnel roughplastic."""
    diffuse_albedo = params["diffuse_albedo"]
    specular_albedo = params["specular_albedo"]
    alpha = torch.clamp(params["specular_roughness"], min=0.0001)
    li = _light_falloff(light, distance)
    dot = _cos(normal, viewdir)

    D = ggx_ndf(dot, alpha)
    F = fresnel_dielectric(dot, PLASTIC_ETA)
    G = smith_g1(dot, alpha) ** 2
    specular_rgb = li * specular_albedo * F * D * G / (4.0 * dot + 1e-10)
    diffuse_rgb = _table_diffuse(li, dot, alpha, diffuse_albedo)
    return {"diffuse_rgb": diffuse_rgb, "specular_rgb": specular_rgb,
            "rgb": diffuse_rgb + specular_rgb}


def _lobes(li, diffuse_albedo, specular_rgb) -> Dict:
    """A specular lobe over the 1e-4 diffuse floor of the mirror BRDFs."""
    diffuse_rgb = li * diffuse_albedo * 0.0001
    return {"diffuse_rgb": diffuse_rgb, "specular_rgb": specular_rgb,
            "rgb": diffuse_rgb + specular_rgb}


def smooth_dielectric(light, distance, normal, viewdir, params: Dict) -> Dict:
    """Constant-F (0.04) mirror dielectric."""
    li = _light_falloff(light, distance)
    return _lobes(li, params["diffuse_albedo"], li * params["specular_albedo"] * 0.04)


def thin_dielectric(light, distance, normal, viewdir, params: Dict) -> Dict:
    """Thin-slab dielectric: R' = R + T^2 R / (1 - R^2) at R = 0.04."""
    li = _light_falloff(light, distance)
    R = 0.04
    T = 1 - R
    R = R + T * T * R / (1 - R * R)
    return _lobes(li, params["diffuse_albedo"], li * params["specular_albedo"] * R)


def smooth_conductor_colocated(light, distance, normal, viewdir, params: Dict,
                               eta: float = 2.58, k: float = 8.21) -> Dict:
    """Smooth conductor mirror, Al at 850 nm by default."""
    li = _light_falloff(light, distance)
    F = fresnel_conductor_exact(_cos(normal, viewdir), eta, k)
    return _lobes(li, params["diffuse_albedo"], li * params["specular_albedo"] * F)


def rough_conductor_colocated(light, distance, normal, viewdir, params: Dict,
                              eta: float = 2.58, k: float = 8.21) -> Dict:
    """Rough (GGX) conductor, Al at 850 nm by default."""
    alpha = torch.clamp(params["specular_roughness"], min=0.0001)
    li = _light_falloff(light, distance)
    dot = _cos(normal, viewdir)
    D = ggx_ndf(dot, alpha)
    F = fresnel_conductor_exact(dot, eta, k)
    G = smith_g1(dot, alpha) ** 2
    return _lobes(li, params["diffuse_albedo"],
                  li * params["specular_albedo"] * F * D * G / (4.0 * dot + 1e-10))


def mixture_colocated(light, distance, normal, viewdir, params: Dict) -> Dict:
    """4-way per-point blend by params["material_vector"], in the order
    [rough_plastic, smooth_dielectric, rough_conductor, smooth_conductor]."""
    mv = params["material_vector"]
    parts = [f(light, distance, normal, viewdir, params)
             for f in (rough_plastic_colocated, smooth_dielectric,
                       rough_conductor_colocated, smooth_conductor_colocated)]
    diffuse = sum(mv[..., i:i + 1] * p["diffuse_rgb"] for i, p in enumerate(parts))
    specular = sum(mv[..., i:i + 1] * p["specular_rgb"] for i, p in enumerate(parts))
    return {"diffuse_rgb": diffuse, "specular_rgb": specular,
            "rgb": diffuse + specular, "material_map": mv}


def composite_colocated(light, distance, normal, viewdir, params: Dict,
                        use_env_light: bool = False,
                        d_from_eta: bool = True) -> Dict:
    """Composite metallic + dielectric model.  `d_from_eta=True` keeps the
    reference's NDF evaluated at alpha := PLASTIC_ETA, as the JAX package
    does; False evaluates it at the roughness."""
    roughness = torch.clamp(params["specular_roughness"], min=0.00001)
    dielectric_eta = torch.clamp(params["dielectric_eta"], 1.000001, 1.999999)
    metallic_eta = torch.clamp(params["metallic_eta"], 0.099999, 4.999999)
    metallic_k = torch.clamp(params["metallic_k"], 0.099999, 9.999999)
    specular_albedo = torch.clamp(params["specular_albedo"], min=0.00001)
    diffuse_albedo = torch.clamp(params["diffuse_albedo"], min=0.00001)

    cos_i = _cos(normal, viewdir)
    d_alpha = torch.full_like(cos_i, PLASTIC_ETA) if d_from_eta else roughness
    D = ggx_ndf(cos_i, d_alpha)
    G = smith_g1(cos_i, roughness) * smith_g1(cos_i, roughness)

    if use_env_light:
        li = torch.clamp(params["env_light"], 0.000001, 20.0)
    else:
        li = _light_falloff(light, distance)

    F_metallic = fresnel_conductor_exact(cos_i, metallic_eta, metallic_k)
    F_dielectric = fresnel_dielectric(cos_i, dielectric_eta)

    main_metallic_rgb = li * specular_albedo * F_metallic
    main_dielectric_rgb = li * specular_albedo * F_dielectric * D * G / (4.0 * torch.abs(cos_i))
    main_specular_rgb = main_dielectric_rgb + main_metallic_rgb  # unweighted, as the reference

    diffuse_rgb = _table_diffuse(li, cos_i, torch.clamp(roughness, min=0.0001), diffuse_albedo)

    ret = {"diffuse_rgb": diffuse_rgb,
           "specular_rgb": main_specular_rgb,
           "metallic_rgb": main_metallic_rgb,
           "dielectric_rgb": main_dielectric_rgb,
           "rgb": diffuse_rgb + main_specular_rgb}
    if use_env_light:
        ret["env_light"] = li
    return ret
