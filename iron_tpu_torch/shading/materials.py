"""Material networks: per-renderer architectures, initialisation, material
queries and point shading (counterpart of iron_tpu/shading/materials.py).

Flavours: "ggx" (color / diffuse_albedo / specular_albedo /
specular_roughness), "multi" (those with the deeper diffuse net and the
4-way material_network of mixture_colocated), "comp" (the composite
stage-2 set of 10 nets; 8 are queried per shaded point, 9 with the env
light), "comp2" (its scale-0.1 heads) and "disney" (the ggx heads with
metallic / spec_tint / clearcoat heads, shaded by
disney.disney_principled_colocated).  The networks live in an
`nn.ModuleDict` keyed as the JAX parameter tree, with the point light under
"point_light_network".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from iron_tpu_torch.fields.rendering import (RenderingConfig, init_rendering,
                                             rendering_apply)
from iron_tpu_torch.fields.scalars import init_point_light, point_light_apply
from iron_tpu_torch.shading import brdf
from iron_tpu_torch.shading.disney import disney_principled_colocated


def _rn(d_in, d_out, n_layers=4, mode="idr", multires=0, multires_view=0,
        squeeze_out=True, output_bias=0.0, output_scale=1.0, skip_in=()):
    return RenderingConfig(d_feature=256, mode=mode, d_in=d_in, d_out=d_out,
                           d_hidden=256, n_layers=n_layers, multires=multires,
                           multires_view=multires_view, squeeze_out=squeeze_out,
                           output_bias=output_bias, output_scale=output_scale,
                           skip_in=skip_in)


_COLOR = _rn(9, 3, 4, "idr", 0, 4, True)
_SCALAR_HEAD = dict(n_layers=4, mode="no_view_dir", multires=6, squeeze_out=False)
_SPEC_ALBEDO = _rn(6, 3, output_bias=0.4, output_scale=0.1, **_SCALAR_HEAD)
_ROUGHNESS = _rn(6, 1, output_bias=0.1, output_scale=0.1, **_SCALAR_HEAD)
_COMP_SCALARS = ("specular_roughness_network", "metallic_network", "dielectric_network",
                 "metallic_eta_network", "metallic_k_network", "dielectric_eta_network")


def _base_configs(renderer_name: str) -> Dict[str, RenderingConfig]:
    if renderer_name == "ggx":
        return {
            "color_network": _COLOR,
            "diffuse_albedo_network": _rn(9, 3, 4, "idr", 0, 4, True),
            "specular_albedo_network": _SPEC_ALBEDO,
            "specular_roughness_network": _ROUGHNESS,
        }
    if renderer_name == "multi":
        return {
            "color_network": _COLOR,
            "diffuse_albedo_network": _rn(9, 3, 8, "idr", 10, 4, True, skip_in=(4,)),
            "specular_albedo_network": _SPEC_ALBEDO,
            "specular_roughness_network": _ROUGHNESS,
            "material_network": _rn(3, 4, 4, "points_only", 6, 0, False, 0.1, 0.1),
        }
    if renderer_name == "disney":
        cfg = _base_configs("ggx")
        for k in ("metallic_network", "spec_tint_network", "clearcoat_network"):
            cfg[k] = _ROUGHNESS
        return cfg
    if renderer_name == "comp":
        cfg = {
            "color_network": _COLOR,
            "diffuse_albedo_network": _rn(9, 3, 8, "idr", 10, 4, True, skip_in=(4,)),
            "specular_albedo_network": _rn(6, 3, output_bias=0.0, output_scale=1.0,
                                           **_SCALAR_HEAD),
            "env_light_network": _rn(3, 1, 4, "points_only", 6, 0, False, 0.0, 1.0),
        }
        for k in _COMP_SCALARS:
            cfg[k] = _rn(6, 1, output_bias=0.1, output_scale=1.0, **_SCALAR_HEAD)
        return cfg
    if renderer_name == "comp2":
        cfg = _base_configs("comp")
        cfg["diffuse_albedo_network"] = _rn(9, 3, 4, "idr", 0, 4, True)
        for k in _COMP_SCALARS:
            cfg[k] = _rn(6, 1, output_bias=0.1, output_scale=0.1, **_SCALAR_HEAD)
        return cfg
    raise ValueError(f"unknown renderer flavor {renderer_name}")


def renderer_network_configs(renderer_name: str,
                             d_feature: int = 256) -> Dict[str, RenderingConfig]:
    """Per-flavour material-net architectures; `d_feature` is the SDF
    feature width the nets consume."""
    cfgs = _base_configs(renderer_name)
    if d_feature != 256:
        cfgs = {k: dataclasses.replace(v, d_feature=d_feature) for k, v in cfgs.items()}
    return cfgs


def material_lr_map(renderer_name: str) -> Dict[str, float]:
    """Adam learning rate of each material network (1e-4) and of the point
    light (1e-2)."""
    lrs = {name: 1e-4 for name in renderer_network_configs(renderer_name)}
    lrs["point_light_network"] = 1e-2
    return lrs


def init_material_networks(renderer_name: str, generator: torch.Generator,
                           device="cuda", d_feature: int = 256
                           ) -> Tuple[nn.ModuleDict, Dict[str, RenderingConfig]]:
    cfgs = renderer_network_configs(renderer_name, d_feature)
    nets = nn.ModuleDict({name: init_rendering(cfg, generator, device)
                          for name, cfg in sorted(cfgs.items())})
    nets["point_light_network"] = init_point_light(device=device)
    return nets, cfgs


def _q(nets, cfgs, name, points, normals, view_dirs, features):
    return rendering_apply(nets[name], cfgs[name], points, normals, view_dirs, features)


def get_materials(nets, cfgs, points, normals, features, is_metal: bool = False) -> Dict:
    """ggx-flavour query."""
    diffuse = torch.abs(_q(nets, cfgs, "diffuse_albedo_network", points, normals, -normals,
                           features))
    specular = torch.abs(_q(nets, cfgs, "specular_albedo_network", points, normals, None,
                            features))
    if not is_metal:
        specular = torch.broadcast_to(specular.mean(dim=-1, keepdim=True), specular.shape)
    roughness = torch.abs(_q(nets, cfgs, "specular_roughness_network", points, normals, None,
                             features)) + 0.01
    return {"diffuse_albedo": diffuse, "specular_albedo": specular,
            "specular_roughness": roughness}


def get_materials_comp(nets, cfgs, points, normals, features) -> Dict:
    """Composite-flavour query: the diffuse albedo and 7 scalar heads."""
    out = {"diffuse_albedo": torch.abs(_q(nets, cfgs, "diffuse_albedo_network", points,
                                          normals, -normals, features))}
    for key, net in [("specular_albedo", "specular_albedo_network"),
                     ("metallic", "metallic_network"),
                     ("specular_roughness", "specular_roughness_network"),
                     ("dielectric", "dielectric_network"),
                     ("metallic_eta", "metallic_eta_network"),
                     ("metallic_k", "metallic_k_network"),
                     ("dielectric_eta", "dielectric_eta_network")]:
        out[key] = torch.abs(_q(nets, cfgs, net, points, normals, None, features))
    return out


def get_materials_disney(nets, cfgs, points, normals, features) -> Dict:
    """Disney-flavour query: the ggx materials and metallic / spec_tint /
    clearcoat, each clamped into [0, 1]."""
    out = get_materials(nets, cfgs, points, normals, features)
    for key, net in [("metallic", "metallic_network"),
                     ("spec_tint", "spec_tint_network"),
                     ("clearcoat", "clearcoat_network")]:
        out[key] = torch.clamp(torch.abs(_q(nets, cfgs, net, points, normals, None, features)),
                               0.0, 1.0)
    return out


def get_materials_multi(nets, cfgs, points, normals, features) -> Dict:
    """Mixture-flavour query: albedos, roughness and the 4-way material
    vector."""
    diffuse = torch.abs(_q(nets, cfgs, "diffuse_albedo_network", points, normals, -normals,
                           features))
    specular = torch.abs(_q(nets, cfgs, "specular_albedo_network", points, normals, None,
                            features))
    roughness = torch.abs(_q(nets, cfgs, "specular_roughness_network", points, normals, None,
                             features)) + 0.01
    mv = torch.abs(_q(nets, cfgs, "material_network", points, None, None, features))
    return {"diffuse_albedo": diffuse, "specular_albedo": specular,
            "specular_roughness": roughness, "material_vector": mv}


def shade_points(renderer_name: str, nets, cfgs, ray_o, ray_d, points, normals, features,
                 is_metal: bool = False, use_env_light: bool = False) -> Dict:
    """Query the materials and evaluate the flavour's BRDF for every point;
    the caller masks the result to the shaded set."""
    normals = normals / (torch.linalg.norm(normals, dim=-1, keepdim=True) + 1e-10)
    light = point_light_apply(nets["point_light_network"])
    distance = torch.linalg.norm(points - ray_o, dim=-1, keepdim=True)
    viewdir = -ray_d

    if renderer_name == "ggx":
        mats = get_materials(nets, cfgs, points, normals, features, is_metal)
        res = brdf.ggx_colocated(light, distance, normals, viewdir, mats)
    elif renderer_name == "multi":
        mats = get_materials_multi(nets, cfgs, points, normals, features)
        res = brdf.mixture_colocated(light, distance, normals, viewdir, mats)
    elif renderer_name == "disney":
        mats = get_materials_disney(nets, cfgs, points, normals, features)
        res = disney_principled_colocated(light, distance, normals, viewdir, mats)
    elif renderer_name in ("comp", "comp2"):
        mats = get_materials_comp(nets, cfgs, points, normals, features)
        if use_env_light:
            mats["env_light"] = torch.abs(_q(nets, cfgs, "env_light_network", points, None,
                                             None, features))
        res = brdf.composite_colocated(light, distance, normals, viewdir, mats,
                                       use_env_light=use_env_light)
    else:
        raise ValueError(renderer_name)

    out = {
        "color": res["rgb"],
        "diffuse_color": res["diffuse_rgb"],
        "specular_color": res["specular_rgb"],
        "normal": normals,
        "diffuse_albedo": mats["diffuse_albedo"],
        "specular_albedo": mats["specular_albedo"],
        "specular_roughness": mats["specular_roughness"][..., 0],
    }
    if renderer_name == "disney":
        out.update({
            "metallic": mats["metallic"][..., 0],
            "spec_tint": mats["spec_tint"][..., 0],
            "clearcoat": mats["clearcoat"][..., 0],
            "clearcoat_rgb": res["clearcoat_rgb"],
        })
    if renderer_name in ("comp", "comp2"):
        out.update({
            "metallic_rgb": res["metallic_rgb"],
            "dielectric_rgb": res["dielectric_rgb"],
            "metallic": mats["metallic"][..., 0],
            "dielectric": mats["dielectric"][..., 0],
            "metallic_eta": mats["metallic_eta"][..., 0],
            "metallic_k": mats["metallic_k"][..., 0],
            "dielectric_eta": mats["dielectric_eta"][..., 0],
        })
    if renderer_name == "multi":
        out["material_vector"] = mats["material_vector"]
    return out
