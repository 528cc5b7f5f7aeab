"""The port's BRDF family against the JAX package on the CPU: the eight
co-located BRDFs on tests/test_brdf.py's random shading inputs, the Disney
helpers and renderer, the transmission tables, and the `multi` and
`disney` material flavours (network layouts, learning rates and point
shading at full width with transplanted weights)."""
import dataclasses

import numpy as np
import pytest
import torch
from torch import nn
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from test_brdf import _rand_shading
from iron_tpu.shading import brdf as jbrdf
from iron_tpu.shading import disney as jdis
from iron_tpu.shading import tables as jtab
from iron_tpu.shading.materials import init_material_networks as j_init_mats
from iron_tpu.shading.materials import material_lr_map as j_lr_map
from iron_tpu.shading.materials import renderer_network_configs as j_net_cfgs
from iron_tpu.shading.materials import shade_points as j_shade

from iron_tpu_torch.fields.rendering import rendering_from_numpy
from iron_tpu_torch.fields.scalars import init_point_light
from iron_tpu_torch.shading import brdf as tbrdf
from iron_tpu_torch.shading import disney as tdis
from iron_tpu_torch.shading import tables as ttab
from iron_tpu_torch.shading.materials import (material_lr_map, renderer_network_configs,
                                              shade_points)

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()
J = jnp.asarray
# tests/test_brdf.py's hold on the BRDFs against the reference
HOLD = dict(rtol=2e-4, atol=1e-5)

BRDFS = {"ggx": "ggx_colocated", "rough_plastic": "rough_plastic_colocated",
         "smooth_dielectric": "smooth_dielectric", "thin_dielectric": "thin_dielectric",
         "smooth_conductor": "smooth_conductor_colocated",
         "rough_conductor": "rough_conductor_colocated", "composite": "composite_colocated",
         "mixture": "mixture_colocated"}


def _args(seed=0):
    light, distance, normal, viewdir, params = _rand_shading(seed=seed)
    return ((T(light), T(distance), T(normal), T(viewdir), {k: T(v) for k, v in params.items()}),
            (light, J(distance), J(normal), J(viewdir), {k: J(v) for k, v in params.items()}))


@pytest.mark.parametrize("name", sorted(BRDFS))
def test_brdf_matches_jax(name):
    """Every output of each BRDF (the mixture's material_map too) at
    tests/test_brdf.py's hold."""
    targs, jargs = _args(seed=5 if name == "mixture" else 0)
    got = getattr(tbrdf, BRDFS[name])(*targs)
    ref = getattr(jbrdf, BRDFS[name])(*jargs)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(N(got[k]), np.asarray(ref[k]), err_msg=k, **HOLD)
    if name == "mixture":
        np.testing.assert_array_equal(N(got["material_map"]), np.asarray(ref["material_map"]))


@pytest.mark.parametrize("metal", ["Cu", "Au", "Al"])
def test_conductors_at_850nm_match_jax(metal):
    """CONDUCTOR_IOR_850NM as the JAX package gives it; both conductors at
    each metal's (eta, k)."""
    assert tbrdf.CONDUCTOR_IOR_850NM == jbrdf.CONDUCTOR_IOR_850NM
    eta, k = tbrdf.CONDUCTOR_IOR_850NM[metal]
    targs, jargs = _args(seed=2)
    for fn in ("smooth_conductor_colocated", "rough_conductor_colocated"):
        got = getattr(tbrdf, fn)(*targs, eta=eta, k=k)
        ref = getattr(jbrdf, fn)(*jargs, eta=eta, k=k)
        for key in ref:
            np.testing.assert_allclose(N(got[key]), np.asarray(ref[key]), err_msg=f"{fn} {key}",
                                       **HOLD)


def test_tables_bit_equal():
    np.testing.assert_array_equal(N(ttab.mts_trans_table(device="cpu")),
                                  np.asarray(jtab.mts_trans_table()))
    np.testing.assert_array_equal(N(ttab.mts_diff_trans_table(device="cpu")),
                                  np.asarray(jtab.mts_diff_trans_table()))
    assert ttab.mts_trans_table(device="cpu").shape == (5000,)
    assert ttab.mts_diff_trans_table(device="cpu").shape == (50,)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttab.mts_trans_table()


def _disney_inputs(seed=3, n=96):
    """Cosines on both sides of the surface (calc_schlick's inside branch)
    and near 0 and 1, base colours, the lobe weights and per-point etas."""
    g = np.random.default_rng(seed)
    cos = np.concatenate([g.uniform(-1, 1, n - 4), [1e-6, -1e-6, 0.99999, -0.99999]])[:, None]
    d = {"cos": cos, "pos": np.abs(cos) + 1e-3, "base": g.uniform(0.0, 1.0, (n, 3)),
         "metallic": g.uniform(0, 1, (n, 1)), "tint": g.uniform(0, 1, (n, 1)),
         "cc": g.uniform(0, 1, (n, 1)), "alpha": g.uniform(0.0, 0.9, (n, 1)),
         "eta": g.uniform(0.3, 2.5, (n, 1)), "F": g.uniform(0, 1, (n, 1))}
    d["lum"] = d["base"].mean(-1, keepdims=True)
    d["zero"] = np.zeros((n, 1))
    return {k: v.astype(np.float32) for k, v in d.items()}


# each helper of shading/disney.py on the inputs above (m: the module, d:
# the inputs as its array type)
DISNEY_HELPERS = {
    "schlick_weight": lambda m, d: m.schlick_weight(d["cos"]),
    "schlick_r0_eta": lambda m, d: m.schlick_r0_eta(d["eta"]),
    "calc_schlick": lambda m, d: m.calc_schlick(d["base"], d["cos"], 1.5),
    "calc_schlick_eta_tensor": lambda m, d: m.calc_schlick(0.04, d["cos"], d["eta"]),
    "principled_fresnel": lambda m, d: m.principled_fresnel(
        d["F"], d["metallic"], d["tint"], d["base"], d["lum"], d["cos"], 1.48958738),
    "principled_fresnel_zero_lum": lambda m, d: m.principled_fresnel(
        d["F"], d["metallic"], d["tint"], d["base"], d["zero"], d["cos"], d["eta"]),
    "principled_fresnel_no_tint": lambda m, d: m.principled_fresnel(
        d["F"], d["metallic"], d["tint"], d["base"], d["lum"], d["cos"], d["eta"],
        has_spec_tint=False),
    "clearcoat_F": lambda m, d: m.clearcoat_F(d["cos"], 1.5),
    "clearcoat_D": lambda m, d: m.clearcoat_D(d["cos"], d["cc"]),
    "clearcoat_G": lambda m, d: m.clearcoat_G(d["pos"]),
    "clearcoat_lobe": lambda m, d: m.clearcoat_lobe(d["cos"], d["cc"], 1.5),
    "disney_diffuse": lambda m, d: m.disney_diffuse(d["cos"], d["alpha"], d["base"]),
}


@pytest.mark.parametrize("helper", sorted(DISNEY_HELPERS))
def test_disney_helper_matches_jax(helper):
    d = _disney_inputs()
    got = DISNEY_HELPERS[helper](tdis, {k: T(v) for k, v in d.items()})
    ref = DISNEY_HELPERS[helper](jdis, {k: J(v) for k, v in d.items()})
    assert tuple(got.shape) == tuple(np.shape(ref))
    np.testing.assert_allclose(N(got), np.asarray(ref), **HOLD)


@pytest.mark.parametrize("table_diffuse", [False, True])
def test_disney_principled_matches_jax(table_diffuse):
    """disney_principled_colocated, with the Disney or the table diffuse, on
    tests/test_brdf.py's inputs with spec_tint and clearcoat added."""
    (tl, td, tn, tv, tp), (jl, jd, jn, jv, jp) = _args(seed=7)
    g = np.random.default_rng(8)
    for k in ("spec_tint", "clearcoat"):
        a = g.uniform(0, 1, size=(64, 1)).astype(np.float32)
        tp[k], jp[k] = T(a), J(a)
    got = tdis.disney_principled_colocated(tl, td, tn, tv, tp,
                                           use_ggx_table_diffuse=table_diffuse)
    ref = jdis.disney_principled_colocated(jl, jd, jn, jv, jp,
                                           use_ggx_table_diffuse=table_diffuse)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(N(got[k]), np.asarray(ref[k]), err_msg=k, **HOLD)


@pytest.mark.parametrize("renderer", ["multi", "disney"])
def test_flavour_networks_and_lrs_match_jax(renderer):
    cfgs, jcfgs = renderer_network_configs(renderer, 128), j_net_cfgs(renderer, 128)
    assert set(cfgs) == set(jcfgs)
    for k, c in cfgs.items():
        jc = dataclasses.asdict(jcfgs[k])
        assert {f: v for f, v in dataclasses.asdict(c).items() if f in jc} == jc, k
    assert material_lr_map(renderer) == j_lr_map(renderer)


@pytest.mark.parametrize("renderer", ["multi", "disney"])
def test_shade_points_matches_jax(renderer):
    """shade_points of the flavour at full width (256 features) with the
    JAX package's initial weights carried across: the same keys, and the
    values at the hold of tests/test_torch_shading.py (256-wide material
    nets summing in another order)."""
    params, jcfgs = j_init_mats(jax.random.PRNGKey(3), renderer)
    params = jax.tree_util.tree_map(np.asarray, params)
    cfgs = renderer_network_configs(renderer)
    nets = nn.ModuleDict({k: rendering_from_numpy(params[k], cfgs[k], "cpu") for k in cfgs})
    nets["point_light_network"] = init_point_light(
        float(params["point_light_network"]["light"]), device="cpu")

    g = np.random.default_rng(4)
    n = 96
    ray_o = np.broadcast_to(np.array([0, 0, 3.0], np.float32), (n, 3)).copy()
    pts = g.uniform(-0.6, 0.6, size=(n, 3)).astype(np.float32)
    ray_d = pts - ray_o
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    normals = g.normal(size=(n, 3)).astype(np.float32)
    feats = g.normal(size=(n, 256)).astype(np.float32)
    ref = j_shade(renderer, params, jcfgs, *map(J, (ray_o, ray_d, pts, normals, feats)))
    with torch.no_grad():
        got = shade_points(renderer, nets, cfgs, *map(T, (ray_o, ray_d, pts, normals, feats)))
    extra = {"multi": {"material_vector"},
             "disney": {"metallic", "spec_tint", "clearcoat", "clearcoat_rgb"}}[renderer]
    assert set(got) == set(ref) and extra <= set(got)
    for k in ref:
        assert got[k].shape == np.shape(ref[k]), k
        np.testing.assert_allclose(N(got[k]), np.asarray(ref[k]), rtol=1e-4, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("renderer", ["multi", "disney"])
def test_flavour_parameter_trees_round_trip_jax(renderer):
    """The JAX stage-2 tree of the flavour (a narrow SDF) carried across by
    params_from_numpy and back by params_to_numpy, bit for bit."""
    from iron_tpu.fields.sdf import SDFConfig as JSDFConfig
    from iron_tpu.train.stage2 import Stage2Config as JStage2Config
    from iron_tpu.train.stage2 import init_stage2_params as j_init_stage2
    from iron_tpu_torch.fields.sdf import SDFConfig
    from iron_tpu_torch.train.checkpoints import params_from_numpy, params_to_numpy
    narrow = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
    tree = jax.tree_util.tree_map(np.asarray, j_init_stage2(
        jax.random.PRNGKey(0), JStage2Config(renderer_name=renderer,
                                             sdf=JSDFConfig(**narrow)))[0])
    back = params_to_numpy(params_from_numpy(tree, "cpu", SDFConfig(**narrow), renderer))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("renderer", ["multi", "disney"])
def test_stage2_step_and_render_run_the_flavour(renderer):
    """Stage2Trainer with the flavour on the CPU at a narrow SDF: a finite
    training step without the comp-only eta losses, and render_full with the
    flavour's own buffers."""
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset
    from iron_tpu_torch.fields.sdf import SDFConfig
    from iron_tpu_torch.surface.render import SurfaceRenderConfig
    from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer
    d = render_synthetic_dataset("sphere", n_views=1, H=32, W=32, rig_kwargs={"focal": 40.0},
                                 device="cpu")
    cfg = Stage2Config(renderer_name=renderer, patch_size=16,
                       sdf=SDFConfig(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,),
                                     multires=4),
                       surface=SurfaceRenderConfig(edge_budget=64))
    tt = Stage2Trainer(cfg, d["images"], d["Ks"], d["W2Cs"], device="cpu",
                       generator=torch.Generator().manual_seed(1))
    m = tt.train_step(0, 8, 8, torch.rand((128, 3), generator=torch.Generator().manual_seed(2))
                      * 2 - 1)
    assert all(bool(torch.isfinite(v)) for v in m.values()) and float(m["mask_frac"]) > 0
    assert "metallicness_loss" not in m and "dielectricness_loss" not in m
    out = tt.render_full(0)
    own = {"multi": ["material_vector"],
           "disney": ["metallic", "spec_tint", "clearcoat", "clearcoat_rgb"]}[renderer]
    for k in own + ["color", "diffuse_color", "specular_color"]:
        assert k in out and out[k].shape[:2] == (32, 32) and np.isfinite(out[k]).all(), k
    assert out["color"][out["convergent_mask"] > 0].max() > 0
