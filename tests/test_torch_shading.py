"""The PyTorch port's shading against the JAX package on the CPU: the
Fresnel terms, the transmission tables, the co-located BRDFs and the point
shading of the comp, comp2 and ggx renderers with transplanted weights."""
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.shading import brdf as jbrdf
from iron_tpu.shading import fresnel as jfr
from iron_tpu.shading import tables as jtab
from iron_tpu.shading.materials import init_material_networks as j_init_mats
from iron_tpu.shading.materials import shade_points as j_shade

from iron_tpu_torch.shading import brdf as tbrdf
from iron_tpu_torch.shading import fresnel as tfr
from iron_tpu_torch.shading import tables as ttab
from iron_tpu_torch.shading.materials import renderer_network_configs, shade_points
from iron_tpu_torch.fields.rendering import rendering_from_numpy
from iron_tpu_torch.fields.scalars import init_point_light
from torch import nn

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()
J = jnp.asarray


def _rand_shading(n=64, seed=0):
    g = np.random.default_rng(seed)
    normal = g.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    v = g.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = np.where(np.sum(v * normal, axis=-1, keepdims=True) < 0, -v, v)
    params = {
        "diffuse_albedo": g.uniform(0.05, 0.9, size=(n, 3)),
        "specular_albedo": g.uniform(0.05, 0.9, size=(n, 3)),
        "specular_roughness": g.uniform(0.02, 0.8, size=(n, 1)),
        "metallic_eta": g.uniform(0.2, 4.5, size=(n, 1)),
        "metallic_k": g.uniform(0.2, 9.0, size=(n, 1)),
        "dielectric_eta": g.uniform(1.01, 1.9, size=(n, 1)),
        "env_light": g.uniform(0.0, 25.0, size=(n, 1)),
    }
    params = {k: v_.astype(np.float32) for k, v_ in params.items()}
    distance = g.uniform(0.5, 3.0, size=(n, 1)).astype(np.float32)
    return np.float32(20.0), distance, normal.astype(np.float32), v.astype(np.float32), params


# f32 transcendentals (sqrt, hypot, pow) of libm and XLA differ by an ulp or two
TOL = dict(rtol=2e-5, atol=1e-6)


def test_fresnel_terms_match_jax():
    g = np.random.default_rng(1)
    cos = g.uniform(-1, 1, size=(256, 1)).astype(np.float32)
    alpha = g.uniform(0.01, 1.0, size=(256, 1)).astype(np.float32)
    eta = g.uniform(1.01, 1.9, size=(256, 1)).astype(np.float32)
    k = g.uniform(0.2, 9.0, size=(256, 1)).astype(np.float32)
    pos = np.abs(cos) + 1e-3
    np.testing.assert_allclose(N(tfr.smith_g1(T(pos), T(alpha))),
                               np.asarray(jfr.smith_g1(J(pos), J(alpha))), **TOL)
    np.testing.assert_allclose(N(tfr.ggx_ndf(T(pos), T(alpha))),
                               np.asarray(jfr.ggx_ndf(J(pos), J(alpha))), **TOL)
    for e in (eta, 1.48958738):
        np.testing.assert_allclose(N(tfr.fresnel_dielectric(T(cos), T(e) if np.ndim(e) else e)),
                                   np.asarray(jfr.fresnel_dielectric(J(cos), e)), **TOL)
    np.testing.assert_allclose(N(tfr.fresnel_conductor_exact(T(pos), T(eta), T(k))),
                               np.asarray(jfr.fresnel_conductor_exact(J(pos), J(eta), J(k))),
                               **TOL)


def test_table_lookups_match_jax():
    g = np.random.default_rng(2)
    dot = g.uniform(1e-5, 0.99999, size=(512, 1)).astype(np.float32)
    alpha = g.uniform(1e-4, 3.9, size=(512, 1)).astype(np.float32)
    np.testing.assert_array_equal(N(ttab.lookup_T12(T(dot), T(alpha))),
                                  np.asarray(jtab.lookup_T12(J(dot), J(alpha))))
    np.testing.assert_array_equal(N(ttab.lookup_Fdr(T(alpha))),
                                  np.asarray(jtab.lookup_Fdr(J(alpha))))


@pytest.mark.parametrize("variant", ["ggx", "composite", "composite_env", "composite_ndf_alpha"])
def test_brdfs_match_jax(variant):
    light, distance, normal, viewdir, params = _rand_shading()
    tp = {k: T(v) for k, v in params.items()}
    jp = {k: J(v) for k, v in params.items()}
    targs = (T(light), T(distance), T(normal), T(viewdir), tp)
    jargs = (light, J(distance), J(normal), J(viewdir), jp)
    if variant == "ggx":
        got, ref = tbrdf.ggx_colocated(*targs), jbrdf.ggx_colocated(*jargs)
    else:
        kw = {"use_env_light": variant == "composite_env",
              "d_from_eta": variant != "composite_ndf_alpha"}
        got = tbrdf.composite_colocated(*targs, **kw)
        ref = jbrdf.composite_colocated(*jargs, **kw)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(N(got[k]), np.asarray(ref[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("renderer", ["comp", "comp2", "ggx"])
def test_shade_points_matches_jax(renderer):
    """shade_points with the JAX package's initial weights carried across."""
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
    assert set(got) == set(ref)
    for k in ref:
        # the 256-wide material MLPs sum in another order: f32 class, relative
        np.testing.assert_allclose(N(got[k]), np.asarray(ref[k]), rtol=1e-4, atol=2e-5,
                                   err_msg=k)
