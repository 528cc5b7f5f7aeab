"""The PyTorch port's fields against the JAX package on the CPU: the SDF at
the full default width, the rendering networks of the comp renderer, the
point light, and the transfer of parameters between the two packages."""
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.fields import rendering as jrend
from iron_tpu.fields import sdf as jsdf
from iron_tpu.shading.materials import renderer_network_configs as j_net_cfgs
from iron_tpu.train.stage2 import Stage2Config as JStage2Config, init_stage2_params as j_init

from iron_tpu_torch.fields import rendering as trend
from iron_tpu_torch.fields import sdf as tsdf
from iron_tpu_torch.fields.scalars import init_point_light, point_light_apply
from iron_tpu_torch.shading.materials import renderer_network_configs
from iron_tpu_torch.train.checkpoints import params_from_numpy, params_to_numpy

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    params, _ = j_init(jax.random.PRNGKey(0), JStage2Config())
    return to_np(params)


def test_params_round_trip(jax_params):
    params = params_from_numpy(jax_params, "cpu")
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
    # a tree of another architecture is refused
    bad = to_np(jax_params)
    bad["sdf"]["layers"] = bad["sdf"]["layers"][:-1]
    with pytest.raises(ValueError):
        params_from_numpy(bad, "cpu")


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_sdf_apply_full_width_matches_jax(jax_params, rng, scale):
    cfg = jsdf.SDFConfig(scale=scale)
    net = tsdf.sdf_from_numpy(jax_params["sdf"], tsdf.SDFConfig(scale=scale), "cpu")
    x = (rng.normal(size=(300, 3)) * 0.5).astype(np.float32)
    ref = np.asarray(jsdf.sdf_apply(jax_params["sdf"], jnp.asarray(x), cfg))
    # the tolerance of the JAX fused-kernel test (tests/test_kernels.py): f32
    # sums of 256 terms in another order
    np.testing.assert_allclose(N(tsdf.sdf_apply(net, T(x))), ref, atol=2e-5, rtol=1e-5)


def test_sdf_value_feat_grad_matches_jax(jax_params, rng):
    net = tsdf.sdf_from_numpy(jax_params["sdf"], tsdf.SDFConfig(), "cpu")
    x = (rng.normal(size=(7, 9, 3)) * 0.4).astype(np.float32)
    v1, f1, g1 = jsdf.sdf_value_feat_grad(jax_params["sdf"], jnp.asarray(x), jsdf.SDFConfig())
    with torch.no_grad():
        v2, f2, g2 = tsdf.sdf_value_feat_grad(net, T(x))
    assert v2.shape == (7, 9) and f2.shape == (7, 9, 256) and g2.shape == (7, 9, 3)
    for a, b in [(v1, v2), (f1, f2), (g1, g2)]:
        np.testing.assert_allclose(N(b), np.asarray(a), atol=2e-5, rtol=1e-5)


def test_init_sdf_geometric_distributions():
    """The RNGs differ, so the geometric init is checked by its statistics
    and its zeroed blocks, and by the sphere-like SDF it gives."""
    cfg = tsdf.SDFConfig()
    g = torch.Generator().manual_seed(0)
    net = tsdf.init_sdf(cfg, g, "cpu")
    dims = cfg.dims
    v0 = N(net.layers[0].v)
    assert np.all(v0[3:] == 0) and abs(v0[:3].std() - np.sqrt(2 / 256)) < 0.01
    skip = N(net.layers[4].v)
    assert np.all(skip[-(dims[0] - 3):] == 0)
    mid = N(net.layers[2].v)
    assert abs(mid.mean()) < 2e-3 and abs(mid.std() - np.sqrt(2 / 256)) < 2e-3
    last = N(net.layers[-1].v)
    assert abs(last.mean() - np.sqrt(np.pi) / np.sqrt(256)) < 1e-4 and last.std() < 2e-4
    np.testing.assert_allclose(N(net.layers[-1].b), -cfg.bias)
    # weight norm starts at g = ||v|| per column
    np.testing.assert_allclose(N(net.layers[1].g), np.linalg.norm(N(net.layers[1].v), axis=0),
                               rtol=1e-6)
    # sphere-like at init: the median |sdf - (|x| - bias)| over 4 seeds, the
    # same statistic as the JAX package's init gives (seed to seed it spreads
    # over 0.06-0.11 in both)
    pts = (np.random.default_rng(1).normal(size=(2048, 3)) * 0.6).astype(np.float32)
    exact = np.linalg.norm(pts, axis=-1) - cfg.bias
    med_t, med_j = [], []
    for seed in range(4):
        n_t = tsdf.init_sdf(cfg, torch.Generator().manual_seed(seed), "cpu")
        with torch.no_grad():
            med_t.append(np.median(np.abs(N(tsdf.sdf_only(n_t, T(pts))) - exact)))
        p_j = jsdf.init_sdf(jax.random.PRNGKey(seed))
        med_j.append(np.median(np.abs(np.asarray(jsdf.sdf_only(p_j, jnp.asarray(pts))) - exact)))
    assert np.mean(med_t) < 0.1 and np.mean(med_j) < 0.1
    assert abs(np.mean(med_t) - np.mean(med_j)) < 0.03


COMP_NETS = ["diffuse_albedo_network", "specular_albedo_network", "metallic_network",
             "env_light_network"]


@pytest.mark.parametrize("name", COMP_NETS)
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_rendering_apply_comp_nets_match_jax(jax_params, rng, name, dtype):
    """The comp renderer's modes: idr with PE and a skip (diffuse albedo),
    no_view_dir scalar heads, points_only (env light); f32 and bf16."""
    jcfg = j_net_cfgs("comp")[name]
    tcfg = renderer_network_configs("comp")[name]
    if dtype:
        import dataclasses
        jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
    p = jax_params["materials"][name]
    net = trend.rendering_from_numpy(p, tcfg, "cpu")
    n = 64
    pts = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    feat = rng.normal(size=(n, 256)).astype(np.float32)
    ref = np.asarray(jrend.rendering_apply(p, jcfg, *map(jnp.asarray, (pts, nrm, vd, feat))))
    with torch.no_grad():
        got = N(trend.rendering_apply(net, tcfg, *map(T, (pts, nrm, vd, feat))))
    # f32: sums of up to 300 terms in another order; bf16: the two packages
    # round products of ~3-digit operands at other places
    atol = 2e-5 if dtype is None else 5e-2
    np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-5 if dtype is None else 5e-2)


def test_point_light():
    light = init_point_light(5.0, device="cpu")
    assert float(point_light_apply(light)) == 5.0
