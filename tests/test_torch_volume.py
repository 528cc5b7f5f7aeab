"""The port's stage-1 volume rendering against the JAX package on the CPU:
hierarchical sampling (sample_pdf, up_sample, cat_z_vals with tied z), the
background NeRF (and its dual head), the variance and the schedules, the
NeuS integrator (render_core_outside, render_core, neus_render, with and
without JAX's jitter injected), nerf_density_render and the occupancy
grid."""
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.fields.nerf import NeRFConfig as JNeRFConfig, init_nerf as j_init_nerf
from iron_tpu.fields.nerf import nerf_apply as j_nerf_apply
from iron_tpu.fields.rendering import RenderingConfig as JRenderingConfig
from iron_tpu.fields.rendering import init_rendering as j_init_rendering
from iron_tpu.fields.rendering import rendering_apply as j_rendering_apply
from iron_tpu.fields.scalars import init_variance as j_init_variance
from iron_tpu.fields.scalars import variance_apply as j_variance_apply
from iron_tpu.fields.sdf import SDFConfig as JSDFConfig, init_sdf as j_init_sdf
from iron_tpu.fields.sdf import sdf_only as j_sdf_only, sdf_value_feat_grad as j_vfg
from iron_tpu.train import schedules as jsched
from iron_tpu.volume import integrator as jint
from iron_tpu.volume import occupancy as jocc
from iron_tpu.volume import sampling as jsamp

from iron_tpu_torch.fields.nerf import (NeRFConfig, init_nerf, nerf_apply, nerf_from_numpy,
                                        nerf_to_numpy)
from iron_tpu_torch.fields.rendering import (RenderingConfig, rendering_apply,
                                             rendering_from_numpy)
from iron_tpu_torch.fields.scalars import (init_variance, variance_apply, variance_from_numpy,
                                           variance_to_numpy)
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy, sdf_only, sdf_value_feat_grad
from iron_tpu_torch.train import schedules as tsched
from iron_tpu_torch.volume import integrator as tint
from iron_tpu_torch.volume import occupancy as tocc
from iron_tpu_torch.volume import sampling as tsamp

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
COLOR = dict(d_feature=32, mode="idr", d_in=9, d_out=3, d_hidden=32, n_layers=4,
             multires=4, multires_view=2, squeeze_out=True, skip_in=(2,))
NERF = dict(D=2, W=32, skips=(0,))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["det", "u"])
def test_sample_pdf_matches_jax(mode):
    """Deterministic, and with u injected (JAX's draw from a key), on random
    bins and weights, some rays all but empty (flat weights): to 1e-5.  The
    cdf's f32 sums run in another order (and the midpoint u round apart by
    an ulp), and a sample moves by that error times its bin's width over
    the bin's share of the cdf, up to ~50x here."""
    g = np.random.default_rng(0)
    bins = np.sort(g.uniform(0, 2, size=(16, 65)), axis=-1).astype(np.float32)
    weights = g.uniform(0, 1, size=(16, 64)).astype(np.float32) ** 4
    weights[:4] = 0.0
    key = jax.random.PRNGKey(3)
    ref = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24, det=mode == "det",
                           key=None if mode == "det" else key)
    u = None if mode == "det" else T(jax.random.uniform(key, (16, 24)))
    got = tsamp.sample_pdf(T(bins), T(weights), 24, det=mode == "det", u=u)
    np.testing.assert_allclose(N(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the JAX package's own cases: flat weights give the midpoints, one heavy
    # bin takes the samples
    flat = tsamp.sample_pdf(torch.linspace(0, 1, 9)[None].repeat(4, 1), torch.ones(4, 8), 16,
                            det=True)
    np.testing.assert_allclose(N(flat[0]), np.linspace(0.5 / 16, 1 - 0.5 / 16, 16), atol=0.02)
    w = torch.zeros(1, 8)
    w[0, 3] = 100.0
    s = N(tsamp.sample_pdf(torch.linspace(0, 1, 9)[None], w, 32, det=True))
    assert np.mean((s >= 3 / 8) & (s <= 4 / 8)) > 0.9


def _rays(n, seed=1):
    g = np.random.default_rng(seed)
    d = g.normal(size=(n, 3))
    ro = (2.5 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    rd = 0.3 * g.normal(size=(n, 3)) - ro
    return ro, (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)


def _sphere_sdf(p, lib):
    norm = jnp.linalg.norm(p, axis=-1) if lib is jnp else torch.linalg.norm(p, dim=-1)
    return norm - 0.5 + 0.05 * lib.sin(4.0 * p[..., 0])


def test_up_sample_matches_jax():
    """Two importance rounds on an analytic SDF, the second on the first
    round's merged samples, each round given the same f32 sdf values: the
    new z to 1e-5.  (The placement is steep in the sdf: at inv_s 128 an f32
    rounding of the sdf input, 3e-8, moves a sample by up to 1e-4, so both
    packages take the same sdf values here.)"""
    ro, rd = _rays(32)
    z = np.broadcast_to(np.linspace(1.5, 3.5, 32, dtype=np.float32), (32, 32)).copy()
    for i in range(2):
        pts = jnp.asarray(ro)[:, None] + jnp.asarray(rd)[:, None] * jnp.asarray(z)[..., None]
        sdf = np.asarray(_sphere_sdf(pts, jnp))
        jn = jsamp.up_sample(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jnp.asarray(sdf),
                             16, 64 * 2 ** i)
        tn = tsamp.up_sample(T(ro), T(rd), T(z), T(sdf), 16, 64 * 2 ** i)
        np.testing.assert_allclose(N(tn), np.asarray(jn), rtol=1e-5, atol=1e-5)
        z = np.asarray(jsamp.cat_z_vals(jnp.asarray(z), jn, None, None)[0])
    assert not tn.requires_grad


def test_cat_z_vals_carries_tied_sdf_values_as_jax():
    """Tied z values (the deterministic sample_pdf of flat weights returns
    them) keep their SDF values in the order a stable sort gives, as
    jnp.argsort does: old samples before new, each in its own order."""
    z = np.float32([[0.0, 0.25, 0.5, 0.5, 0.75, 1.0]] * 3)
    new_z = np.float32([[0.5, 0.25, 0.5, 1.0], [0.0, 0.0, 0.0, 0.0], [0.9, 0.5, 0.25, 0.1]])
    sdf = np.arange(18, dtype=np.float32).reshape(3, 6)
    new_sdf = -np.arange(1, 13, dtype=np.float32).reshape(3, 4)
    jz, js = jsamp.cat_z_vals(*map(jnp.asarray, (z, new_z, sdf, new_sdf)))
    tz, ts = tsamp.cat_z_vals(*map(T, (z, new_z, sdf, new_sdf)))
    np.testing.assert_array_equal(N(tz), np.asarray(jz))
    np.testing.assert_array_equal(N(ts), np.asarray(js))
    assert N(ts)[0, 3:7].tolist() == [2.0, 3.0, -1.0, -3.0]
    tz2, none = tsamp.cat_z_vals(T(z), T(new_z), None, None)
    assert none is None and torch.equal(tz2, tz)


def test_transmittance_matches_cumprod_with_its_gradient():
    """transmittance (a cumprod whose backward reads no device value) gives
    torch.cumprod's values and gradient, alpha = 1 (a factor of 1e-7)
    included."""
    g = np.random.default_rng(3)
    a = g.uniform(0, 1, size=(6, 40)).astype(np.float32)
    a[:, 7] = 1.0
    a[2, 20:30] = 1.0
    w = T(g.normal(size=(6, 40)).astype(np.float32))
    x1, x2 = T(a).requires_grad_(True), T(a).requires_grad_(True)
    t1 = tsamp.transmittance(x1, 6)
    t2 = torch.cumprod(torch.cat([torch.ones(6, 1), 1.0 - x2 + 1e-7], -1), -1)[:, :-1]
    (t1 * w).sum().backward()
    (t2 * w).sum().backward()
    assert torch.equal(t1, t2)
    np.testing.assert_allclose(N(x1.grad), N(x2.grad), rtol=1e-6, atol=1e-30)


# ---------------------------------------------------------------------------
# networks and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dual", [False, True])
def test_nerf_apply_matches_jax(dual):
    """The NeRF with its skip and view head (and the NIR head with dual),
    JAX weights carried across: outputs to 1e-5; the port's own init has
    the JAX tree's structure and shapes, and the converters round-trip."""
    jcfg = JNeRFConfig(dual=dual, **NERF)
    cfg = NeRFConfig(dual=dual, **NERF)
    params = to_np(j_init_nerf(jax.random.PRNGKey(1), jcfg))
    net = nerf_from_numpy(params, cfg, "cpu")
    g = np.random.default_rng(2)
    pts = g.uniform(-1, 1, size=(5, 7, 4)).astype(np.float32)
    views = g.normal(size=(5, 7, 3)).astype(np.float32)
    ref = j_nerf_apply(params, jcfg, jnp.asarray(pts), jnp.asarray(views))
    got = nerf_apply(net, cfg, T(pts), T(views))
    assert len(got) == len(ref) == (3 if dual else 2)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    back = nerf_to_numpy(net)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    own = nerf_to_numpy(init_nerf(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(params)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(own),
                                                  jax.tree_util.tree_leaves(params)))


def test_variance_and_schedules_match_jax():
    for v in (0.3, -0.2):
        net = init_variance(v, "cpu")
        np.testing.assert_allclose(float(variance_apply(net)),
                                   float(j_variance_apply(j_init_variance(v))), rtol=1e-6)
        np.testing.assert_array_equal(variance_to_numpy(net)["variance"],
                                      np.asarray(j_init_variance(v)["variance"]))
        assert float(variance_from_numpy({"variance": np.float32(v)}, "cpu").variance) == \
            np.float32(v)
    j_lr = jsched.warmup_cosine_schedule(5e-4, 50, 1000, 0.05)
    t_lr = tsched.warmup_cosine_schedule(5e-4, 50, 1000, 0.05)
    for step in (0, 1, 25, 49, 50, 51, 500, 999, 1000, 1500):
        np.testing.assert_allclose(t_lr(step), float(j_lr(step)), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(tsched.cos_anneal_ratio(step, 700),
                                   float(jsched.cos_anneal_ratio(step, 700)), rtol=1e-6)
    assert tsched.cos_anneal_ratio(10, 0) == jsched.cos_anneal_ratio(10, 0) == 1.0


# ---------------------------------------------------------------------------
# the integrator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    """Narrow SDF, colour and NeRF parameters from the JAX package, and the
    port's modules holding the same weights."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(4), 3)
    jsdf_cfg, jcol_cfg, jnerf_cfg = JSDFConfig(**NARROW), JRenderingConfig(**COLOR), \
        JNeRFConfig(**NERF)
    p = {"sdf": to_np(j_init_sdf(k1, jsdf_cfg)), "color": to_np(j_init_rendering(k2, jcol_cfg)),
         "nerf": to_np(j_init_nerf(k3, jnerf_cfg))}
    t = {"sdf": sdf_from_numpy(p["sdf"], SDFConfig(**NARROW), "cpu"),
         "color": rendering_from_numpy(p["color"], RenderingConfig(**COLOR), "cpu"),
         "nerf": nerf_from_numpy(p["nerf"], NeRFConfig(**NERF), "cpu")}
    return p, t, (jsdf_cfg, jcol_cfg, jnerf_cfg)


def _fns(p, t, cfgs):
    jsdf_cfg, jcol_cfg, jnerf_cfg = cfgs
    jf = dict(sdf_fn=lambda x: j_sdf_only(p["sdf"], x, jsdf_cfg),
              sdf_all_fn=lambda x: j_vfg(p["sdf"], x, jsdf_cfg),
              color_fn=lambda x, g, d, f: j_rendering_apply(p["color"], jcol_cfg, x, g, d, f),
              nerf_fn=lambda x4, d: j_nerf_apply(p["nerf"], jnerf_cfg, x4, d))
    tf = dict(sdf_fn=lambda x: sdf_only(t["sdf"], x),
              sdf_all_fn=lambda x: sdf_value_feat_grad(t["sdf"], x),
              color_fn=lambda x, g, d, f: rendering_apply(t["color"], t["color"].cfg, x, g, d, f),
              nerf_fn=lambda x4, d: nerf_apply(t["nerf"], t["nerf"].cfg, x4, d))
    return jf, tf


RAY_KEYS = ("color_fine", "weight_sum", "weight_max", "gradient_error", "s_val")
SAMPLE_KEYS = ("z_vals", "gradients", "weights", "cdf_fine")


@pytest.mark.parametrize("jitter", [False, True])
def test_neus_render_matches_jax(nets, jitter):
    """The whole render at the stage-1 sampling (64 + 64 samples, 4
    up-sample rounds, 32 background samples) on 64 rays that start outside
    the unit sphere, with a white background and the anneal at 0.3; with
    perturb 0, and with perturb 1 and JAX's jitter (drawn from the render's
    key) injected.  The up-sampled z follow difference quotients of the f32
    sdf, so an f32 rounding of the sdf moves a z by ~1e-4 and every output
    after it with that z; the outputs are held by the share of entries off
    a tight tolerance and by the worst entry:
      * per ray (colour_fine, weight_sum, weight_max, gradient_error,
        s_val): at most 3% of the entries off 1e-4 relative + 1e-5, none off
        by more than 1e-3;
      * per sample (z_vals, gradients, weights, cdf_fine): at most 0.1% of
        the entries off 1e-3, none off by more than 2e-2;
    the masks identical."""
    p, t, cfgs = nets
    jf, tf = _fns(p, t, cfgs)
    ro, rd = _rays(64, seed=5)
    near, far = np.full((64, 1), 1.2, np.float32), np.full((64, 1), 3.8, np.float32)
    inv_s = 30.0
    perturb = 1.0 if jitter else 0.0
    jcfg = jint.NeuSRenderConfig(perturb=perturb)
    key = jax.random.PRNGKey(11)
    # jitted with the weights as arguments (closed over, XLA folds them)
    ref = jax.jit(lambda pp: jint.neus_render(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near), jnp.asarray(far),
        inv_s=jnp.asarray(inv_s), cfg=jcfg, key=key, background_rgb=jnp.ones((1, 3)),
        cos_anneal_ratio=0.3, **_fns(pp, t, cfgs)[0]))(p)
    draws = {}
    if jitter:
        k1, k2 = jax.random.split(key)
        draws = {"t_rand": T(jax.random.uniform(k1, (64, 1)) - 0.5),
                 "t_rand_outside": T(jax.random.uniform(k2, (64, 32)))}
    got = tint.neus_render(T(ro), T(rd), T(near), T(far), inv_s=torch.tensor(inv_s),
                           cfg=tint.NeuSRenderConfig(perturb=perturb),
                           background_rgb=torch.ones(1, 3), cos_anneal_ratio=0.3, **draws, **tf)
    for keys, rtol, atol, share, worst in ((RAY_KEYS, 1e-4, 1e-5, 0.03, 1e-3),
                                           (SAMPLE_KEYS, 0.0, 1e-3, 1e-3, 2e-2)):
        for k in keys:
            a, b = N(got[k]), np.asarray(ref[k])
            d = np.abs(a - b)
            off = float((d > atol + rtol * np.abs(b)).mean())
            assert off <= share and float(d.max()) <= worst, (k, off, float(d.max()))
    np.testing.assert_array_equal(N(got["inside_sphere"]), np.asarray(ref["inside_sphere"]))
    assert float(got["weight_sum"].max()) > 0.5      # rays that meet the surface
    if not jitter:
        with pytest.raises(ValueError, match="generator"):
            tint.neus_render(T(ro), T(rd), T(near), T(far), inv_s=torch.tensor(inv_s),
                             cfg=tint.NeuSRenderConfig(), **tf)


def test_render_core_and_outside_match_jax(nets):
    """render_core_outside on sorted z beyond the sphere and render_core
    with that background blended in, on the same z: colour, alpha, weights,
    gradients, cdf and s_val to 1e-5, gradient_error (a mean over the
    samples, f32 sums in another order) to 5e-5 relative; and the gradient of a
    weighted sum of the core's outputs with respect to every SDF, colour and
    NeRF parameter to 2e-3 of each leaf's largest entry."""
    p, t, cfgs = nets
    jf, tf = _fns(p, t, cfgs)
    ro, rd = _rays(24, seed=6)
    g = np.random.default_rng(7)
    z = np.sort(g.uniform(1.2, 3.8, size=(24, 40)), axis=-1).astype(np.float32)
    zo = np.sort(g.uniform(3.9, 20.0, size=(24, 8)), axis=-1).astype(np.float32)
    z_feed = np.sort(np.concatenate([z, zo], -1), -1)
    jo = jint.render_core_outside(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z_feed), 2 / 64,
                                  jf["nerf_fn"], background_rgb=jnp.ones((1, 3)) * 0.5)
    to = tint.render_core_outside(T(ro), T(rd), T(z_feed), 2 / 64, tf["nerf_fn"],
                                  background_rgb=torch.ones(1, 3) * 0.5)
    for k in ("color", "alpha", "weights", "sampled_color"):
        np.testing.assert_allclose(N(to[k]), np.asarray(jo[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    w = g.normal(size=(24, 3)).astype(np.float32)

    def j_obj(pp):
        f = _fns(pp, t, cfgs)[0]
        r = jint.render_core(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), 2 / 64,
                             f["sdf_all_fn"], f["color_fn"], jnp.asarray(25.0),
                             background_alpha=jint.render_core_outside(
                                 jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z_feed), 2 / 64,
                                 f["nerf_fn"])["alpha"],
                             background_sampled_color=jo["sampled_color"],
                             cos_anneal_ratio=0.6)
        return jnp.sum(r["color"] * w) + r["gradient_error"], r

    (jl, jr), jg = jax.jit(jax.value_and_grad(j_obj, has_aux=True))(p)
    tr = tint.render_core(T(ro), T(rd), T(z), 2 / 64, tf["sdf_all_fn"], tf["color_fn"],
                          torch.tensor(25.0), background_alpha=tint.render_core_outside(
                              T(ro), T(rd), T(z_feed), 2 / 64, tf["nerf_fn"])["alpha"],
                          background_sampled_color=T(jo["sampled_color"]), cos_anneal_ratio=0.6)
    for k in ("color", "weights", "gradients", "cdf", "s_val", "sdf", "dists", "mid_z_vals",
              "inside_sphere"):
        np.testing.assert_allclose(N(tr[k]), np.asarray(jr[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tr["gradient_error"]), float(jr["gradient_error"]),
                               rtol=5e-5)
    tl = (tr["color"] * T(w)).sum() + tr["gradient_error"]
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    for name in ("sdf", "color", "nerf"):
        got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(
            _grads_of(t[name]))}
        ref = {jax.tree_util.keystr(k): np.asarray(v)
               for k, v in jax.tree_util.tree_leaves_with_path(jg[name])}
        assert set(got) == set(ref), name
        for k, a in ref.items():
            np.testing.assert_allclose(got[k], a, rtol=2e-3,
                                       atol=2e-3 * float(np.abs(a).max()) + 1e-10,
                                       err_msg=name + k)


def _grads_of(net):
    """A module's gradients in the JAX tree layout (zeros where none)."""
    from iron_tpu_torch.train.stage1 import _jax_path, _tree
    return _tree((_jax_path(n), np.zeros(q.shape, np.float32) if q.grad is None else N(q.grad))
                 for n, q in net.named_parameters())


def test_nerf_density_render_matches_jax(nets):
    p, t, cfgs = nets
    jf, tf = _fns(p, t, cfgs)
    ro, rd = _rays(16, seed=8)
    near, far = np.full((16,), 0.5, np.float32), np.full((16,), 4.5, np.float32)
    key = jax.random.PRNGKey(2)
    nerf3 = NeRFConfig(**{**NERF, "d_in": 3})
    jp3 = to_np(j_init_nerf(jax.random.PRNGKey(9), JNeRFConfig(**{**NERF, "d_in": 3})))
    t3 = nerf_from_numpy(jp3, nerf3, "cpu")
    ref = jint.nerf_density_render(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near), jnp.asarray(far),
        lambda x, d: j_nerf_apply(jp3, JNeRFConfig(**{**NERF, "d_in": 3}), x, d), 24,
        background_rgb=jnp.ones((1, 3)), key=key)
    got = tint.nerf_density_render(T(ro), T(rd), T(near), T(far),
                                   lambda x, d: nerf_apply(t3, nerf3, x, d), 24,
                                   background_rgb=torch.ones(1, 3),
                                   t_rand=T(jax.random.uniform(key, (16, 1)) - 0.5))
    for k in ("color", "zmap", "weights"):
        np.testing.assert_allclose(N(got[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# occupancy
# ---------------------------------------------------------------------------

def test_occupancy_grid_and_guided_z_match_jax(nets):
    """The grid of the narrow SDF equal to JAX's (its cells are decided by
    |sdf| < a margin: none lies within 1e-5 of it here), the lookup, and
    occupancy_guided_z deterministic and with JAX's u injected, to 1e-5."""
    p, t, cfgs = nets
    cfg, jcfg = tocc.OccupancyGridConfig(resolution=24), jocc.OccupancyGridConfig(resolution=24)
    jgrid = jocc.update_occupancy_grid(lambda x: j_sdf_only(p["sdf"], x, cfgs[0]), jcfg,
                                       chunk=4096)
    grid = tocc.update_occupancy_grid(lambda x: sdf_only(t["sdf"], x), cfg, "cpu", chunk=4096)
    np.testing.assert_array_equal(N(grid), np.asarray(jgrid))
    assert 0.005 < float(grid.float().mean()) < 0.5
    ro, rd = _rays(32, seed=9)
    near, far = np.full((32, 1), 1.5, np.float32), np.full((32, 1), 3.5, np.float32)
    pts = ro[:, None] + rd[:, None] * np.linspace(1.5, 3.5, 10, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(N(tocc.occupancy_lookup(grid, T(pts), cfg)),
                                  np.asarray(jocc.occupancy_lookup(jgrid, jnp.asarray(pts), jcfg)))
    key = jax.random.PRNGKey(5)
    for det in (True, False):
        ref = jocc.occupancy_guided_z(jgrid, jcfg, jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray(near), jnp.asarray(far), 48,
                                      key=None if det else key)
        u = None if det else T(jax.random.uniform(key, (32, 48)))
        got = tocc.occupancy_guided_z(grid, cfg, T(ro), T(rd), T(near), T(far), 48, u=u)
        np.testing.assert_allclose(N(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
        assert bool((got[:, 1:] >= got[:, :-1]).all())
