"""The port's surface pipeline against the JAX package on the CPU: the
budgeted selection, the morphology, the dedupe, the tracer on an analytic
sphere, render_camera with its debug buffers, and the whole slice:
Stage2Trainer.render_full at the full default width with the comp renderer,
resumed from a checkpoint the JAX package wrote."""
import dataclasses

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.core.camera import make_camera as j_make_camera
from iron_tpu.fields.sdf import SDFConfig as JSDFConfig, sdf_only as j_sdf_only
from iron_tpu.fields.sdf import sdf_value_feat_grad as j_vfg
from iron_tpu.shading.materials import renderer_network_configs as j_net_cfgs
from iron_tpu.shading.materials import shade_points as j_shade
from iron_tpu.surface import morphology as jmorph
from iron_tpu.surface.render import SurfaceRenderConfig as JSurf, render_camera as j_render
from iron_tpu.surface.render import _dedupe_per_pixel as j_dedupe
from iron_tpu.surface.tracer import TracerConfig as JTracerConfig
from iron_tpu.surface.tracer import budget_select as j_budget_select, raytrace as j_raytrace
from iron_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from iron_tpu.train.stage2 import Stage2Config as JStage2Config, Stage2Trainer as JTrainer
from iron_tpu.train.stage2 import build_stage2_fns as j_build_stage2_fns
from iron_tpu.train.stage2 import init_stage2_params as j_init_stage2
from iron_tpu.train.stage2 import stage2_render_buffers as j_stage2_buffers

from iron_tpu_torch.core.camera import make_camera
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_only, sdf_value_feat_grad
from iron_tpu_torch.shading.materials import renderer_network_configs, shade_points
from iron_tpu_torch.surface import morphology as tmorph
from iron_tpu_torch.surface.render import SurfaceRenderConfig, _dedupe_per_pixel, render_camera
from iron_tpu_torch.surface.tracer import TracerConfig, budget_select, raytrace
from iron_tpu_torch.train.checkpoints import params_from_numpy, params_to_numpy
from iron_tpu_torch.train.stage2 import (Stage2Config, Stage2Trainer, build_stage2_fns,
                                         init_stage2_params, stage2_render_buffers)

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()


def _view(H):
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 1.25 * H
    K[0, 2] = K[1, 2] = H / 2
    W2C = np.eye(4, dtype=np.float32)
    W2C[:3, :3] = np.diag([1.0, -1.0, -1.0])
    W2C[2, 3] = 3.0
    return K, W2C


@pytest.mark.parametrize("n,k", [(1000, 37), (1024, 1024), (4096, 100), (65536, 2048),
                                 (100000, 512), (262144, 4096)])
def test_budget_select_identical_indices(n, k):
    """Identical indices, including sizes where the JAX package's int32
    golden-ratio permutation wraps (n = 100000)."""
    mask = np.random.default_rng(n).uniform(size=n) < 0.3
    ref = np.asarray(j_budget_select(jnp.asarray(mask), k))
    np.testing.assert_array_equal(N(budget_select(T(mask), k)), ref)


def test_morphology_matches_jax():
    g = np.random.default_rng(0)
    img = g.uniform(0, 3, size=(23, 31)).astype(np.float32)
    img[g.uniform(size=img.shape) < 0.2] = 0.0
    np.testing.assert_array_equal(N(tmorph.closing3x3(T(img))),
                                  np.asarray(jmorph.closing3x3(jnp.asarray(img))))
    # 6 f32 taps summed in another order than XLA's convolution
    np.testing.assert_allclose(N(tmorph.sobel_magnitude(T(img))),
                               np.asarray(jmorph.sobel_magnitude(jnp.asarray(img))),
                               atol=1e-6, rtol=1e-6)


def test_dedupe_per_pixel_matches_jax():
    g = np.random.default_rng(1)
    H, W, K = 12, 10, 200
    uv = g.uniform(-2, 13, size=(K, 2)).astype(np.float32)   # duplicates and off-image
    found = g.uniform(size=K) < 0.8
    K_, W2C = _view(H)
    walk_t = {"walk_points": torch.zeros(K, 3), "walk_uv": T(uv), "walk_found": T(found)}
    walk_j = {"walk_points": jnp.zeros((K, 3)), "walk_uv": jnp.asarray(uv),
              "walk_found": jnp.asarray(found)}
    got = _dedupe_per_pixel(make_camera(K_, W2C, H, W, device="cpu"), walk_t)
    ref = j_dedupe(j_make_camera(K_, W2C, H, W), walk_j)
    for k in ref:
        np.testing.assert_array_equal(N(got[k]), np.asarray(ref[k]), err_msg=k)


def test_raytrace_analytic_sphere_matches_jax():
    n = 400
    g = np.random.default_rng(2)
    ray_o = np.tile(np.array([0, 0, 2.5], np.float32), (n, 1))
    tgt = g.uniform(-0.8, 0.8, size=(n, 3)).astype(np.float32)
    ray_d = tgt - ray_o
    ray_d = (ray_d / np.linalg.norm(ray_d, axis=-1, keepdims=True)).astype(np.float32)
    min_dis = np.full(n, 1.0, np.float32)
    max_dis = np.full(n, 4.0, np.float32)
    work = np.ones(n, bool)
    cfg = dict(fallback_budget=64)
    ref = j_raytrace(lambda p: jnp.linalg.norm(p, axis=-1) - 0.5,
                     *map(jnp.asarray, (ray_o, ray_d, min_dis, max_dis, work)),
                     JTracerConfig(**cfg))
    got = raytrace(lambda p: torch.linalg.norm(p, dim=-1) - 0.5,
                   *map(T, (ray_o, ray_d, min_dis, max_dis, work)), TracerConfig(**cfg))
    conv = np.asarray(ref["convergent_mask"])
    assert 100 < conv.sum() < n
    np.testing.assert_array_equal(N(got["convergent_mask"]), conv)
    # every root on the sphere to the tracer's threshold
    resid = np.abs(np.linalg.norm(N(got["points"])[conv], axis=-1) - 0.5)
    assert resid.max() <= 5e-5 * 1.01
    np.testing.assert_allclose(N(got["distance"])[conv], np.asarray(ref["distance"])[conv],
                               atol=1e-4)


def test_render_camera_debug_buffers_match_jax():
    """render_camera with debug buffers on a narrow network (plain f32
    evaluators on both sides): every buffer the JAX render returns."""
    jcfg = JStage2Config(sdf=JSDFConfig(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,),
                                        multires=4))
    params, jmats = j_init_stage2(jax.random.PRNGKey(1), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = Stage2Config(sdf=SDFConfig(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,),
                                      multires=4))
    tp = params_from_numpy(params, "cpu", tcfg.sdf, "comp")
    H = 24
    K, W2C = _view(H)
    surf = dict(edge_budget=128, interior_budget=256)
    ref = jax.jit(lambda: j_render(lambda p: j_sdf_only(params["sdf"], p, jcfg.sdf),
                                   lambda p: j_vfg(params["sdf"], p, jcfg.sdf),
                                   lambda *a: j_shade("comp", params["materials"], jmats, *a),
                                   j_make_camera(K, W2C, H, H), JSurf(**surf), debug=True))()
    tcfgs = renderer_network_configs("comp", d_feature=32)
    with torch.no_grad():
        got = render_camera(lambda p: sdf_only(tp["sdf"], p),
                            lambda p: sdf_value_feat_grad(tp["sdf"], p),
                            lambda *a: shade_points("comp", tp["materials"], tcfgs, *a),
                            make_camera(K, W2C, H, H, device="cpu"),
                            SurfaceRenderConfig(**surf), debug=True)
    assert set(got) == set(ref)
    assert np.asarray(ref["hit_mask"]).sum() > 50 and np.asarray(ref["edge_mask"]).sum() > 5
    for k, v in ref.items():
        a, b = np.asarray(v), N(got[k])
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            # roots agree to the tracer's 5e-5 threshold; buffers that
            # follow them move by a few times that (angles in degrees more)
            np.testing.assert_allclose(b, a, atol=5e-3 if k == "edge_angles" else 2e-4,
                                       rtol=1e-4, err_msg=k)


def test_stage2_render_buffers_matches_jax():
    """stage2_render_buffers (the plain evaluation render) on a narrow
    network with the ggx renderer."""
    sdf_kw = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
    jcfg = JStage2Config(renderer_name="ggx", sdf=JSDFConfig(**sdf_kw),
                         surface=JSurf(edge_budget=64))
    params, jmats = j_init_stage2(jax.random.PRNGKey(2), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = Stage2Config(renderer_name="ggx", sdf=SDFConfig(**sdf_kw),
                        surface=SurfaceRenderConfig(edge_budget=64))
    tp = params_from_numpy(params, "cpu", tcfg.sdf, "ggx")
    H = 20
    K, W2C = _view(H)
    ref = jax.jit(lambda: j_stage2_buffers(params, jmats, jcfg, j_make_camera(K, W2C, H, H)))()
    got = stage2_render_buffers(tp, renderer_network_configs("ggx", d_feature=32), tcfg,
                                make_camera(K, W2C, H, H, device="cpu"))
    assert set(got) == set(ref)
    np.testing.assert_array_equal(N(got["convergent_mask"]), np.asarray(ref["convergent_mask"]))
    assert np.asarray(ref["convergent_mask"]).sum() > 20
    for k in ("color", "normal", "depth"):
        # roots agree to the tracer's 5e-5 threshold
        np.testing.assert_allclose(N(got[k]), np.asarray(ref[k]), atol=2e-4, rtol=1e-4,
                                   err_msg=k)


def test_build_stage2_fns_on_cpu():
    """On the CPU build_stage2_fns leaves the coarse evaluators unset and
    traces and shades through the plain f32 SDF, as the JAX package does
    there (the kernel flags, trace_pallas among them, change nothing).
    mat_bf16 runs the comp material networks in bf16: on the same inputs
    its shading moves by more than 0 and less than 2e-2 from the f32
    shading (the bound of tests/test_stage2_e2e.py), in the port and in the
    JAX package, and the two packages' bf16 shadings differ by a small part
    of that effect."""
    sdf_kw = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
    cfg = Stage2Config(renderer_name="comp", sdf=SDFConfig(**sdf_kw))
    params, mats = init_stage2_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = np.random.default_rng(0)
    x = torch.as_tensor(g.uniform(-0.6, 0.6, (50, 3)), dtype=torch.float32)
    for c in (cfg, dataclasses.replace(cfg, coarse_pallas=False, shade_pallas=False),
              dataclasses.replace(cfg, trace_pallas=True)):
        fns = build_stage2_fns(params, mats, c)
        assert fns["coarse_sdf_fn"] is None and fns["coarse_march_fn"] is None
        for a, b in zip(fns["sdf_all_fn"](x), sdf_value_feat_grad(params["sdf"], x)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(fns["trace_sdf_fn"](x), sdf_only(params["sdf"], x), rtol=0,
                                   atol=0)

    ray_o = np.tile(np.array([0.0, 0.0, 3.0], np.float32), (50, 1))
    ray_d = N(x) - ray_o
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    nrm = g.normal(size=(50, 3)).astype(np.float32)
    feats = (g.normal(size=(50, 32)) * 0.5).astype(np.float32)
    inputs = (ray_o, ray_d, N(x), nrm, feats)
    jparams = params_to_numpy(params)
    jcfg = JStage2Config(renderer_name="comp", sdf=JSDFConfig(**sdf_kw))
    color = {}
    for bf16 in (False, True):
        with torch.no_grad():
            fns = build_stage2_fns(params, mats, dataclasses.replace(cfg, mat_bf16=bf16))
            color["port", bf16] = N(fns["shade_fn"](*map(T, inputs))["color"])
        jfns = j_build_stage2_fns(jparams, j_net_cfgs("comp", d_feature=32),
                                  dataclasses.replace(jcfg, mat_bf16=bf16))
        color["jax", bf16] = np.asarray(jfns["shade_fn"](*map(jnp.asarray, inputs))["color"])
    for pkg in ("port", "jax"):
        d = np.abs(color[pkg, True] - color[pkg, False]).max()
        assert 0 < d < 2e-2, (pkg, d)
    np.testing.assert_allclose(color["port", False], color["jax", False], atol=1e-5, rtol=1e-5)
    # The bf16 rounding falls where JAX's does: the packages' bf16 shadings
    # differ by a small part of bf16's own effect, at its largest (0.24 x
    # measured) and on average (0.013 x measured; most colours are equal).
    effect = np.abs(color["jax", True] - color["jax", False])
    cross = np.abs(color["port", True] - color["jax", True])
    assert cross.max() < 0.5 * effect.max(), (cross.max(), effect.max())
    assert cross.mean() < 0.05 * effect.mean(), (cross.mean(), effect.mean())


def test_render_full_whole_slice_matches_jax(tmp_path):
    """The whole slice: Stage2Trainer.render_full of a 32x32 view at the full
    default SDF width with the comp renderer, on weights the JAX package
    initialised and saved as a checkpoint, against JAX render_full."""
    H = 32
    K, W2C = _view(H)
    images = np.zeros((1, H, H, 3), np.float32)
    jt = JTrainer(JStage2Config(), images, K[None], W2C[None], key=jax.random.PRNGKey(0))
    j_save_checkpoint(str(tmp_path), 7, jt.params)
    ref = jt.render_full(0)

    tt = Stage2Trainer(Stage2Config(), images, K[None], W2C[None], out_dir=str(tmp_path),
                       device="cpu")
    assert tt.resume() == 7
    got = tt.render_full(0)
    assert set(got) == set(ref)
    for k in ("convergent_mask", "hit_mask", "edge_mask"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert ref["hit_mask"].sum() > 100 and ref["edge_mask"].sum() > 10
    m = ref["hit_mask"] | ref["edge_mask"]
    # Roots agree to the tracer's own 5e-5 threshold (the two packages take
    # different f32 step sequences); depth and normals follow within 1e-4,
    # and colour, of magnitude ~2.4 here, moves by ~2.4 per unit along the
    # surface, so it holds to 1e-4 relative.
    np.testing.assert_allclose(got["depth"][m], ref["depth"][m], atol=1e-4)
    np.testing.assert_allclose(got["normal"][m], ref["normal"][m], atol=1e-4)
    np.testing.assert_allclose(got["color"][m], ref["color"][m], atol=1e-4, rtol=1e-4)
