"""The port's stage-2 training path against the JAX package on the CPU: the
losses and regularisers, the reparam, the training-mode render's gradients,
one whole training step (loss, metrics, every gradient, the parameters after
Adam), the checkpoints both ways and the synthetic data."""
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp
import optax

from iron_tpu.core.camera import crop_camera as j_crop_camera, make_camera as j_make_camera
from iron_tpu.data.synthetic import render_synthetic_dataset as j_synthetic
from iron_tpu.fields.sdf import SDFConfig as JSDFConfig, sdf_only as j_sdf_only
from iron_tpu.fields.sdf import sdf_value_feat_grad as j_vfg
from iron_tpu.losses import image as jimg
from iron_tpu.losses import regularizers as jreg
from iron_tpu.shading.materials import shade_points as j_shade
from iron_tpu.surface.reparam import reparam_points as j_reparam
from iron_tpu.surface.render import SurfaceRenderConfig as JSurf, render_camera as j_render
from iron_tpu.train.checkpoints import load_checkpoint as j_load_checkpoint
from iron_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from iron_tpu.shading.materials import renderer_network_configs as j_net_cfgs
from iron_tpu.train.stage2 import Stage2Config as JStage2Config
from iron_tpu.train.stage2 import init_light_from_cameras as j_init_light
from iron_tpu.train.stage2 import init_stage2_params as j_init_stage2
from iron_tpu.train.stage2 import make_optimizer as j_make_optimizer
from iron_tpu.train.stage2 import stage2_loss as j_stage2_loss

from iron_tpu_torch.core.camera import make_camera
from iron_tpu_torch.data.synthetic import render_synthetic_dataset
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_only, sdf_value_feat_grad
from iron_tpu_torch.losses import image as timg
from iron_tpu_torch.losses import regularizers as treg
from iron_tpu_torch.shading.materials import renderer_network_configs, shade_points
from iron_tpu_torch.surface.reparam import reparam_points
from iron_tpu_torch.surface.render import SurfaceRenderConfig, render_camera
from iron_tpu_torch.train.checkpoints import (params_from_numpy, params_to_numpy,
                                              save_checkpoint, stage1_to_stage2)
from iron_tpu_torch.train.stage2 import (Stage2Config, Stage2Trainer, make_optimizer,
                                         material_lr_map)

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)


def _grad_tree(params):
    """The port's parameter gradients as the JAX parameter tree (zeros where
    a parameter received none, as JAX reports an unused leaf)."""
    def val(p):
        return np.zeros(p.shape, np.float32) if p.grad is None else N(p.grad)

    def lin(l):
        return {k: val(getattr(l, k)) for k in (("v", "g", "b") if l.weight_norm else ("w", "b"))}

    mats = {name: ({"light": val(net.light)} if name == "point_light_network"
                   else {"layers": [lin(l) for l in net.layers]})
            for name, net in params["materials"].items()}
    return {"sdf": {"layers": [lin(l) for l in params["sdf"].layers]}, "materials": mats}


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# one whole step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """Two 48x48 views of the analytic sphere (JAX golden-oracle renderer)
    with their coverage masks; the sphere covers 13% of each view."""
    return j_synthetic("sphere", n_views=2, H=48, W=48, light=30.0, rig_kwargs={"focal": 60.0})


def _step_cfgs(**kw):
    common = dict(renderer_name="comp", patch_size=32, silhouette_weight=0.3, **kw)
    return (JStage2Config(sdf=JSDFConfig(**NARROW), surface=JSurf(edge_budget=256), **common),
            Stage2Config(sdf=SDFConfig(**NARROW), surface=SurfaceRenderConfig(edge_budget=256),
                         **common))


def _j_params(cfg, W2Cs):
    """JAX stage-2 parameters as its trainer makes them (init, then the
    light from the cameras)."""
    params = j_init_stage2(jax.random.PRNGKey(0), cfg)[0]
    params["materials"]["point_light_network"]["light"] = jnp.asarray(
        j_init_light(W2Cs, cfg.init_light_scale), jnp.float32)
    return params


STEP = dict(idx=0, col=0, row=0, key=7)


@pytest.fixture(scope="module")
def jax_params(scene):
    return _j_params(_step_cfgs()[0], scene["W2Cs"])


@pytest.fixture(scope="module")
def jax_step(scene, jax_params):
    """One JAX training step as `Stage2Trainer`'s one_step runs it
    (iron_tpu/train/stage2.py:503-521), with its gradients kept: (params,
    eikonal points, loss, metrics, grads, params after Adam)."""
    jcfg, _ = _step_cfgs()
    params = jax_params
    mat_cfgs = j_net_cfgs("comp", d_feature=NARROW["d_out"] - 1)
    tx = j_make_optimizer(jcfg, params)
    ps, i, c, r = jcfg.patch_size, STEP["idx"], STEP["col"], STEP["row"]
    k_eik, = jax.random.split(jax.random.PRNGKey(STEP["key"]), 1)
    cam = j_crop_camera(j_make_camera(scene["Ks"][i], scene["W2Cs"][i], 48, 48), c, r, ps, ps)
    gt = jnp.asarray(scene["images"][i, r:r + ps, c:c + ps])
    gm = jnp.asarray(scene["masks"][i, r:r + ps, c:c + ps, 0])

    @jax.jit
    def step(p):
        (loss, m), g = jax.value_and_grad(
            lambda q: j_stage2_loss(q, mat_cfgs, jcfg, cam, gt, k_eik, gm), has_aux=True)(p)
        updates, _ = tx.update(g, tx.init(p), p)
        return loss, m, g, optax.apply_updates(p, updates)

    loss, m, g, new = step(params)
    eik = jax.random.uniform(k_eik, ((ps * ps) // 2, 3), minval=-1.0, maxval=1.0)
    return {"params": to_np(params), "eik": np.asarray(eik), "loss": float(loss),
            "metrics": {k: float(v) for k, v in m.items()}, "grads": to_np(g),
            "new": to_np(new)}


def test_one_training_step_matches_jax(scene, jax_step):
    """One stage-2 step of the comp renderer with the silhouette term on, on
    a 32x32 crop holding silhouette pixels, from the same parameters (JAX
    init, transplanted), the same crop and the same eikonal points (drawn
    by JAX from the step's key and handed to the port): the loss and every
    metric, every gradient leaf and the parameters after the Adam update.

    Tolerances: the two tracers' roots agree to the 5e-5 tracer threshold
    (not bit for bit: each package takes its own f32 step sequence), so
    masks, counts and edge sets must be identical and everything that
    follows a root moves by a few 1e-5 relative: the loss and metrics to
    rtol 2e-4.  Gradient leaves to rtol 2e-3 and atol 2e-3 of the leaf's
    largest entry (+ 1e-10 for leaves whose terms cancel to rounding
    residue, as the roughness head's do here): the diffuse-albedo net
    encodes the points at frequencies up to 2^9, so its first layers weigh
    the 5e-5 root differences most and set this tolerance; the other leaves
    agree far closer.  Adam's first update is
    lr * g / (|g| + 1e-8), so the parameters after it agree to 1e-3 of
    each group's learning rate where |g| exceeds both 1e-6 and ten times its
    leaf's largest gradient difference; elsewhere the update's size or sign
    follows rounding and they agree to 2 lr."""
    _, tcfg = _step_cfgs()
    tt = Stage2Trainer(tcfg, scene["images"], scene["Ks"], scene["W2Cs"], masks=scene["masks"],
                       device="cpu")
    tt.params = params_from_numpy(jax_step["params"], "cpu", tcfg.sdf, "comp")
    tt.opt = make_optimizer(tcfg, tt.params)
    tm = tt.train_step(STEP["idx"], STEP["col"], STEP["row"], T(jax_step["eik"]))

    jm = jax_step["metrics"]
    assert set(tm) == set(jm)
    assert jm["edge_pixel_count"] > 20 and jm["mask_excess_count"] > 0 and jm["mask_miss_count"] > 0
    for k in ("edge_seed_count", "edge_seeds_dropped", "edge_pixel_count", "mask_miss_count",
              "mask_excess_count", "mask_frac"):
        assert float(tm[k]) == jm[k], k
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), v, rtol=2e-4, atol=1e-7, err_msg=k)

    ref_g, got_g = _leaves(jax_step["grads"]), _leaves(_grad_tree(tt.params))
    assert set(got_g) == set(ref_g)
    for k, a in ref_g.items():
        np.testing.assert_allclose(got_g[k], a, rtol=2e-3,
                                   atol=2e-3 * float(np.abs(a).max()) + 1e-10, err_msg=k)

    lrs = material_lr_map("comp")
    ref_p, got_p = _leaves(jax_step["new"]), _leaves(params_to_numpy(tt.params))
    old = _leaves(jax_step["params"])
    for k, a in ref_p.items():
        net = k.split("'")[3] if k.startswith("['materials']") else "sdf"
        lr = tcfg.sdf_lr if net == "sdf" else lrs[net]
        g_err = float(np.abs(got_g[k] - ref_g[k]).max())
        loose = np.abs(ref_g[k]) < max(1e-6, 10 * g_err)
        err = np.abs(got_p[k] - a) - 1e-7 * np.abs(a)    # less the f32 rounding of p + dp
        assert np.all(err[~loose] <= 1e-3 * lr), k
        assert np.all(err[loose] <= 2 * lr), k
    assert np.any(ref_p["['sdf']['layers'][0]['v']"] != old["['sdf']['layers'][0]['v']"])


def test_optimizer_groups_freezing_and_clipping():
    """make_optimizer: one Adam group per optax group with its learning rate
    (sdf at sdf_lr, each material net at 1e-4, the light at 1e-2); a frozen
    group is never updated; grad_clip scales each group's gradients to its
    global norm as optax.clip_by_global_norm does (here against optax on
    the same gradients)."""
    cfg = Stage2Config(renderer_name="comp", sdf=SDFConfig(**NARROW), grad_clip=0.5)
    tt = Stage2Trainer(cfg, np.zeros((1, 8, 8, 3), np.float32), np.eye(4)[None],
                       np.eye(4)[None], device="cpu", trainable={"sdf": False})
    names = {g["name"]: g["lr"] for g in tt.opt.opt.param_groups}
    assert "sdf" not in names and names["mat/point_light_network"] == 1e-2
    assert all(lr == 1e-4 for n, lr in names.items() if n != "mat/point_light_network")
    g = np.random.default_rng(0)
    before = jax.tree_util.tree_map(np.copy, params_to_numpy(tt.params))
    for p in tt.params.parameters():
        p.grad = torch.as_tensor(g.normal(size=p.shape).astype(np.float32))
    net = tt.params["materials"]["diffuse_albedo_network"]
    grads = [N(p.grad) for p in net.parameters()]
    clipped, _ = optax.clip_by_global_norm(0.5).update(grads, None)
    tt.opt.step()
    for p, c in zip(net.parameters(), clipped):
        np.testing.assert_allclose(N(p.grad), np.asarray(c), rtol=1e-5, atol=1e-7)
    after = params_to_numpy(tt.params)
    for a, b in zip(jax.tree_util.tree_leaves(before["sdf"]),
                    jax.tree_util.tree_leaves(after["sdf"])):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(before["materials"]["diffuse_albedo_network"]["layers"][0]["v"],
                              after["materials"]["diffuse_albedo_network"]["layers"][0]["v"])


def test_run_draws_crops_as_the_jax_trainer():
    """Stage2Trainer.run: the JAX package's host crop formula, the step
    count, finite metrics, and the unported options raising."""
    d = render_synthetic_dataset("sphere", n_views=2, H=40, W=40, rig_kwargs={"focal": 50.0},
                                 device="cpu")
    cfg = Stage2Config(renderer_name="ggx", patch_size=24, sdf=SDFConfig(**NARROW),
                       surface=SurfaceRenderConfig(edge_budget=128))
    tt = Stage2Trainer(cfg, d["images"], d["Ks"], d["W2Cs"], device="cpu")
    seen = []
    step = tt.train_step
    tt.train_step = lambda i, c, r, e: seen.append((i, c, r, tuple(e.shape))) or step(i, c, r, e)
    m = tt.run(num_iters=2, seed=3)
    g = np.random.default_rng(4 * 1_000_003)
    assert seen == [(int(g.integers(0, 2)), int(g.integers(0, 16)), int(g.integers(0, 16)),
                     (288, 3)) for _ in range(2)]
    assert tt.step == 2 and all(np.isfinite(v) for v in m.values())
    with pytest.raises(NotImplementedError):
        tt.run(num_iters=2, steps_per_call=2)
    with pytest.raises(NotImplementedError):
        Stage2Trainer(dataclasses.replace(cfg, async_ckpt=True), d["images"], d["Ks"],
                      d["W2Cs"], device="cpu")
    with pytest.raises(ValueError):
        Stage2Trainer(dataclasses.replace(cfg, silhouette_weight=0.1), d["images"], d["Ks"],
                      d["W2Cs"], device="cpu")


# ---------------------------------------------------------------------------
# the training-mode render
# ---------------------------------------------------------------------------

def test_render_camera_training_gradients_match_jax(scene):
    """render_camera(is_training=True) at the narrow SDF of
    test_torch_render.py on a 32x32 crop that holds silhouette pixels: the
    gradient, with respect to every SDF parameter, of a weighted sum of the
    colour, the raw gradient, the edge uv and the edge side normals.  The
    shade function is a fixed smooth function of the points, normals and
    features, so the gradient is the render's alone: the reparam of the
    interior and side points, the normals and features of the fused core,
    and the differentiable edge uv.  Tolerances as the whole step's: roots
    agree to 5e-5, so the objective to rtol 2e-4 and each leaf to rtol 2e-3
    / atol 2e-3 of its largest entry."""
    jcfg = JSDFConfig(**NARROW)
    from iron_tpu.fields.sdf import init_sdf as j_init_sdf
    sdf = to_np(jax.jit(lambda k: j_init_sdf(k, jcfg))(jax.random.PRNGKey(3)))
    K, W2C = scene["Ks"][1], scene["W2Cs"][1]
    g = np.random.default_rng(0)
    wc, wg = (g.normal(size=(32, 32, 3)).astype(np.float32) for _ in range(2))
    we, wn = g.normal(size=(256, 2)).astype(np.float32), g.normal(size=(512, 3)).astype(np.float32)
    wf = g.normal(size=(32, 3)).astype(np.float32) * 0.1

    def shade(lib, ro, rd, pts, nrm, ft):
        n = nrm / (lib.linalg.norm(nrm, axis=-1, keepdims=True) if lib is jnp
                   else torch.linalg.norm(nrm, dim=-1, keepdim=True))
        return {"color": lib.sin(3.0 * pts) * n + lib.tanh(ft @ wf) + 0.1 * rd, "normal": n}

    def objective(res, lib):
        return (lib.sum(res["color"] * wc) + lib.sum(res["raw_grad"] * wg)
                + 1e-2 * lib.sum(res["edge_uv"] * we * res["edge_kept"][:, None])
                + lib.sum(res["edge_pos_neg_normal"] * wn))

    surf = dict(edge_budget=256)
    jcam = j_crop_camera(j_make_camera(K, W2C, 48, 48), 10, 10, 32, 32)

    def j_loss(p):
        res = j_render(lambda x: j_sdf_only(p, x, jcfg), lambda x: j_vfg(p, x, jcfg),
                       lambda *a: shade(jnp, *a), jcam, JSurf(**surf), is_training=True)
        return objective(res, jnp), res["edge_mask"].sum()

    (jl, n_edge), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(sdf)
    assert int(n_edge) > 20

    from iron_tpu_torch.core.camera import crop_camera
    from iron_tpu_torch.fields.sdf import sdf_from_numpy
    net = sdf_from_numpy(sdf, SDFConfig(**NARROW), "cpu")
    wc, wg, we, wn, wf = map(T, (wc, wg, we, wn, wf))
    res = render_camera(lambda x: sdf_only(net, x), lambda x: sdf_value_feat_grad(net, x),
                        lambda *a: shade(torch, *a),
                        crop_camera(make_camera(K, W2C, 48, 48, device="cpu"), 10, 10, 32, 32),
                        SurfaceRenderConfig(**surf), is_training=True)
    tl = objective(res, torch)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4)
    ref = _leaves(to_np(jg))
    got = _leaves({"layers": [{k: N(getattr(l, k).grad) for k in ("v", "g", "b")}
                              for l in net.layers]})
    assert set(ref) == set(got)
    for k, a in ref.items():
        np.testing.assert_allclose(got[k], a, rtol=2e-3,
                                   atol=2e-3 * float(np.abs(a).max()) + 1e-10, err_msg=k)


def test_reparam_points_value_and_gradient():
    """reparam_points: the value is the point itself; the gradient through
    the sdf value is -d / max(<grad, d>, 1e-4), as in JAX (the clip active
    on some rows)."""
    g = np.random.default_rng(1)
    pts, grads, dirs = (g.normal(size=(64, 3)).astype(np.float32) for _ in range(3))
    dirs[:8] = -grads[:8]                      # <grad, d> < 0: clipped to 1e-4
    sdf = g.normal(size=(64, 1)).astype(np.float32)
    w = g.normal(size=(64, 3)).astype(np.float32)
    jv = j_reparam(*map(jnp.asarray, (pts, grads, dirs, sdf)))
    jd = jax.grad(lambda s: jnp.sum(j_reparam(*map(jnp.asarray, (pts, grads, dirs)), s) * w))(
        jnp.asarray(sdf))
    s = T(sdf).requires_grad_(True)
    tv = reparam_points(T(pts), T(grads), T(dirs), s)
    (td,) = torch.autograd.grad((tv * T(w)).sum(), s)
    np.testing.assert_array_equal(N(tv), np.asarray(jv))
    np.testing.assert_allclose(N(td), np.asarray(jd), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# losses and regularisers (the cases of tests/test_losses.py, against JAX)
# ---------------------------------------------------------------------------

def _images(seed, n=2, size=64):
    g = np.random.default_rng(seed)
    return [g.uniform(size=(1, 3, size, size)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("size", [128, 37])
def test_pyramid_l2_matches_jax(size):
    a, b = _images(1, size=size)
    np.testing.assert_allclose(float(timg.pyramid_l2_loss(T(a), T(b))),
                               float(jimg.pyramid_l2_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    assert float(timg.pyramid_l2_loss(T(a), T(a))) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_ssim_matches_jax(masked):
    a, b = _images(2)
    mask = None
    if masked:
        mask = np.zeros((1, 1, 64, 64), bool)
        mask[:, :, 10:50, 18:60] = True
        mask[:, :, 30:34, :] = False           # a hole, so erosion is not trivial
    ref = jimg.ssim_loss(jnp.asarray(a), jnp.asarray(b), None if mask is None else jnp.asarray(mask))
    got = timg.ssim_loss(T(a), T(b), None if mask is None else T(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-6)
    assert abs(float(timg.ssim_loss(T(a), T(a), None if mask is None else T(mask)))) < 1e-5


def test_psnr_matches_jax():
    x = np.zeros((4, 4, 3), np.float32)
    np.testing.assert_allclose(float(timg.psnr(T(x), T(x + 0.1))), 20.0, atol=1e-3)
    a, b = _images(3, size=16)
    m = np.random.default_rng(0).uniform(size=(1, 3, 16, 16)) > 0.5
    for mask in (None, m):
        ref = jimg.psnr(jnp.asarray(a), jnp.asarray(b), None if mask is None else jnp.asarray(mask))
        got = timg.psnr(T(a), T(b), None if mask is None else T(mask))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_regularizers_match_jax():
    g = np.random.default_rng(4)
    grads = g.normal(size=(40, 3)).astype(np.float32)
    mask = g.uniform(size=40) > 0.3
    for m in (None, mask):
        rs, rc = jreg.eikonal_loss(jnp.asarray(grads), None if m is None else jnp.asarray(m))
        ts, tc = treg.eikonal_loss(T(grads), None if m is None else T(m))
        np.testing.assert_allclose(float(ts), float(rs), rtol=1e-5)
        assert float(tc) == float(rc)
    unit = grads / np.linalg.norm(grads, axis=-1, keepdims=True)
    assert float(treg.eikonal_loss(T(unit))[0]) < 1e-10
    np.testing.assert_allclose(float(treg.roughness_range_loss(
        T(np.float32([0.2, 0.6, 0.8])), T(np.ones(3, bool)), 0.5)), 0.2, atol=1e-6)
    rough = g.uniform(0, 1, size=40).astype(np.float32)
    np.testing.assert_allclose(float(treg.roughness_range_loss(T(rough), T(mask), 0.5)),
                               float(jreg.roughness_range_loss(jnp.asarray(rough),
                                                               jnp.asarray(mask), 0.5)), rtol=1e-6)
    eta, k = g.uniform(0, 3, size=40).astype(np.float32), g.uniform(0, 20, size=40).astype(np.float32)
    for a, b in zip(treg.metal_eta_k_loss(T(eta), T(k), T(mask)),
                    jreg.metal_eta_k_loss(jnp.asarray(eta), jnp.asarray(k), jnp.asarray(mask))):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    np.testing.assert_allclose(float(treg.dielectric_eta_loss(T(eta), T(mask))),
                               float(jreg.dielectric_eta_loss(jnp.asarray(eta), jnp.asarray(mask))),
                               rtol=1e-6)
    w = np.float32([[0.999], [0.001], [0.4]])
    mm = np.float32([[1.0], [0.0], [1.0]])
    np.testing.assert_allclose(float(treg.mask_bce_loss(T(w), T(mm))),
                               float(jreg.mask_bce_loss(jnp.asarray(w), jnp.asarray(mm))), rtol=1e-6)


# ---------------------------------------------------------------------------
# checkpoints and data
# ---------------------------------------------------------------------------

def test_checkpoints_both_ways(tmp_path, scene, jax_params):
    """A checkpoint the port writes is one the JAX package reads back (same
    tree, same arrays), and the port resumes from one the JAX package
    wrote; stage1_to_stage2 maps a stage-1 tree as the JAX package does."""
    _, tcfg = _step_cfgs()
    params = to_np(jax_params)
    j_save_checkpoint(str(tmp_path / "jax"), 12, params)
    tt = Stage2Trainer(tcfg, scene["images"], scene["Ks"], scene["W2Cs"], masks=scene["masks"],
                       out_dir=str(tmp_path / "jax"), device="cpu")
    assert tt.resume() == 12
    got = params_to_numpy(tt.params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)

    tt.out_dir, tt.step = str(tmp_path / "port"), 30
    tt.save()
    ck = j_load_checkpoint(str(tmp_path / "port" / "ckpt_0000030.pkl"))
    assert ck["step"] == 30 and ck["opt_state"] is None and set(ck) == {
        "params", "opt_state", "step", "extra"}
    assert jax.tree_util.tree_structure(ck["params"]) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(ck["params"]), jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    path = save_checkpoint(str(tmp_path / "tree"), 3, params, extra={"note": 1})
    assert j_load_checkpoint(path)["extra"] == {"note": 1}

    from iron_tpu.train.checkpoints import stage1_to_stage2 as j_s1_to_s2
    stage1 = {"sdf": params["sdf"], "color": params["materials"]["diffuse_albedo_network"]}
    other = params_to_numpy(Stage2Trainer(tcfg, scene["images"], scene["Ks"], scene["W2Cs"],
                                          masks=scene["masks"], device="cpu").params)
    for a, b in zip(jax.tree_util.tree_leaves(stage1_to_stage2(stage1, other)),
                    jax.tree_util.tree_leaves(j_s1_to_s2(stage1, other))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tt2 = Stage2Trainer(tcfg, scene["images"], scene["Ks"], scene["W2Cs"], masks=scene["masks"],
                        stage1_params=stage1, device="cpu")
    np.testing.assert_array_equal(params_to_numpy(tt2.params)["sdf"]["layers"][1]["v"],
                                  params["sdf"]["layers"][1]["v"])
    with pytest.raises(ValueError, match="stage-1 SDF"):
        Stage2Trainer(tcfg, scene["images"], scene["Ks"], scene["W2Cs"], masks=scene["masks"],
                      device="cpu", stage1_params={"sdf": {"layers": params["sdf"]["layers"][:2]}})


def test_validate_keeps_the_best_checkpoint(tmp_path):
    cfg = Stage2Config(renderer_name="ggx", sdf=SDFConfig(**NARROW))
    tt = Stage2Trainer(cfg, np.zeros((1, 8, 8, 3), np.float32), np.eye(4)[None],
                       np.eye(4)[None], out_dir=str(tmp_path), device="cpu")
    for step, metric in [(1, 0.5), (2, 0.7), (3, 0.6)]:
        tt.step = step
        tt._validate(lambda t, m=metric: {"metric": m, "psnr": 2 * m})
    ck = j_load_checkpoint(str(tmp_path / "ckpt_best.pkl"))
    assert ck["step"] == 2 and tt.best_step == 2 and ck["extra"]["val"]["metric"] == 0.7
    assert [v["step"] for v in tt.val_history] == [1, 2, 3]


def test_synthetic_dataset_matches_jax(scene):
    """The port's synthetic scene and rig reproduce the JAX package's images
    and coverage masks (roots agree to the tracer's 5e-5)."""
    d = render_synthetic_dataset("sphere", n_views=2, H=48, W=48, light=30.0,
                                 rig_kwargs={"focal": 60.0}, device="cpu")
    np.testing.assert_array_equal(d["Ks"], scene["Ks"])
    np.testing.assert_allclose(d["W2Cs"], scene["W2Cs"], atol=1e-6)
    np.testing.assert_array_equal(d["masks"], scene["masks"])
    np.testing.assert_allclose(d["images"], scene["images"], atol=1e-4, rtol=1e-4)


def test_ggx_tables_are_the_jax_packages_files():
    """The port's own copy of the two GGX tables is byte for byte the JAX
    package's, and the port reads its copy."""
    from iron_tpu_torch.shading import tables
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = sorted(os.listdir(os.path.join(repo, "iron_tpu", "assets", "ggx")))
    assert names == sorted(os.listdir(tables.ASSET_DIR))
    assert os.path.commonpath([tables.ASSET_DIR, os.path.join(repo, "iron_tpu_torch")]) == \
        os.path.join(repo, "iron_tpu_torch")
    for n in names:
        with open(os.path.join(repo, "iron_tpu", "assets", "ggx", n), "rb") as f, \
                open(os.path.join(tables.ASSET_DIR, n), "rb") as g:
            assert f.read() == g.read(), n
