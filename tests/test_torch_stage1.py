"""The port's stage-1 training (NeuS volume) against the JAX package on the
CPU: one whole step (loss, metrics, every gradient, the parameters after
Adam) with JAX's draws injected, the step through K3's plain versions
against plain autograd, the trainer's options, the ray dataset, the image
and camera IO (PNG without OpenCV, EXR, scene folders), and the stage-1
checkpoints both ways (a JAX one read where optax cannot be imported)."""
import dataclasses
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp
import optax

from iron_tpu.data import io as jio
from iron_tpu.data.dataset import RayDataset as JRayDataset
from iron_tpu.data.dataset import load_image_folder as j_load_image_folder
from iron_tpu.data.exr import read_exr as j_read_exr, write_exr as j_write_exr
from iron_tpu.data.synthetic import render_synthetic_dataset as j_synthetic
from iron_tpu.data.synthetic import write_scene_dir as j_write_scene_dir
from iron_tpu.fields.nerf import NeRFConfig as JNeRFConfig
from iron_tpu.fields.rendering import RenderingConfig as JRenderingConfig
from iron_tpu.fields.sdf import SDFConfig as JSDFConfig
from iron_tpu.train.checkpoints import load_checkpoint as j_load_checkpoint
from iron_tpu.train.checkpoints import stage1_to_stage2 as j_stage1_to_stage2
from iron_tpu.train.stage1 import Stage1Config as JStage1Config
from iron_tpu.train.stage1 import Stage1Trainer as JStage1Trainer
from iron_tpu.train.stage1 import stage1_loss as j_stage1_loss
from iron_tpu.train.schedules import cos_anneal_ratio as j_cos_anneal
from iron_tpu.train.schedules import warmup_cosine_schedule as j_schedule

from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.dataset import RayDataset, load_image_folder
from iron_tpu_torch.data.exr import read_exr, write_exr
from iron_tpu_torch.data.synthetic import write_scene_dir
from iron_tpu_torch.fields.nerf import NeRFConfig
from iron_tpu_torch.fields.rendering import RenderingConfig
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_only
from iron_tpu_torch.kernels import launch_counts, reset_launch_counts
from iron_tpu_torch.kernels.fused_sdf_grad import make_fused_sdf_grad_fn
from iron_tpu_torch.train.checkpoints import load_checkpoint, stage1_to_stage2
from iron_tpu_torch.train.stage1 import (Stage1Config, Stage1Draws, Stage1Trainer,
                                         stage1_loss, stage1_params_from_numpy,
                                         stage1_params_to_numpy)
from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer
from iron_tpu_torch.volume.integrator import NeuSRenderConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
COLOR = dict(d_feature=32, mode="idr", d_in=9, d_out=3, d_hidden=32, n_layers=4,
             multires=4, multires_view=2, squeeze_out=True, skip_in=(2,))
NERF = dict(D=2, W=32, skips=(0,))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def scene():
    """Two 48x48 views of the analytic sphere (JAX golden-oracle renderer)
    with their coverage masks; the sphere covers 13% of each view."""
    return j_synthetic("sphere", n_views=2, H=48, W=48, light=30.0, rig_kwargs={"focal": 60.0})


def _cfgs(**kw):
    """(JAX, port) stage-1 configs at the narrow width: the default render
    (64 + 64 samples, 4 up-sample rounds, 32 background samples, perturb
    1), the mask term on."""
    common = dict(batch_size=128, warm_up_end=100, end_iter=1000, anneal_end=400,
                  mask_weight=0.1, **kw)
    return (JStage1Config(sdf=JSDFConfig(**NARROW), nerf=JNeRFConfig(**NERF),
                          color=JRenderingConfig(**COLOR), **common),
            Stage1Config(sdf=SDFConfig(**NARROW), nerf=NeRFConfig(**NERF),
                         color=RenderingConfig(**COLOR), **common))


STEP = dict(step=100, count=60, key=7)


@pytest.fixture(scope="module")
def jax_step(scene):
    """One JAX step as Stage1Trainer's one_step runs it
    (iron_tpu/train/stage1.py:228-238) from an Adam state of count 60 with
    random moments, its gradients kept, and its draws: (params, opt state,
    draws, loss, metrics, grads, params after Adam)."""
    jcfg, _ = _cfgs()
    jds = JRayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], scene["masks"])
    tr = JStage1Trainer(jcfg, jds, key=jax.random.PRNGKey(0))
    params = tr.params
    tx = optax.adam(j_schedule(jcfg.learning_rate, jcfg.warm_up_end, jcfg.end_iter,
                               jcfg.learning_rate_alpha))
    adam, sched = tx.init(params)
    g = np.random.default_rng(3)
    mu = jax.tree_util.tree_map(lambda p: jnp.asarray(
        1e-3 * g.normal(size=p.shape).astype(np.float32)), params)
    nu = jax.tree_util.tree_map(lambda p: jnp.asarray(
        1e-6 * g.uniform(size=p.shape).astype(np.float32)), params)
    count = jnp.asarray(STEP["count"], jnp.int32)
    opt_state = (adam._replace(count=count, mu=mu, nu=nu), sched._replace(count=count))
    key = jax.random.PRNGKey(STEP["key"])

    @jax.jit
    def step(p, o):
        k_img, k_ray, k_render = jax.random.split(key, 3)
        img_idx = jax.random.randint(k_img, (), 0, jds.n_images)
        batch = jds.gen_random_rays(k_ray, img_idx, jcfg.batch_size)
        anneal = j_cos_anneal(STEP["step"], jcfg.anneal_end)
        (loss, m), gr = jax.value_and_grad(j_stage1_loss, has_aux=True)(
            p, jcfg, batch, k_render, anneal, None)
        updates, _ = tx.update(gr, o, p)
        return loss, m, gr, optax.apply_updates(p, updates)

    loss, m, gr, new = step(params, opt_state)
    k_img, k_ray, k_render = jax.random.split(key, 3)
    kx, ky = jax.random.split(k_ray)
    k1, k2 = jax.random.split(k_render)
    B = jcfg.batch_size
    draws = {"img_idx": np.asarray(jax.random.randint(k_img, (), 0, jds.n_images)),
             "px": np.asarray(jax.random.randint(kx, (B,), 0, 48)),
             "py": np.asarray(jax.random.randint(ky, (B,), 0, 48)),
             "t_rand": np.asarray(jax.random.uniform(k1, (B, 1)) - 0.5),
             "t_rand_outside": np.asarray(jax.random.uniform(k2, (B, 32)))}
    return {"params": to_np(params), "mu": to_np(mu), "nu": to_np(nu), "draws": draws,
            "loss": float(loss), "metrics": {k: float(v) for k, v in m.items()},
            "grads": to_np(gr), "new": to_np(new)}


def _port_trainer(scene, cfg, device="cpu"):
    ds = RayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], scene["masks"],
                                device=device)
    return Stage1Trainer(cfg, ds, device=device)


def _draws(d):
    return Stage1Draws(img_idx=T(d["img_idx"]).long(), px=T(d["px"]).long(),
                       py=T(d["py"]).long(), t_rand=T(d["t_rand"]),
                       t_rand_outside=T(d["t_rand_outside"]))


def test_one_training_step_matches_jax(scene, jax_step):
    """One stage-1 step of Stage1Trainer.train_step from the JAX parameters
    and Adam state (count 60, random moments, carried across as resume
    carries them), on JAX's draws (image, pixels, per-ray and background
    jitter): the loss and every metric to 2e-4 relative; every gradient leaf
    to rtol 2e-3 and 2e-3 of the leaf's largest entry, as
    tests/test_torch_train.py::test_one_training_step_matches_jax holds the
    stage-2 step (the up-sampled z follow the f32 sdf steeply,
    tests/test_torch_volume.py); every parameter after Adam to 2e-3 of its
    leaf's largest entry, and its update to 2e-3 of the leaf's largest
    update (+ the f32 rounding of p + dp)."""
    _, tcfg = _cfgs()
    tt = _port_trainer(scene, tcfg)
    tt.params = stage1_params_from_numpy(jax_step["params"], tcfg, "cpu")
    tt.opt = tt._adam()
    tt._seed_adam(STEP["count"], jax_step["mu"], jax_step["nu"])
    tt.opt_count, tt.step = STEP["count"], STEP["step"]
    tm = tt.train_step(_draws(jax_step["draws"]))

    jm = jax_step["metrics"]
    assert set(tm) == set(jm)
    assert jm["weight_max"] > 0.01 and jm["mask_loss"] > 0
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), v, rtol=2e-4, atol=1e-7, err_msg=k)

    ref_g = _leaves(jax_step["grads"])
    got_g = _leaves(stage1_params_to_numpy(
        tt.params, lambda p: p.grad if p.grad is not None else torch.zeros_like(p)))
    assert set(got_g) == set(ref_g)
    for k, a in ref_g.items():
        np.testing.assert_allclose(got_g[k], a, rtol=2e-3,
                                   atol=2e-3 * float(np.abs(a).max()) + 1e-10, err_msg=k)

    old, ref_p = _leaves(jax_step["params"]), _leaves(jax_step["new"])
    got_p = _leaves(stage1_params_to_numpy(tt.params))
    for k, a in ref_p.items():
        np.testing.assert_allclose(got_p[k], a, rtol=0, atol=2e-3 * float(np.abs(a).max()),
                                   err_msg=k)
        du_ref, du_got = a - old[k], got_p[k] - old[k]
        err = np.abs(du_got - du_ref) - 1e-7 * np.abs(a)
        assert np.all(err <= 2e-3 * float(np.abs(du_ref).max()) + 1e-12), k
    assert np.any(ref_p["['sdf']['layers'][0]['v']"] != old["['sdf']['layers'][0]['v']"])
    assert tt.opt_count == STEP["count"] + 1 and tt.step == STEP["step"] + 1


K3_SDF = dict(d_out=33, d_hidden=256, n_layers=3, skip_in=(2,), multires=2)


def test_stage1_loss_through_k3_plain_matches_autograd(scene):
    """The render's SDF core through K3's wrappers (the card's route:
    _FusedSdfCore, K3-fwd forward and K3-bwd backward; their plain versions
    on a CPU tensor, no kernel launched) against plain autograd, at the
    hidden width the kernels take: loss to 1e-5, every gradient leaf to
    1e-4 of its largest entry (f32 sums in another order); and the
    validation render through K3-fwd alone to 1e-5."""
    cfg = Stage1Config(batch_size=32, mask_weight=0.1, sdf=SDFConfig(**K3_SDF),
                       nerf=NeRFConfig(**NERF), color=RenderingConfig(**COLOR),
                       render=NeuSRenderConfig(n_samples=16, n_importance=16, n_outside=8,
                                               up_sample_steps=2))
    tt = _port_trainer(scene, cfg)
    batch = tt.dataset.gen_random_rays(1, 32, generator=torch.Generator().manual_seed(2))
    gen = lambda: torch.Generator().manual_seed(5)
    sdf = tt.params["sdf"]
    out = {}
    reset_launch_counts()
    for route in ("autograd", "k3"):
        fns = None if route == "autograd" else {"sdf_fn": lambda p: sdf_only(sdf, p),
                                                "sdf_all_fn": make_fused_sdf_grad_fn(sdf)}
        tt.opt.zero_grad(set_to_none=True)
        loss, m = stage1_loss(tt.params, cfg, batch, 0.4, generator=gen(), fns=fns)
        loss.backward()
        out[route] = (float(loss), _leaves(stage1_params_to_numpy(tt.params, lambda p: p.grad)))
    assert all(v == 0 for v in launch_counts().values())
    np.testing.assert_allclose(out["k3"][0], out["autograd"][0], rtol=1e-5)
    for k, a in out["autograd"][1].items():
        np.testing.assert_allclose(out["k3"][1][k], a, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(a).max()) + 1e-12, err_msg=k)
    ref = tt.render_image(0, resolution_level=4)
    got = tt.render_image(0, resolution_level=4, fns={"sdf_fn": lambda p: sdf_only(sdf, p),
                                                      "sdf_all_fn": make_fused_sdf_grad_fn(sdf)})
    for k in ("color", "normal"):
        assert got[k].shape == (12, 12, 3)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("route", ["autograd", "k3"])
def test_remat_core_step_matches_the_kept_step(scene, monkeypatch, route):
    """remat_core (the colour network recomputed in the backward through
    torch.utils.checkpoint) changes no number of a train_step: from the same
    parameters on the same draws, the loss and every metric to 1e-6
    relative, every gradient leaf and every parameter after Adam to 1e-6 of
    its largest entry.  Through plain autograd, and through K3's wrappers
    (the card's route, their plain versions on a CPU tensor), where the
    recomputed colour net takes K3-fwd's features and gradients and hands
    its cotangents to K3-bwd."""
    import iron_tpu_torch.train.stage1 as S1
    if route == "k3":
        monkeypatch.setattr(S1, "build_stage1_fns", lambda params, cfg: {
            "sdf_fn": lambda p: sdf_only(params["sdf"], p),
            "sdf_all_fn": make_fused_sdf_grad_fn(params["sdf"])})
    base = Stage1Config(batch_size=32, mask_weight=0.1, sdf=SDFConfig(**K3_SDF),
                        nerf=NeRFConfig(**NERF), color=RenderingConfig(**COLOR),
                        render=NeuSRenderConfig(n_samples=16, n_importance=16, n_outside=8,
                                                up_sample_steps=2))
    ds = RayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], scene["masks"],
                                device="cpu")
    out, recomputed = {}, []
    monkeypatch.setattr(S1, "checkpoint",
                        lambda *a, _f=S1.checkpoint, **k: recomputed.append(1) or _f(*a, **k))
    reset_launch_counts()
    for remat in (False, True):
        tt = Stage1Trainer(dataclasses.replace(base, remat_core=remat), ds,
                           generator=torch.Generator().manual_seed(8), device="cpu")
        tt.step = 300
        m = tt.train_step(tt.draw(torch.Generator().manual_seed(9)))
        out[remat] = ({k: float(v) for k, v in m.items()},
                      _leaves(stage1_params_to_numpy(tt.params, lambda p: p.grad)),
                      _leaves(stage1_params_to_numpy(tt.params)))
        assert len(recomputed) == int(remat)
    assert all(v == 0 for v in launch_counts().values())
    (m0, g0, p0), (m1, g1, p1) = out[False], out[True]
    assert set(m1) == set(m0) and m0["loss"] > 0
    for k, v in m0.items():
        np.testing.assert_allclose(m1[k], v, rtol=1e-6, atol=1e-12, err_msg=k)
    for ref, got in ((g0, g1), (p0, p1)):
        assert set(got) == set(ref)
        for k, a in ref.items():
            np.testing.assert_allclose(got[k], a, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(a).max()) + 1e-12, err_msg=k)
    assert np.abs(g0["['color']['layers'][0]['v']"]).max() > 0


def test_trainer_run_occupancy_and_unported_options(scene, tmp_path):
    """Stage1Trainer.run on the CPU: the draws' shapes, the step count,
    finite metrics, the occupancy grid refreshed on its schedule (one step
    a call: every occupancy_update_every-th step), a save / resume round
    trip (Adam's moments and count included), an async save equal to the
    blocking one, the validation and novel-view renders; CUDA without a
    card raises; steps_per_call=2 runs two steps a chunk with the grid
    refreshed at the chunk's start (JAX's rule)."""
    _, cfg = _cfgs(use_occupancy=True, occupancy_update_every=2,
                   render=NeuSRenderConfig(n_samples=16, n_importance=16, n_outside=8,
                                           up_sample_steps=2))
    cfg = dataclasses.replace(cfg, batch_size=32)
    tt = _port_trainer(scene, cfg)
    tt.out_dir = str(tmp_path)
    d = tt.draw(torch.Generator().manual_seed(0))
    assert d.img_idx.shape == () and d.px.shape == d.py.shape == (32,)
    assert d.t_rand.shape == (32, 1) and d.t_rand_outside.shape == (32, 8)
    assert d.occ_u.shape == (32, 16) and float(d.t_rand.abs().max()) <= 0.5
    grids = []
    update = tt.update_occupancy
    tt.update_occupancy = lambda: grids.append(tt.step) or update()
    history = []
    m = tt.run(num_iters=3, seed=1, history=history, steps_per_call=1)
    assert tt.step == 3 and len(history) == 3 and grids == [0, 2]
    assert all(np.isfinite(v) for v in m.values()) and tt._occ_grid.shape == (64, 64, 64)
    tt.save()
    tt2 = _port_trainer(scene, cfg)
    tt2.out_dir = str(tmp_path)
    assert tt2.resume() == 3 and tt2.opt_count == 3
    for p, q in zip(tt.params.parameters(), tt2.params.parameters()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(tt.opt.state[p][key], tt2.opt.state[q][key])
        assert float(tt2.opt.state[q]["step"]) == 3
    assert tt.render_image(1, resolution_level=8)["normal"].shape == (6, 6, 3)
    assert np.isfinite(tt.render_novel_view(0, 1, 0.5, resolution_level=8)).all()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Stage1Trainer(cfg, tt.dataset, device="cuda")
    ta = Stage1Trainer(dataclasses.replace(cfg, async_ckpt=True), tt.dataset, device="cpu",
                       out_dir=str(tmp_path / "async"))
    ta.params, ta.opt, ta.opt_count, ta.step = tt.params, tt.opt, tt.opt_count, tt.step
    ta.save()
    ta.wait_for_saves()
    got = load_checkpoint(str(tmp_path / "async" / "ckpt_0000003.pkl"))
    want = load_checkpoint(str(tmp_path / "ckpt_0000003.pkl"))
    assert _leaves(got).keys() == _leaves(want).keys()
    for k, a in _leaves(want).items():
        np.testing.assert_array_equal(_leaves(got)[k], a, err_msg=k)
    tt.run(num_iters=2, steps_per_call=2, history=history)
    assert tt.step == 5 and len(history) == 5 and grids == [0, 2, 3]


def test_unported_modes_raise_on_a_cuda_device(scene, monkeypatch):
    """On a CUDA device the SDF core runs only through K3: normals_mode
    other than 'pallas' raises there, before anything is allocated (the
    device is stood in for, this machine has no card); on the CPU every
    mode is the plain core."""
    import iron_tpu_torch.train.stage1 as S1
    _, cfg = _cfgs(normals_mode="vjp")
    ds = RayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], device="cpu")
    monkeypatch.setattr(S1, "resolve_device", lambda device="cuda": torch.device(device))
    with pytest.raises(NotImplementedError, match="normals_mode"):
        Stage1Trainer(cfg, ds, device="cuda")
    assert Stage1Trainer(cfg, ds, device="cpu").step == 0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_ray_dataset_matches_jax(scene):
    """Rays at JAX's random pixels (the colour and mask gathered there), the
    full ray grid at a downsample level and the slerped novel-view rays, to
    1e-6; the camera of a view."""
    jds = JRayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], scene["masks"])
    ds = RayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], scene["masks"],
                                device="cpu")
    key = jax.random.PRNGKey(4)
    kx, ky = jax.random.split(key)
    px, py = jax.random.randint(kx, (200,), 0, 48), jax.random.randint(ky, (200,), 0, 48)
    ref = np.asarray(jds.gen_random_rays(key, 1, 200))
    got = N(ds.gen_random_rays(T(np.int64(1)), 200, px=T(px).long(), py=T(py).long()))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[:, 6:], ref[:, 6:])
    for a, b in zip(ds.gen_rays_grid(1, resolution_level=2), jds.gen_rays_grid(1, 2)):
        assert a.shape == (24, 24, 3)
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(ds.gen_rays_between(0, 1, 0.3, 3), jds.gen_rays_between(0, 1, 0.3, 3)):
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    cam, jcam = ds.camera(1), jds.camera(1)
    np.testing.assert_allclose(N(cam.C2W), np.asarray(jcam.C2W), rtol=1e-6, atol=1e-6)
    assert (cam.H, cam.W) == (jcam.H, jcam.W) == (48, 48)
    g = torch.Generator().manual_seed(0)
    b = ds.gen_random_rays(0, 64, generator=g)
    assert b.shape == (64, 10) and torch.isfinite(b).all()


def test_from_folder_and_png_decode_match_the_jax_loader():
    """RayDataset.from_folder on tests/data_singleview/ holds the JAX
    loader's arrays bit for bit: the port's PNG decode of 12.png (no
    OpenCV) equals cv2's."""
    import cv2
    data = os.path.join(REPO, "tests", "data_singleview")
    png = read = tio.read_png(os.path.join(data, "12.png"))
    assert png.shape == (512, 512, 3) and png.dtype == np.uint8
    np.testing.assert_array_equal(read, cv2.imread(os.path.join(data, "12.png"),
                                                   cv2.IMREAD_UNCHANGED)[..., ::-1])
    jf, jimgs, jKs, jW2Cs, jmasks = j_load_image_folder(data, folder_name=".")
    f, imgs, Ks, W2Cs, masks = load_image_folder(data, folder_name=".")
    assert [os.path.basename(p) for p in f] == [os.path.basename(p) for p in jf] == ["12.png"]
    for a, b in ((imgs, jimgs), (Ks, jKs), (W2Cs, jW2Cs), (masks, jmasks)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ds = RayDataset.from_folder(data, folder_name=".", device="cpu")
    jds = JRayDataset.from_folder(data, folder_name=".")
    for k in ("images", "masks", "Ks", "W2Cs"):
        np.testing.assert_array_equal(N(getattr(ds, k)), np.asarray(getattr(jds, k)), err_msg=k)


def _png_with_filters(img: np.ndarray, ftypes) -> bytes:
    """A PNG of uint8 / uint16 img [H, W, C] whose row y is filtered with
    ftypes[y % len(ftypes)] (the PNG spec's encoder of filters 0-4)."""
    H, W, C = img.shape
    depth = 8 if img.dtype == np.uint8 else 16
    raw = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    raw = raw.reshape(H, -1).astype(np.int32)
    bpp = C * depth // 8
    out = []
    for y in range(H):
        ft, cur = ftypes[y % len(ftypes)], raw[y]
        prior = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    color = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    chunk = lambda t, b: struct.pack(">I", len(b)) + t + b + struct.pack(
        ">I", zlib.crc32(t + b) & 0xFFFFFFFF)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color,
                                                              0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
def test_png_codec_filters_channels_and_depths(tmp_path, depth):
    """read_png of images written with every filter type (0-4, each on every
    fifth row) for gray, gray + alpha, RGB and RGBA gives the pixels back;
    write_png's files decode to the same pixels in cv2; read_image converts
    as the JAX package does (alpha dropped, gray to RGB, / 255 or / 65535);
    a palette file (PIL's, with PLTE) reads as cv2 reads it, to RGB, and
    converts as the JAX package converts it."""
    import cv2
    g = np.random.default_rng(depth)
    dt = np.uint8 if depth == 8 else np.uint16
    for C in (1, 2, 3, 4):
        img = np.cumsum(g.integers(0, 40, size=(13, 17, C)), axis=1).astype(dt)
        path = str(tmp_path / f"f{C}.png")
        with open(path, "wb") as f:
            f.write(_png_with_filters(img, (0, 1, 2, 3, 4)))
        np.testing.assert_array_equal(tio.read_png(path), img)
        w_path = str(tmp_path / f"w{C}.png")
        tio.write_png(w_path, img)
        np.testing.assert_array_equal(tio.read_png(w_path), img)
        ref = cv2.imread(w_path, cv2.IMREAD_UNCHANGED)
        ref = ref[..., None] if ref.ndim == 2 else ref
        if C >= 3:
            rgb = ref[..., 2::-1]
            np.testing.assert_array_equal(rgb, img[..., :3])
        if C != 2:   # cv2 expands gray + alpha to BGRA
            np.testing.assert_array_equal(jio.read_image(w_path), tio.read_image(w_path))
    from PIL import Image
    rgb = g.integers(0, 256, size=(7, 11, 3)).astype(np.uint8)
    Image.fromarray(rgb).quantize(5).save(str(tmp_path / "p.png"))
    got = tio.read_png(str(tmp_path / "p.png"))
    assert got.shape == (7, 11, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "p.png"),
                                                  cv2.IMREAD_UNCHANGED)[..., ::-1])
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / "p.png")),
                                  jio.read_image(str(tmp_path / "p.png")))


def test_exr_round_trip_both_packages(tmp_path):
    """EXR written by the port (half / zips, float / none, gray) reads back
    in both packages, one written by the JAX package reads in the port, and
    read_image of an EXR (1/2.2 gamma, gray to RGB) equals the JAX
    package's."""
    g = np.random.default_rng(0)
    img = g.uniform(0, 4, size=(9, 14, 3)).astype(np.float32)
    for half, comp in ((True, "zips"), (False, "none")):
        p = str(tmp_path / f"t{half}.exr")
        write_exr(p, img, half=half, compression=comp)
        want = img.astype(np.float16).astype(np.float32) if half else img
        np.testing.assert_array_equal(read_exr(p), want)
        np.testing.assert_array_equal(j_read_exr(p), want)
        np.testing.assert_array_equal(tio.read_image(p), jio.read_image(p))
    p = str(tmp_path / "j.exr")
    j_write_exr(p, img[..., :1], half=False)
    np.testing.assert_array_equal(read_exr(p), img[..., :1])
    np.testing.assert_array_equal(tio.read_image(p), jio.read_image(p))
    assert tio.read_image(p).shape == (9, 14, 3)


def test_write_scene_dir_round_trip_with_the_jax_loader(tmp_path):
    """A scene folder written by the port (PNG images and masks, the cam
    dict, the un-normalised cam dict) loads in the JAX package (cv2 decodes
    the PNGs) to the port loader's arrays, and its cam dicts are the JAX
    writer's."""
    g = np.random.default_rng(1)
    data = {"images": g.uniform(size=(2, 10, 12, 3)).astype(np.float32),
            "masks": (g.uniform(size=(2, 10, 12, 1)) > 0.5).astype(np.float32),
            "Ks": np.stack([np.eye(4, dtype=np.float32)] * 2),
            "W2Cs": np.stack([np.eye(4, dtype=np.float32)] * 2)}
    data["W2Cs"][1, :3, 3] = [0.1, -0.2, 3.0]
    write_scene_dir(data, str(tmp_path / "port"), denormalize=(np.float32([0.1, 0, 0]), 0.5))
    j_write_scene_dir(data, str(tmp_path / "jax"), denormalize=(np.float32([0.1, 0, 0]), 0.5))
    ref = j_load_image_folder(str(tmp_path / "port"), mask_dir=str(tmp_path / "port" / "masks"))
    got = load_image_folder(str(tmp_path / "port"), mask_dir=str(tmp_path / "port" / "masks"))
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], np.floor(255 * data["images"]) / 255)
    for name in ("cam_dict_norm.json", "cam_dict.json"):
        with open(tmp_path / "port" / name) as f, open(tmp_path / "jax" / name) as h:
            assert json.load(f) == json.load(h), name


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory, jax_step):
    """A stage-1 checkpoint written by the JAX trainer: the step fixture's
    parameters and Adam state (count 60), at step 100."""
    out = str(tmp_path_factory.mktemp("jax_stage1"))
    jcfg, _ = _cfgs()
    jds = JRayDataset.from_arrays(np.zeros((1, 4, 4, 3), np.float32), np.eye(4)[None],
                                  np.eye(4)[None])
    tr = JStage1Trainer(jcfg, jds, key=jax.random.PRNGKey(0), out_dir=out)
    tr.params = jax_step["params"]
    adam, sched = tr.opt_state
    count = jnp.asarray(STEP["count"], jnp.int32)
    tr.opt_state = (adam._replace(count=count, mu=jax_step["mu"], nu=jax_step["nu"]),
                    sched._replace(count=count))
    tr.step = STEP["step"]
    tr.save()
    return out


def test_jax_checkpoint_loads_without_optax_and_resumes(scene, jax_step, jax_ckpt):
    """A JAX stage-1 checkpoint loads in a process where optax and JAX
    cannot be imported (optax's two state classes read as the port's
    stand-ins), and Stage1Trainer.resume takes its parameters, Adam's
    moments and count and the step."""
    path = os.path.join(jax_ckpt, "ckpt_0000100.pkl")
    code = ("import sys, json\n"
            "sys.modules['optax'] = None\nsys.modules['jax'] = None\n"
            "from iron_tpu_torch.train.checkpoints import load_checkpoint\n"
            f"ck = load_checkpoint({path!r})\n"
            "a, s = ck['opt_state']\n"
            "print(json.dumps([type(a).__name__, type(s).__name__, int(a.count), int(s.count),\n"
            "                  ck['step'], sorted(ck['params']), ck['extra']['sdf_config']['d_out'],\n"
            "                  [m for m in sys.modules if m.split('.')[0] in ('optax', 'jax')\n"
            "                   and sys.modules[m] is not None]]))\n")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        "ScaleByAdamState", "ScaleByScheduleState", 60, 60, 100,
        ["color", "nerf", "sdf", "variance"], 33, []]

    _, tcfg = _cfgs()
    tt = _port_trainer(scene, tcfg)
    tt.out_dir = jax_ckpt
    assert tt.resume() == STEP["step"] and tt.opt_count == STEP["count"]
    got = _leaves(stage1_params_to_numpy(tt.params))
    for k, a in _leaves(jax_step["params"]).items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    for key, tree in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        moments = _leaves(stage1_params_to_numpy(tt.params, lambda p: tt.opt.state[p][key]))
        for k, a in _leaves(jax_step[tree]).items():
            np.testing.assert_array_equal(moments[k], a, err_msg=k)
    assert all(float(tt.opt.state[p]["step"]) == STEP["count"] for p in tt.params.parameters())


def test_port_checkpoint_resumes_in_jax_and_feeds_stage2(scene, jax_step, tmp_path):
    """A stage-1 checkpoint written by the port: the JAX trainer's resume
    takes its parameters (the JAX tree, dtypes and shapes) and its step, and
    starts a fresh optimizer (opt_state None); the port's Adam moments ride
    in extra["adam"]; stage1_to_stage2 maps it alike in both packages, and
    the port's Stage2Trainer warm-starts from it."""
    _, tcfg = _cfgs()
    tt = _port_trainer(scene, tcfg)
    tt.params = stage1_params_from_numpy(jax_step["params"], tcfg, "cpu")
    tt.opt = tt._adam()
    tt._seed_adam(STEP["count"], jax_step["mu"], jax_step["nu"])
    tt.opt_count, tt.step, tt.out_dir = STEP["count"], 40, str(tmp_path)
    tt.save()
    ck = j_load_checkpoint(str(tmp_path / "ckpt_0000040.pkl"))
    assert ck["opt_state"] is None and ck["extra"]["adam"]["count"] == STEP["count"]
    assert ck["extra"]["sdf_config"] == dataclasses.asdict(JSDFConfig(**NARROW))
    assert ck["extra"]["color_config"] == dataclasses.asdict(JRenderingConfig(**COLOR))

    jcfg, _ = _cfgs()
    jds = JRayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], scene["masks"])
    jtr = JStage1Trainer(jcfg, jds, key=jax.random.PRNGKey(1), out_dir=str(tmp_path))
    fresh = jax.tree_util.tree_map(np.asarray, jtr.opt_state)
    assert jtr.resume() == 40
    assert jax.tree_util.tree_structure(jtr.params) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(jnp.asarray, jax_step["params"]))
    for (k, a), b in zip(_leaves(jtr.params).items(), _leaves(jax_step["params"]).values()):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(jtr.opt_state), jax.tree_util.tree_leaves(fresh)):
        np.testing.assert_array_equal(np.asarray(a), b)

    s2cfg = Stage2Config(renderer_name="comp", sdf=SDFConfig(**NARROW))
    s2 = Stage2Trainer(s2cfg, scene["images"], scene["Ks"], scene["W2Cs"], device="cpu")
    from iron_tpu_torch.train.checkpoints import params_to_numpy
    stage2 = params_to_numpy(s2.params)
    stage1 = load_checkpoint(str(tmp_path / "ckpt_0000040.pkl"))["params"]
    for a, b in zip(jax.tree_util.tree_leaves(stage1_to_stage2(stage1, stage2)),
                    jax.tree_util.tree_leaves(j_stage1_to_stage2(ck["params"], stage2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    warm = Stage2Trainer(s2cfg, scene["images"], scene["Ks"], scene["W2Cs"], device="cpu",
                         stage1_params=stage1)
    np.testing.assert_array_equal(params_to_numpy(warm.params)["sdf"]["layers"][2]["v"],
                                  jax_step["params"]["sdf"]["layers"][2]["v"])
