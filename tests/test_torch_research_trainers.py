"""The port's research trainers against the JAX package on the CPU, at
narrow widths: the RGB + NIR stage 1 (one RGB step, then one NIR step,
against the JAX trainer's jitted steps with their draws injected; the
phases; the checkpoints both ways) and the hash-grid NeRF runner (one step
for each set of scene switches, against the JAX trainer's step; the
envmap lookup).

Both steps start from an Adam state of count 60 with random moments, as
tests/test_torch_stage1.py does: a fresh Adam's first update is lr * g /
(|g| + eps), whose sign follows rounding where g is rounding residue."""
import dataclasses

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.data.dataset import RayDataset as JRayDataset
from iron_tpu.data.synthetic import render_synthetic_dataset as j_synthetic
from iron_tpu.fields.hashgrid import HashGridConfig as JGrid
from iron_tpu.fields.hashgrid import HashNeRFConfig as JHNeRF
from iron_tpu.fields.hashgrid import HashRenderingConfig as JHRend
from iron_tpu.fields.hashgrid import HashSDFConfig as JHSDF
from iron_tpu.fields.nerf import NeRFConfig as JNeRFConfig
from iron_tpu.fields.rendering import RenderingConfig as JRenderingConfig
from iron_tpu.fields.sdf import SDFConfig as JSDFConfig
from iron_tpu.train.checkpoints import load_checkpoint as j_load_checkpoint
from iron_tpu.train.nerf_runner import HashNeRFTrainer as JHashNeRFTrainer
from iron_tpu.train.nerf_runner import NeRFRunnerConfig as JRunnerConfig
from iron_tpu.train.nerf_runner import envmap_color as j_envmap_color
from iron_tpu.train.stage1 import Stage1Config as JStage1Config
from iron_tpu.train.stage1_multispectral import MultiSpectralConfig as JMSConfig
from iron_tpu.train.stage1_multispectral import MultiSpectralStage1Trainer as JMSTrainer
from iron_tpu.volume.integrator import NeuSRenderConfig as JNeuS

from iron_tpu_torch.data.dataset import RayDataset
from iron_tpu_torch.fields.hashgrid import (HashGridConfig, HashNeRFConfig,
                                            HashRenderingConfig, HashSDFConfig)
from iron_tpu_torch.fields.nerf import NeRFConfig
from iron_tpu_torch.fields.rendering import RenderingConfig
from iron_tpu_torch.fields.sdf import SDFConfig
from iron_tpu_torch.train.nerf_runner import (HashNeRFTrainer, NeRFRunnerConfig, envmap_color,
                                              runner_params_from_numpy, runner_params_to_numpy)
from iron_tpu_torch.train.stage1 import Stage1Config, Stage1Draws
from iron_tpu_torch.train.stage1_multispectral import (MultiSpectralConfig,
                                                       MultiSpectralStage1Trainer,
                                                       modality_view,
                                                       multispectral_params_from_numpy,
                                                       multispectral_params_to_numpy)
from iron_tpu_torch.volume.integrator import NeuSRenderConfig

T = lambda a: torch.as_tensor(np.asarray(a))
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
COLOR = dict(d_feature=32, mode="idr", d_in=9, d_out=3, d_hidden=32, n_layers=4, multires=4,
             multires_view=2, squeeze_out=True, skip_in=(2,))
NERF = dict(D=2, W=32, skips=(0,))
RENDER = dict(n_samples=16, n_importance=16, n_outside=8, up_sample_steps=2, perturb=1.0)
COUNT = 60


def _leaves(tree):
    """{path: a copy of the leaf} (a CPU tensor's .numpy() shares its
    storage with the parameter, which the next update overwrites)."""
    return {jax.tree_util.keystr(k): np.array(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _random_moments(params, seed):
    """Adam moments of params' shapes drawn from a numpy seed: mu ~ 1e-3 N(0,
    1), nu ~ 1e-6 U(0, 1)."""
    g = np.random.default_rng(seed)
    mu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(1e-3 * g.normal(size=np.shape(p)).astype(np.float32)), params)
    nu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(1e-6 * g.uniform(size=np.shape(p)).astype(np.float32)), params)
    return mu, nu


def _optax_state(tx, params, mu, nu):
    adam, sched = tx.init(params)
    count = jnp.asarray(COUNT, jnp.int32)
    return (adam._replace(count=count, mu=mu, nu=nu), sched._replace(count=count))


def _seed_adam(opt, params, path_of, mu, nu):
    """torch.optim.Adam's state from optax moments: each parameter's leaf at
    path_of(name)."""
    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return torch.as_tensor(np.asarray(tree, np.float32)).clone()

    for name, p in params.named_parameters():
        path = path_of(name)
        opt.state[p] = {"step": torch.tensor(float(COUNT)),
                        "exp_avg": leaf(mu, path).reshape(p.shape),
                        "exp_avg_sq": leaf(nu, path).reshape(p.shape)}


def _jax_path(name):
    return [int(k) if k.isdigit() else k for k in name.split(".") if k != "heads"]


def _draws(key, n_images, B, hw, n_outside, split_render=True):
    """The draws of a JAX step's key: image, pixels (gen_random_rays), the
    per-ray and background jitter (neus_render's key split; a plain NeRF
    render takes its key whole)."""
    k_img, k_ray, k_r = jax.random.split(key, 3)
    kx, ky = jax.random.split(k_ray)
    H, W = hw
    d = {"img_idx": jax.random.randint(k_img, (), 0, n_images),
         "px": jax.random.randint(kx, (B,), 0, W), "py": jax.random.randint(ky, (B,), 0, H)}
    if split_render:
        k1, k2 = jax.random.split(k_r)
        d["t_rand"] = jax.random.uniform(k1, (B, 1)) - 0.5
        if n_outside:
            d["t_rand_outside"] = jax.random.uniform(k2, (B, n_outside))
    else:
        d["t_rand"] = jax.random.uniform(k_r, (B, 1)) - 0.5
    d = {k: T(np.asarray(v)) for k, v in d.items()}
    for k in ("img_idx", "px", "py"):
        d[k] = d[k].long()
    return Stage1Draws(**d)


def _hold_leaves(got, ref, label):
    """Every leaf (of two _leaves dicts) within 2e-3 of its largest entry."""
    assert set(got) == set(ref), label
    for k, a in ref.items():
        np.testing.assert_allclose(got[k], a, rtol=0,
                                   atol=2e-3 * float(np.abs(a).max()) + 1e-12,
                                   err_msg=f"{label} {k}")


# ---------------------------------------------------------------------------
# RGB + NIR stage 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spectra():
    """The sphere at light 30 (RGB) and at light 20 with the band mean
    replicated to 3 channels (NIR), as tests/test_multispectral.py builds
    them: 2 views of 32x32."""
    rgb = j_synthetic("sphere", n_views=2, H=32, W=32, light=30.0, rig_kwargs={"focal": 40.0})
    nir = j_synthetic("sphere", n_views=2, H=32, W=32, light=20.0, rig_kwargs={"focal": 40.0})
    nir["images"] = np.repeat(nir["images"].mean(-1, keepdims=True), 3, axis=-1)
    return {"rgb": rgb, "nir": nir}


def _ms_cfgs(**kw):
    common = {**dict(batch_size=64, warm_up_end=100, end_iter=1000, anneal_end=400,
                     mask_weight=0.1), **kw}
    jbase = JStage1Config(sdf=JSDFConfig(**NARROW), nerf=JNeRFConfig(**NERF),
                          color=JRenderingConfig(**COLOR), render=JNeuS(**RENDER), **common)
    tbase = Stage1Config(sdf=SDFConfig(**NARROW), nerf=NeRFConfig(**NERF),
                         color=RenderingConfig(**COLOR), render=NeuSRenderConfig(**RENDER),
                         **common)
    # the NIR colour net one layer shallower than the RGB one
    nir = dict(COLOR, n_layers=3)
    return (JMSConfig(base=jbase, nir_color=JRenderingConfig(**nir), rgb_iters=2, nir_iters=1),
            MultiSpectralConfig(base=tbase, nir_color=RenderingConfig(**nir), rgb_iters=2,
                                nir_iters=1))


def _j_datasets(spectra):
    return {m: JRayDataset.from_arrays(d["images"], d["Ks"], d["W2Cs"], d["masks"])
            for m, d in spectra.items()}


def _t_datasets(spectra):
    return {m: RayDataset.from_arrays(d["images"], d["Ks"], d["W2Cs"], d["masks"], device="cpu")
            for m, d in spectra.items()}


@pytest.fixture(scope="module")
def jax_ms(spectra):
    """An RGB step, then an NIR step, of the JAX trainer's jitted steps
    (iron_tpu/train/stage1_multispectral.py:84-103) at steps 100 and 101 from
    an Adam state of count 60 with random moments."""
    jcfg, _ = _ms_cfgs()
    tr = JMSTrainer(jcfg, _j_datasets(spectra), key=jax.random.PRNGKey(0))
    params = tr.params
    mu, nu = _random_moments(params, 3)
    state = _optax_state(tr.tx, params, mu, nu)
    keys = {"rgb": jax.random.PRNGKey(11), "nir": jax.random.PRNGKey(12)}
    p1, s1, m1 = tr._steps["rgb"](params, state, 100, keys["rgb"])
    p2, _, m2 = tr._steps["nir"](p1, s1, 101, keys["nir"])
    return {"params": to_np(params), "mu": to_np(mu), "nu": to_np(nu), "keys": keys,
            "after": {"rgb": to_np(p1), "nir": to_np(p2)},
            "metrics": {"rgb": {k: float(v) for k, v in m1.items()},
                        "nir": {k: float(v) for k, v in m2.items()}}}


def test_multispectral_rgb_then_nir_step_matches_jax(spectra, jax_ms):
    """One RGB step then one NIR step of MultiSpectralStage1Trainer.train_step
    on JAX's draws, from the JAX parameters and Adam state: the loss and
    every metric to 2e-4 relative; after each step every leaf of the shared
    tree to 2e-3 of its largest entry, and its update to 2e-3 of the leaf's
    largest update (+ the f32 rounding of p + dp).  The idle modality's nets
    move by momentum alone, as the JAX adam over the whole tree moves them
    (a None gradient would leave them still)."""
    _, tcfg = _ms_cfgs()
    tt = MultiSpectralStage1Trainer(tcfg, _t_datasets(spectra), device="cpu")
    tt.params = multispectral_params_from_numpy(jax_ms["params"], tcfg, "cpu")
    tt.opt = torch.optim.Adam(tt.params.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    _seed_adam(tt.opt, tt.params, _jax_path, jax_ms["mu"], jax_ms["nu"])
    tt.opt_count, tt.step = COUNT, 100
    old = _leaves(jax_ms["params"])
    for m in ("rgb", "nir"):
        ds = tt.datasets[m]
        got = tt.train_step(m, _draws(jax_ms["keys"][m], ds.n_images, 64, ds.hw,
                                      RENDER["n_outside"]))
        ref = jax_ms["metrics"][m]
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(float(got[k]), v, rtol=2e-4, atol=1e-7, err_msg=f"{m} {k}")
        new = _leaves(multispectral_params_to_numpy(tt.params))
        _hold_leaves(new, _leaves(jax_ms["after"][m]), m)
        ref_p = _leaves(jax_ms["after"][m])
        for k, a in ref_p.items():
            du_ref, du_got = a - old[k], new[k] - old[k]
            err = np.abs(du_got - du_ref) - 1e-7 * np.abs(a)
            assert np.abs(du_ref).max() > 0, (m, k)
            assert np.all(err <= 2e-3 * float(np.abs(du_ref).max()) + 1e-12), (m, k)
        old = ref_p
    assert tt.opt_count == COUNT + 2 and tt.step == 102


def test_multispectral_phases_keep_the_idle_nets(spectra):
    """run_curriculum from a fresh Adam: the RGB phase trains the shared SDF
    and leaves the NIR nets bit-equal (their moments stay zero); the NIR
    phase moves them, and the RGB colour net moves by momentum alone.  A
    modality's view shares the trainer's modules; CUDA without a card
    raises."""
    _, tcfg = _ms_cfgs(warm_up_end=1)
    tt = MultiSpectralStage1Trainer(tcfg, _t_datasets(spectra),
                                    generator=torch.Generator().manual_seed(4), device="cpu")
    snap = lambda: _leaves(multispectral_params_to_numpy(tt.params))
    p0 = snap()
    m = tt.run_phase("rgb", 2, seed=1)
    p1 = snap()
    assert np.isfinite(m["loss"]) and tt.step == 2
    for k in p0:
        same = np.array_equal(p0[k], p1[k])
        assert same == ("_nir" in k), k
    m = tt.run_phase("nir", 1, seed=1)
    p2 = snap()
    assert np.isfinite(m["loss"])
    assert any(not np.array_equal(p1[k], p2[k]) for k in p1 if "color_nir" in k)
    assert any(not np.array_equal(p1[k], p2[k]) for k in p1 if "color_rgb" in k)
    view = modality_view(tt.params, "nir")
    assert view["sdf"] is tt.params["sdf"] and view["color"] is tt.params["color_nir"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiSpectralStage1Trainer(tcfg, tt.datasets, device="cuda")


def test_multispectral_checkpoints_read_both_ways(spectra, jax_ms, tmp_path):
    """A checkpoint of the port (opt_state None, the Adam moments under
    extra["adam"]) read by the JAX trainer's load_cross_modality, and one of
    the JAX trainer (optax state) read by the port's: the listed leaves bit
    for bit; and the port's own save -> load_cross_modality in a fresh
    trainer."""
    jcfg, tcfg = _ms_cfgs()
    tt = MultiSpectralStage1Trainer(tcfg, _t_datasets(spectra), device="cpu",
                                    out_dir=str(tmp_path / "port"))
    tt.params = multispectral_params_from_numpy(jax_ms["after"]["nir"], tcfg, "cpu")
    tt.opt = torch.optim.Adam(tt.params.parameters())
    _seed_adam(tt.opt, tt.params, _jax_path, jax_ms["mu"], jax_ms["nu"])
    tt.opt_count, tt.step = COUNT, 7
    tt.save()
    ck = j_load_checkpoint(str(tmp_path / "port" / "ckpt_0000007.pkl"))
    assert ck["opt_state"] is None and ck["extra"]["adam"]["count"] == COUNT
    assert _leaves(ck["extra"]["adam"]["mu"]).keys() == _leaves(jax_ms["mu"]).keys()
    want = _leaves(jax_ms["after"]["nir"])

    jtr = JMSTrainer(jcfg, _j_datasets(spectra), key=jax.random.PRNGKey(5))
    jtr.load_cross_modality(rgb_ckpt_dir=str(tmp_path / "port"),
                            nir_ckpt_dir=str(tmp_path / "port"))
    for k, a in _leaves(to_np(jtr.params)).items():
        np.testing.assert_array_equal(a, want[k], err_msg=k)

    jtr.out_dir = str(tmp_path / "jax")
    jtr.params = jax.tree_util.tree_map(jnp.asarray, jax_ms["after"]["rgb"])
    jtr.step = 3
    jtr.save()
    fresh = MultiSpectralStage1Trainer(tcfg, tt.datasets, device="cpu",
                                       generator=torch.Generator().manual_seed(9))
    nir_before = _leaves(multispectral_params_to_numpy(fresh.params))
    fresh.load_cross_modality(rgb_ckpt_dir=str(tmp_path / "jax"))
    got = _leaves(multispectral_params_to_numpy(fresh.params))
    rgb = _leaves(jax_ms["after"]["rgb"])
    for k in got:
        ref = nir_before[k] if "_nir" in k else rgb[k]
        np.testing.assert_array_equal(got[k], ref, err_msg=k)
    fresh.load_cross_modality(nir_ckpt_dir=str(tmp_path / "port"))
    got = _leaves(multispectral_params_to_numpy(fresh.params))
    for k in got:
        np.testing.assert_array_equal(got[k], (want if "_nir" in k else rgb)[k], err_msg=k)


# ---------------------------------------------------------------------------
# the hash-grid NeRF runner
# ---------------------------------------------------------------------------

GRID = dict(n_levels=4, base_resolution=4, per_level_scale=2.0, log2_hashmap_size=10)
SWITCHES = {"background": dict(use_background=True),
            "background_envmap": dict(use_background=True, use_envmap=True),
            "foreground": dict(use_foreground=True),
            "foreground_envmap": dict(use_foreground=True, use_background=False,
                                      use_envmap=True)}


def _runner_cfgs(switches):
    widths = dict(d_hidden=16)
    common = dict(n_samples=16, batch_size=64, warm_up_end=100, end_iter=1000, **switches)
    return (JRunnerConfig(nerf=JHNeRF(grid=JGrid(**GRID), d_color_hidden=16, **widths),
                          sdf=JHSDF(grid=JGrid(**GRID), d_feature=7, **widths),
                          rendering=JHRend(grid=JGrid(**GRID), d_feature=7, **widths), **common),
            NeRFRunnerConfig(nerf=HashNeRFConfig(grid=HashGridConfig(**GRID),
                                                 d_color_hidden=16, **widths),
                             sdf=HashSDFConfig(grid=HashGridConfig(**GRID), d_feature=7,
                                               **widths),
                             rendering=HashRenderingConfig(grid=HashGridConfig(**GRID),
                                                           d_feature=7, **widths), **common))


def _runner_path(name):
    path = _jax_path(name)
    return path[:1] if path[0] == "envmap" else path


@pytest.mark.parametrize("switches", sorted(SWITCHES))
def test_runner_step_matches_jax(spectra, switches):
    """One HashNeRFTrainer.train_step on JAX's draws, from the JAX trainer's
    parameters (tables redrawn at U(-0.5, 0.5), the envmap at U(0.2, 0.8)) and
    an Adam state of count 60 with random moments: the loss and PSNR to 2e-4
    relative, every leaf after the update to 2e-3 of its largest entry."""
    jcfg, tcfg = _runner_cfgs(SWITCHES[switches])
    d = spectra["rgb"]
    jds = JRayDataset.from_arrays(d["images"], d["Ks"], d["W2Cs"], d["masks"])
    jtr = JHashNeRFTrainer(jcfg, jds, key=jax.random.PRNGKey(1))
    g = np.random.default_rng(2)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['table']"):
            return jnp.asarray(g.uniform(-0.5, 0.5, np.shape(leaf)).astype(np.float32))
        if name == "['envmap']":
            return jnp.asarray(g.uniform(0.2, 0.8, np.shape(leaf)).astype(np.float32))
        return leaf

    params = jax.tree_util.tree_map_with_path(redraw, jtr.params)
    mu, nu = _random_moments(params, 3)
    key = jax.random.PRNGKey(21)
    new, _, jm = jtr._train_step(params, _optax_state(jtr.tx, params, mu, nu), 100, key)

    tt = HashNeRFTrainer(tcfg, RayDataset.from_arrays(d["images"], d["Ks"], d["W2Cs"],
                                                      d["masks"], device="cpu"), device="cpu")
    tt.params = runner_params_from_numpy(to_np(params), "cpu")
    tt.opt = tt._adam()
    _seed_adam(tt.opt, tt.params, _runner_path, to_np(mu), to_np(nu))
    tt.opt_count, tt.step = COUNT, 100
    fg = tcfg.use_foreground
    draws = _draws(key, 2, 64, tt.dataset.hw, tcfg.neus.n_outside, split_render=fg)
    assert (draws.t_rand_outside is not None) == (fg and tcfg.use_background)
    got = tt.train_step(draws)
    for k, v in jm.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-4, err_msg=k)
    _hold_leaves(_leaves(runner_params_to_numpy(tt.params)), _leaves(to_np(new)), switches)
    assert set(runner_params_to_numpy(tt.params)) == set(params)


def test_runner_draws_run_and_refusals(spectra):
    """draw gives the shapes the JAX step draws; run trains finite steps; a
    runner with neither geometry switch, or CUDA without a card, raises."""
    _, tcfg = _runner_cfgs(SWITCHES["foreground"])
    d = spectra["rgb"]
    ds = RayDataset.from_arrays(d["images"], d["Ks"], d["W2Cs"], d["masks"], device="cpu")
    tt = HashNeRFTrainer(tcfg, ds, generator=torch.Generator().manual_seed(0), device="cpu")
    dr = tt.draw(torch.Generator().manual_seed(1))
    assert dr.px.shape == (64,) and dr.t_rand.shape == (64, 1)
    assert dr.t_rand_outside.shape == (64, tcfg.neus.n_outside) == (64, 8)
    history = []
    m = tt.run(3, seed=2, history=history)
    assert tt.step == 3 and len(history) == 3 and all(np.isfinite(v) for v in m.values())
    with pytest.raises(ValueError, match="use_background/use_foreground"):
        HashNeRFTrainer(dataclasses.replace(tcfg, use_background=False, use_foreground=False,
                                            use_envmap=True), ds, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HashNeRFTrainer(tcfg, ds, device="cuda")


def test_envmap_color_matches_jax():
    """The bilinear equirectangular lookup over every direction (the poles,
    the azimuth seam) and its gradient with respect to the map.  Where the
    two packages' f32 arccos and atan2 give the same angles (libm and XLA
    differ by one ulp on some inputs, each off the correctly rounded value
    in other places), the colour within 1e-6; elsewhere within 1e-6 plus
    the lookup's change under one ulp of each angle (He / pi and We / (2 pi)
    pixels per radian, times the map's largest step between neighbours)."""
    g = np.random.default_rng(6)
    He, We = 16, 32
    env = g.uniform(0, 1, (He, We, 3)).astype(np.float32)
    dirs = g.normal(size=(512, 3)).astype(np.float32)
    dirs[:4] = [[0, 0, 1], [0, 0, -1], [-1, 1e-7, 0], [-1, -1e-7, 0]]
    cot = g.normal(size=(512, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda e: j_envmap_color(e, jnp.asarray(dirs)), jnp.asarray(env))
    (g_ref,) = vjp(jnp.asarray(cot))
    et = T(env).requires_grad_(True)
    got = envmap_color(et, T(dirs))
    got.backward(T(cot))
    err = np.abs(got.detach().numpy() - np.asarray(ref)).max(-1)

    d = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-10)
    td, jd = T(d), jnp.asarray(d)
    theta_t, theta_j = torch.arccos(torch.clamp(td[:, 2], -1, 1)).numpy(), \
        np.asarray(jnp.arccos(jnp.clip(jd[:, 2], -1, 1)))
    phi_t, phi_j = torch.atan2(td[:, 1], td[:, 0]).numpy(), np.asarray(jnp.arctan2(jd[:, 1],
                                                                                  jd[:, 0]))
    same = (theta_t == theta_j) & (phi_t == phi_j)
    ulp = np.spacing(np.float32(np.pi))
    step = max(np.abs(np.diff(env, axis=0)).max(), np.abs(np.diff(env, axis=1)).max())
    slack = ulp * (He / np.pi + We / (2 * np.pi)) * step
    assert same.sum() > 400 and (~same).any()
    assert err[same].max() <= 1e-6, err[same].max()
    assert err.max() <= 1e-6 + slack, (err.max(), slack)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(g_ref), rtol=0, atol=1e-5)
