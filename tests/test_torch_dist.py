"""The port's data-parallel training and rendering (iron_tpu_torch/dist/)
on the CPU: two gloo ranks (subprocesses of tests/torch_dist_workers.py, one
run of every case) against the JAX package's dp steps on a dp=2 CPU mesh and
against the port's single-device steps and renders; four gloo ranks on a
(dp 2, tp 2) mesh against the JAX package's tp step on a 2x2 CPU mesh and
against the port's dp=2, tp=1 step; the mesh utilities, the tp spec table,
per-host image shards, the dry run under torchrun and the backend rules."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp
import optax

import torch_dist_workers as W
from iron_tpu.data.dataset import RayDataset as JRayDataset
from iron_tpu.data.synthetic import render_synthetic_dataset as j_synthetic
from iron_tpu.data.synthetic import write_scene_dir as j_write_scene_dir
from iron_tpu.dist.mesh import make_mesh as j_make_mesh
from iron_tpu.dist.mesh import replicate as j_replicate, shard_batch as j_shard_batch
from iron_tpu.dist.train import make_dp_stage1_step as j_dp_stage1_step
from iron_tpu.dist.train import make_dp_stage2_step as j_dp_stage2_step
from iron_tpu.dist.train import stage1_param_shardings as j_param_shardings
from iron_tpu.fields.nerf import NeRFConfig as JNeRFConfig
from iron_tpu.fields.rendering import RenderingConfig as JRenderingConfig
from iron_tpu.fields.sdf import SDFConfig as JSDFConfig
from iron_tpu.shading.materials import renderer_network_configs as j_net_cfgs
from iron_tpu.surface.render import SurfaceRenderConfig as JSurf
from iron_tpu.surface.tracer import TracerConfig as JTracer
from iron_tpu.train.schedules import warmup_cosine_schedule as j_schedule
from iron_tpu.train.stage1 import Stage1Config as JStage1Config
from iron_tpu.train.stage1 import init_stage1_params as j_init_stage1
from iron_tpu.train.stage2 import Stage2Config as JStage2Config
from iron_tpu.train.stage2 import init_light_from_cameras as j_init_light
from iron_tpu.train.stage2 import init_stage2_params as j_init_stage2
from iron_tpu.train.stage2 import make_optimizer as j_make_optimizer
from iron_tpu.volume.integrator import NeuSRenderConfig as JNeuSRenderConfig

from iron_tpu_torch.core.camera import crop_camera, make_camera
from iron_tpu_torch.data.dataset import RayDataset, near_far_from_sphere
from iron_tpu_torch.dist import mesh as tmesh
from iron_tpu_torch.dist.mesh import Mesh, initialize_distributed, make_mesh, shard_batch
from iron_tpu_torch.dist.train import stage1_param_shardings
from iron_tpu_torch.shading.materials import renderer_network_configs
from iron_tpu_torch.train.checkpoints import params_from_numpy
from iron_tpu_torch.train.stage1 import (Stage1Config, init_stage1_params, stage1_loss,
                                         stage1_params_from_numpy, stage1_render)
from iron_tpu_torch.train.stage2 import make_optimizer, stage2_loss, stage2_render_buffers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.as_tensor
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
WORLD = 2
TP_WORLD = 4
S1_STEP = dict(step=3, key=11)
# each rank's crop (view, column, row) on the 48x48 views: both see the
# sphere's silhouette
CROPS = ((0, 14, 12), (1, 18, 16))
SAME = (1, 16, 14)


def keystr(name: str) -> str:
    """jax.tree_util.keystr of the JAX leaf of a port parameter name (the
    NeRF's heads sit at the top of its JAX tree)."""
    return "".join(f"[{k}]" if k.isdigit() else f"['{k}']" for k in name.split(".")
                   if k != "heads")


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_wide_cfg():
    return JStage1Config(sdf=JSDFConfig(**W.WIDE), color=JRenderingConfig(**W.WIDE_COLOR),
                         nerf=JNeRFConfig(**W.WIDE_NERF), render=JNeuSRenderConfig(**W.S1_RENDER),
                         **W.S1)


def _jax_cfgs():
    s1 = JStage1Config(sdf=JSDFConfig(**W.NARROW), color=JRenderingConfig(**W.COLOR),
                       nerf=JNeRFConfig(**W.NERF), render=JNeuSRenderConfig(**W.S1_RENDER),
                       **W.S1)
    s2 = JStage2Config(renderer_name="comp", patch_size=W.PS, sdf=JSDFConfig(**W.NARROW),
                       surface=JSurf(tracer=JTracer(**W.S2_TRACE), **W.S2_SURF))
    r2 = JStage2Config(renderer_name="ggx", patch_size=W.PS, sdf=JSDFConfig(**W.NARROW),
                       surface=JSurf(tracer=JTracer(**W.R2_TRACE), **W.R2_SURF))
    return s1, s2, r2


def _stage2_params(cfg, W2Cs, seed):
    params = j_init_stage2(jax.random.PRNGKey(seed), cfg)[0]
    params["materials"]["point_light_network"]["light"] = jnp.asarray(
        j_init_light(W2Cs, cfg.init_light_scale), jnp.float32)
    return to_np(params)


def _eik(key):
    return np.asarray(jax.random.uniform(key, ((W.PS * W.PS) // 2, 3), minval=-1.0,
                                         maxval=1.0))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The cases' shared inputs: the 48x48 sphere (2 views, 13% covered),
    the JAX initial parameters, one stage-1 global batch of the scene and its
    draws as the JAX step derives them from its key, the crops and their
    eikonal points as the JAX dp step draws them from its keys, the render
    rays and camera, and a scene folder of 5 views."""
    scene = j_synthetic("sphere", n_views=2, H=48, W=48, light=30.0,
                        rig_kwargs={"focal": 60.0})
    j1, j2, jr = _jax_cfgs()
    jds = JRayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], scene["masks"])
    batch = np.asarray(jds.gen_random_rays(jax.random.PRNGKey(5), 0, j1.batch_size))
    k1, k2 = jax.random.split(jax.random.PRNGKey(S1_STEP["key"]))
    B = j1.batch_size
    keys = jax.random.split(jax.random.PRNGKey(13), WORLD)
    g = np.random.default_rng(1)
    d = g.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    folder = str(tmp_path_factory.mktemp("scene"))
    j_write_scene_dir(j_synthetic("sphere", n_views=5, H=16, W=16, light=30.0), folder)
    return {
        "scene": scene, "keys": keys,
        "s1": {"params": to_np(j_init_stage1(jax.random.PRNGKey(0), j1)), "batch": batch,
               "t_rand": np.asarray(jax.random.uniform(k1, (B, 1)) - 0.5),
               "t_rand_outside": np.asarray(jax.random.uniform(k2, (B, W.S1_RENDER["n_outside"]))),
               "step": S1_STEP["step"]},
        "s1_wide": {"params": to_np(j_init_stage1(jax.random.PRNGKey(0), _jax_wide_cfg())),
                    "batch": batch,
                    "t_rand": np.asarray(jax.random.uniform(k1, (B, 1)) - 0.5),
                    "t_rand_outside": np.asarray(jax.random.uniform(
                        k2, (B, W.S1_RENDER["n_outside"]))),
                    "step": S1_STEP["step"]},
        "s2": {"params": _stage2_params(j2, scene["W2Cs"], 0), "images": scene["images"],
               "Ks": scene["Ks"], "W2Cs": scene["W2Cs"],
               "same": SAME + (_eik(jax.random.PRNGKey(17)),),
               "crops": [c + (_eik(k),) for c, k in zip(CROPS, keys)]},
        "render": {"rays_o": (3.0 * d).astype(np.float32), "rays_d": (-d).astype(np.float32),
                   "params2": _stage2_params(jr, scene["W2Cs"], 0), "H": 48, "W": 48,
                   "K": scene["Ks"][0], "W2C": scene["W2Cs"][0]},
        "folder": folder,
    }


@pytest.fixture(scope="module")
def rank_procs(inputs, tmp_path_factory):
    """Both ranks of tests/torch_dist_workers.py (every dp case in one gloo
    group of two subprocesses), started; the JAX reference fixtures take
    this fixture so that their compiles run while the ranks work."""
    work = str(tmp_path_factory.mktemp("dp"))
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({k: v for k, v in inputs.items() if k not in ("scene", "keys")}, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                            "torch_dist_workers.py"),
                               str(r), str(WORLD), work], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    yield work, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def tp_procs(rank_procs):
    """The four ranks of the (dp 2, tp 2) mesh (tests/torch_dist_workers.py
    ... tp), started beside the two dp ranks, on the same inputs."""
    work, _ = rank_procs
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                            "torch_dist_workers.py"),
                               str(r), str(TP_WORLD), work, "tp"], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(TP_WORLD)]
    yield work, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def tp_ranks(tp_procs):
    """The four tp ranks' results (120 s for the ranks to finish)."""
    work, procs = tp_procs
    for p in procs:
        log = p.communicate(timeout=120)[0]
        assert p.returncode == 0, log[-4000:]
    out = []
    for r in range(TP_WORLD):
        with open(os.path.join(work, f"tp_rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def ranks(rank_procs):
    """Both ranks' results (120 s for the ranks to finish)."""
    work, procs = rank_procs
    for p in procs:
        log = p.communicate(timeout=120)[0]
        assert p.returncode == 0, log[-4000:]
    out = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _assert_ranks_equal(ranks, key):
    """The parameters after a step bit-equal on every rank."""
    for name, a in ranks[0][key]["params"].items():
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[key]["params"][name], a, err_msg=name)


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dp_stage1(inputs, rank_procs):
    """JAX's make_dp_stage1_step on a dp=2 CPU mesh from a fresh Adam (its
    gradients read back from optax's first moment, mu = 0.1 g)."""
    j1 = _jax_cfgs()[0]
    mesh = j_make_mesh(dp=WORLD, tp=1, devices=jax.devices()[:WORLD])
    tx = optax.adam(j_schedule(j1.learning_rate, j1.warm_up_end, j1.end_iter,
                               j1.learning_rate_alpha))
    params = jax.tree_util.tree_map(jnp.asarray, inputs["s1"]["params"])
    opt = tx.init(params)
    step = j_dp_stage1_step(j1, tx, mesh, tp_shard=False)
    _, new_opt, m = step(j_replicate(params, mesh), j_replicate(opt, mesh),
                         j_shard_batch(jnp.asarray(inputs["s1"]["batch"]), mesh),
                         jnp.asarray(S1_STEP["step"]), jax.random.PRNGKey(S1_STEP["key"]))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: v / np.float32(0.1) for k, v in _leaves(new_opt[0].mu).items()}}


def test_dp_stage1_step_matches_jax_dp_step(jax_dp_stage1, jax_dp_stage2, ranks):
    """Two ranks of 32 rays each against JAX's dp step on the 64-ray batch
    (pjit: the single-device step on the whole batch), the draws injected:
    the loss and every metric within 2e-4 relative, on both ranks alike;
    every gradient leaf within 2e-3 of its largest entry (+ 2e-3 relative),
    as tests/test_torch_stage1.py holds the single-device step."""
    jm, jg = jax_dp_stage1["metrics"], jax_dp_stage1["grads"]
    for rk in ranks:
        assert rk["s1"]["metrics"] == ranks[0]["s1"]["metrics"]
        assert set(rk["s1"]["metrics"]) == set(jm)
        for k, v in jm.items():
            np.testing.assert_allclose(rk["s1"]["metrics"][k], v, rtol=2e-4, atol=1e-7,
                                       err_msg=k)
    got = ranks[0]["s1"]["grads"]
    assert {keystr(n) for n in got} == set(jg)
    for n, a in got.items():
        ref = jg[keystr(n)]
        np.testing.assert_allclose(a, ref, rtol=2e-3, atol=2e-3 * float(np.abs(ref).max())
                                   + 1e-10, err_msg=n)
    _assert_ranks_equal(ranks, "s1")


def test_dp_stage1_step_is_the_single_device_step_on_the_whole_batch(inputs, ranks):
    """The port's dp step against its own single-device loss on the whole
    64-ray batch with the same draws: the loss within 1e-5 relative, every
    gradient leaf within 1e-5 of its largest entry.  The halves of the batch
    hold other mask sums and eikonal counts, so a mean of the ranks' own
    losses would miss this: the step reduces the normalisers first."""
    c1 = W.port_cfgs()[0]
    s1 = inputs["s1"]
    params = stage1_params_from_numpy(s1["params"], c1, "cpu")
    from iron_tpu_torch.train.schedules import cos_anneal_ratio
    loss, m = stage1_loss(params, c1, T(s1["batch"]), cos_anneal_ratio(s1["step"], c1.anneal_end),
                          t_rand=T(s1["t_rand"]), t_rand_outside=T(s1["t_rand_outside"]))
    loss.backward()
    halves = np.split(s1["batch"][:, 9] > 0.5, WORLD)
    assert halves[0].sum() != halves[1].sum()
    dm = ranks[0]["s1"]["metrics"]
    for k, v in m.items():
        np.testing.assert_allclose(dm[k], float(v), rtol=1e-5, atol=1e-8, err_msg=k)
    for n, p in params.named_parameters():
        ref = p.grad.numpy()
        np.testing.assert_allclose(ranks[0]["s1"]["grads"][n], ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=n)


@pytest.fixture(scope="module")
def jax_tp_stage1(inputs, rank_procs, tp_procs):
    """JAX's make_dp_stage1_step(tp_shard=True) on a (dp 2, tp 2) CPU mesh,
    the parameters placed by its stage1_param_shardings, from a fresh Adam
    (its gradients read back from optax's first moment, mu = 0.1 g)."""
    j1 = _jax_wide_cfg()
    mesh = j_make_mesh(dp=2, tp=2, devices=jax.devices()[:TP_WORLD])
    tx = optax.adam(j_schedule(j1.learning_rate, j1.warm_up_end, j1.end_iter,
                               j1.learning_rate_alpha))
    params = jax.tree_util.tree_map(jnp.asarray, inputs["s1_wide"]["params"])
    params = jax.device_put(params, j_param_shardings(params, mesh))
    step = j_dp_stage1_step(j1, tx, mesh, tp_shard=True)
    _, new_opt, m = step(params, tx.init(params),
                         j_shard_batch(jnp.asarray(inputs["s1_wide"]["batch"]), mesh),
                         jnp.asarray(S1_STEP["step"]), jax.random.PRNGKey(S1_STEP["key"]))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: v / np.float32(0.1) for k, v in _leaves(new_opt[0].mu).items()}}


def test_tp_stage1_step_matches_jax_tp_step(jax_tp_stage1, tp_ranks):
    """Four ranks on a (dp 2, tp 2) mesh (rank r at dp r // 2, tp r % 2, as
    JAX's devices.reshape(dp, tp)), each dp pair of ranks on its 32 rays,
    Adam over its tp shards, against JAX's tp step on the 64-ray batch with
    the draws injected: the loss and every metric within 2e-4 relative, every
    gradient leaf within 2e-3 of its largest entry (+ 2e-3 relative), the dp
    test's holds; the parameters after the step bit-equal on every rank."""
    jm, jg = jax_tp_stage1["metrics"], jax_tp_stage1["grads"]
    for r, rk in enumerate(tp_ranks):
        assert (rk["rank"], rk["dp_rank"], rk["tp_rank"]) == (r, r // 2, r % 2)
        assert rk["shape"] == {"dp": 2, "tp": 2}
        assert rk["s1_wide"]["metrics"] == tp_ranks[0]["s1_wide"]["metrics"]
        for k, v in jm.items():
            np.testing.assert_allclose(rk["s1_wide"]["metrics"][k], v, rtol=2e-4, atol=1e-7,
                                       err_msg=k)
    got = tp_ranks[0]["s1_wide"]["grads"]
    assert {keystr(n) for n in got} == set(jg)
    for n, a in got.items():
        ref = jg[keystr(n)]
        np.testing.assert_allclose(a, ref, rtol=2e-3, atol=2e-3 * float(np.abs(ref).max())
                                   + 1e-10, err_msg=n)
    for name, a in tp_ranks[0]["s1_wide"]["params"].items():
        for other in tp_ranks[1:]:
            np.testing.assert_array_equal(other["s1_wide"]["params"][name], a, err_msg=name)


def test_tp_stage1_step_is_bit_equal_to_the_tp1_step(tp_ranks, ranks):
    """The tp = 2 step against the port's dp = 2, tp = 1 step on the same
    batch: the whole tree after the step, Adam's moments (gathered over tp)
    and the metrics bit-equal; each tp rank's Adam holds only its slices of
    the split leaves (the hidden layers' v, g and b)."""
    ref = ranks[0]["s1_wide"]
    sharded = tp_ranks[0]["s1_wide"]["sharded"]
    assert "sdf.layers.0.v" in sharded and "color.layers.0.b" in sharded
    for rk in tp_ranks:
        got = rk["s1_wide"]
        assert got["metrics"] == ref["metrics"] and got["sharded"] == sharded
        for key in ("params", "moments"):
            assert set(got[key]) == set(ref[key])
            for n, a in ref[key].items():
                np.testing.assert_array_equal(got[key][n], a, err_msg=n)
        assert got["adam_numel"] < 0.75 * ref["adam_numel"]
    assert ranks[0]["s1_wide"]["sharded"] == []


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------

def _port_stage2_step(inputs, idx, col, row, eik):
    """The port's single-device stage-2 step (Stage2Trainer.train_step's
    body) on one crop: the parameters after GroupAdam."""
    c2 = W.port_cfgs()[1]
    s2 = inputs["s2"]
    mat_cfgs = renderer_network_configs("comp", d_feature=W.NARROW["d_out"] - 1)
    params = params_from_numpy(s2["params"], "cpu", c2.sdf, "comp")
    opt = make_optimizer(c2, params)
    cam = crop_camera(make_camera(s2["Ks"][idx], s2["W2Cs"][idx], 48, 48, device="cpu"),
                      col, row, W.PS, W.PS)
    gt = T(np.asarray(s2["images"][idx], np.float32))[row:row + W.PS, col:col + W.PS, :3]
    opt.zero_grad()
    loss, _ = stage2_loss(params, mat_cfgs, c2, cam, gt, T(eik))
    loss.backward()
    opt.step()
    return {n: p.detach().numpy() for n, p in params.named_parameters()}


def test_dp_stage2_step_on_one_crop_is_the_single_device_step(inputs, ranks):
    """Both ranks on the same crop and eikonal points: the averaged
    gradients are the crop's, and the parameters after the step are those
    of the port's single-device step, bit for bit, on both ranks."""
    ref = _port_stage2_step(inputs, *inputs["s2"]["same"])
    for rk in ranks:
        for n, a in ref.items():
            np.testing.assert_array_equal(rk["s2_same"]["params"][n], a, err_msg=n)
    c2 = W.port_cfgs()[1]
    before = params_from_numpy(inputs["s2"]["params"], "cpu", c2.sdf, "comp")
    assert not torch.equal(before["sdf"].layers[0].v, T(ref["sdf.layers.0.v"]))


@pytest.fixture(scope="module")
def jax_dp_stage2(inputs, rank_procs):
    """JAX's make_dp_stage2_step on a dp=2 CPU mesh, each shard on its own
    crop and key, from a fresh optimizer: the metrics and the averaged
    gradients (from optax's first moments)."""
    j2 = _jax_cfgs()[1]
    s2 = inputs["s2"]
    mesh = j_make_mesh(dp=WORLD, tp=1, devices=jax.devices()[:WORLD])
    mat_cfgs = j_net_cfgs("comp", d_feature=W.NARROW["d_out"] - 1)
    params = jax.tree_util.tree_map(jnp.asarray, s2["params"])
    tx = j_make_optimizer(j2, params)
    step = j_dp_stage2_step(j2, mat_cfgs, tx, mesh, s2["images"], s2["Ks"], s2["W2Cs"])
    crops = np.asarray(CROPS, np.int32)
    _, new_opt, m = step(j_replicate(params, mesh), j_replicate(tx.init(params), mesh),
                         j_shard_batch(inputs["keys"], mesh),
                         j_shard_batch(jnp.asarray(crops[:, 0]), mesh),
                         j_shard_batch(jnp.asarray(crops[:, 1]), mesh),
                         j_shard_batch(jnp.asarray(crops[:, 2]), mesh))
    grads = {}
    for st in new_opt.inner_states.values():
        for s in jax.tree_util.tree_leaves(
                st.inner_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
            if isinstance(s, optax.ScaleByAdamState):
                grads.update({k: v / np.float32(0.1) for k, v in _leaves(s.mu).items()})
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads}


def test_dp_stage2_step_on_own_crops_matches_jax_dp_step(jax_dp_stage2, ranks):
    """Each rank on its own crop against JAX's dp step (shard_map + pmean)
    on the same crops and eikonal points: the averaged metrics within 2e-4
    relative and the counts equal, every averaged gradient leaf within 2e-3
    of its largest entry (+ 2e-3 relative, + 1e-10), the holds of
    tests/test_torch_train.py; the parameters bit-equal across ranks."""
    jm, jg = jax_dp_stage2["metrics"], jax_dp_stage2["grads"]
    got_m = ranks[0]["s2_own"]["metrics"]
    assert set(got_m) == set(jm) and got_m == ranks[1]["s2_own"]["metrics"]
    assert jm["mask_frac"] > 0.05 and jm["edge_pixel_count"] > 0
    for k in ("edge_seed_count", "edge_seeds_dropped", "edge_pixel_count", "mask_frac"):
        assert got_m[k] == jm[k], k
    for k, v in jm.items():
        np.testing.assert_allclose(got_m[k], v, rtol=2e-4, atol=1e-7, err_msg=k)
    got = ranks[0]["s2_own"]["grads"]
    assert {keystr(n) for n in got} == set(jg)
    for n, a in got.items():
        ref = jg[keystr(n)]
        np.testing.assert_allclose(a, ref, rtol=2e-3, atol=2e-3 * float(np.abs(ref).max())
                                   + 1e-10, err_msg=n)
    _assert_ranks_equal(ranks, "s2_own")


def test_dp_stage2_per_shard_data_matches_replicated_views(ranks):
    """Rank r holding only view r (host_sharded_views, local index 0)
    computes what the step over the replicated views computes with global
    index r: the loss at rtol 1e-6 and every parameter after the step at
    rtol 1e-6, on both ranks alike."""
    for rk in ranks:
        a, b = rk["per_shard"]["replicated"], rk["per_shard"]["per_shard"]
        np.testing.assert_allclose(b["metrics"]["loss"], a["metrics"]["loss"], rtol=1e-6)
        for n, v in a["params"].items():
            np.testing.assert_allclose(b["params"][n], v, rtol=1e-6, atol=1e-7, err_msg=n)
        np.testing.assert_array_equal(rk["per_shard"]["per_shard"]["params"]["sdf.layers.0.v"],
                                      ranks[0]["per_shard"]["per_shard"]["params"][
                                          "sdf.layers.0.v"])


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def test_dp_stage1_render_matches_single_device(inputs, ranks):
    """The rays split over the ranks and gathered on each, against the
    port's single-device stage1_render of all 256 rays (no jitter, anneal
    1): colour within 1e-5 (tests/test_dist.py's hold), on both ranks."""
    c1 = W.port_cfgs()[0]
    rd = inputs["render"]
    params = stage1_params_from_numpy(inputs["s1"]["params"], c1, "cpu")
    ro, rdir = T(rd["rays_o"]), T(rd["rays_d"])
    near, far = near_far_from_sphere(ro, rdir)
    with torch.no_grad():
        ref = stage1_render(params, c1, ro, rdir, near, far, 1.0, None, perturb_overwrite=0.0)
    for rk in ranks:
        assert rk["render1"]["color"].shape == (256, 3) == rk["render1"]["normal"].shape
        np.testing.assert_allclose(rk["render1"]["color"], ref["color_fine"].numpy(), atol=1e-5)
        np.testing.assert_array_equal(rk["render1"]["color"], ranks[0]["render1"]["color"])


def test_dp_stage2_render_matches_single_device(inputs, ranks):
    """Bands of 24 rows a rank through crop_camera, gathered, against the
    port's single-device render of the whole 48x48 view
    (stage2_render_buffers), with tests/test_dist.py's holds away from the
    band seam: colour within 1e-2, fewer than 0.5% of mask pixels apart."""
    rd = inputs["render"]
    r2 = W.port_cfgs()[2]
    params = params_from_numpy(rd["params2"], "cpu", r2.sdf, "ggx")
    ref = stage2_render_buffers(params, renderer_network_configs("ggx", d_feature=32), r2,
                                make_camera(rd["K"], rd["W2C"], 48, 48, device="cpu"))
    H, band = 48, 48 // WORLD
    rows = np.setdiff1d(np.arange(H), np.concatenate([np.arange(H, step=band),
                                                      np.arange(H, step=band) - 1]))
    for rk in ranks:
        out = rk["render2"]
        assert out["color"].shape == (48, 48, 3) and out["depth"].shape == (48, 48)
        assert ref["convergent_mask"].numpy().sum() > 100
        np.testing.assert_allclose(out["color"][rows], ref["color"].numpy()[rows], atol=1e-2)
        diff = out["convergent_mask"][rows] != ref["convergent_mask"].numpy()[rows]
        assert diff.mean() < 0.005


# ---------------------------------------------------------------------------
# the mesh utilities, the spec table, per-host shards
# ---------------------------------------------------------------------------

def test_replicate_and_shard_batch(ranks):
    """replicate gives every rank rank 0's parameters and Adam moments
    (drawn differently on each rank before); shard_batch gives rank r rows
    [3r, 3r + 3) of a 6-row array and [2r, 2r + 2) of a 4-row tensor; the
    mesh is {dp: 2, tp: 1}."""
    r0, r1 = ranks
    assert r0["shape"] == {"dp": 2, "tp": 1} and (r0["rank"], r1["rank"]) == (0, 1)
    n = "sdf.layers.1.v"
    assert not np.array_equal(r0["before_replicate"][n], r1["before_replicate"][n])
    for k, v in r0["before_replicate"].items():
        np.testing.assert_array_equal(r1["replicated"][k], v)
        np.testing.assert_array_equal(r0["replicated"][k], v)
        np.testing.assert_array_equal(r1["replicated_adam"][k], r0["replicated_adam"][k])
    for r, rk in enumerate(ranks):
        np.testing.assert_array_equal(rk["shard"]["x"], np.arange(12).reshape(6, 2)[3 * r:3 * r + 3])
        np.testing.assert_array_equal(rk["shard"]["y"].numpy(), np.arange(4.0)[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="divide"):
        shard_batch(np.zeros((5, 3)), Mesh(None, 0, 2, torch.device("cpu"), {"dp": 2, "tp": 1}))


def test_stage1_param_shardings_match_jax_specs():
    """The tp spec table, leaf by leaf, against JAX's NamedShardings on a
    (dp 1, tp 2) mesh at the full stage-1 width (the rule splits leaves of
    128 or more), with and without tp_shard."""
    jcfg = JStage1Config()
    jparams = j_init_stage1(jax.random.PRNGKey(0), jcfg)
    jmesh = j_make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    params = init_stage1_params(Stage1Config(), torch.Generator().manual_seed(0), "cpu")
    tp_mesh = Mesh(None, 0, 1, torch.device("cpu"), {"dp": 1, "tp": 2})
    for shard in (True, False):
        ref = {jax.tree_util.keystr(k): tuple(s.spec) for k, s in
               jax.tree_util.tree_leaves_with_path(j_param_shardings(jparams, jmesh, shard))}
        got = {keystr(n): s for n, s in stage1_param_shardings(params, tp_mesh, shard).items()}
        assert got == ref
        assert any(s for s in got.values()) == shard


def test_per_host_shard_keeps_the_jax_image_list(inputs, ranks, monkeypatch):
    """RayDataset.from_folder(per_host_shard=True) on each rank of the gloo
    group keeps the images the JAX loader keeps with jax.process_index /
    process_count at (rank, 2); without a group, torchrun's RANK and
    WORLD_SIZE choose the same; one process keeps every image."""
    folder = inputs["folder"]
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    for r, rk in enumerate(ranks):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        ref = [os.path.basename(f) for f in
               JRayDataset.from_folder(folder, per_host_shard=True).fpaths]
        assert rk["fpaths"] == ref and len(ref) == (3, 2)[r]
        monkeypatch.setenv("RANK", str(r))
        monkeypatch.setenv("WORLD_SIZE", str(WORLD))
        got = RayDataset.from_folder(folder, per_host_shard=True, device="cpu").fpaths
        assert [os.path.basename(f) for f in got] == ref
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    assert len(RayDataset.from_folder(folder, per_host_shard=True, device="cpu").fpaths) == 5


# ---------------------------------------------------------------------------
# the dry run and the backend rules
# ---------------------------------------------------------------------------

def _dryrun(ranks: int) -> str:
    """python -m torch.distributed.run --standalone --nproc_per_node <ranks>
    -m iron_tpu_torch.dist.dryrun --device cpu: its exit code checked, its
    stdout returned."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", str(ranks), "-m", "iron_tpu_torch.dist.dryrun",
                          "--device", "cpu"], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    return out.stdout


def test_dryrun_under_torchrun_on_two_cpu_ranks():
    """The dry run on two gloo ranks exits 0, both ranks reporting finite
    losses and equal parameters (a (dp 1, tp 2) mesh: the tp collectives)."""
    out = _dryrun(2)
    assert out.count("parameters equal on every rank") == 2, out
    assert out.count("(dp 1, tp 2)") == 2, out


def test_dryrun_under_torchrun_on_four_cpu_ranks():
    """The dry run on four gloo ranks, a (dp 2, tp 2) mesh, so that the dp
    all-reduces of both stages and the tp all-gathers of stage 1 run under
    torchrun: exits 0, every rank reporting finite losses and equal
    parameters."""
    out = _dryrun(4)
    assert out.count("parameters equal on every rank") == 4, out
    assert out.count("(dp 2, tp 2)") == 4, out


def test_backend_rules_and_single_process(monkeypatch, tmp_path, tp_ranks):
    """NCCL with two ranks on one card raises before joining, naming
    backend='gloo' (CUDA faked: one device, as tests/test_torch_kernels_k2_k5.py
    fakes it); NCCL on the CPU raises; one process joins nothing and its
    mesh is one rank, which holds no tp = 2 mesh; the tp ranks' groups: a
    rank's dp group shares its tp index, its tp group its dp index."""
    import torch.distributed as dist
    init = "file://" + str(tmp_path / "init")
    assert initialize_distributed(device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.shape) == (None, 0, 1, {"dp": 1, "tp": 1})
    t = torch.arange(3.0)
    assert mesh.all_reduce_sum(t) is t and torch.equal(mesh.all_gather(t), t)
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(tp=2, device="cpu")          # one process holds no tp = 2 mesh
    with pytest.raises(ValueError, match="gloo"):
        initialize_distributed(backend="nccl", device="cpu", init_method=init, rank=0,
                               world_size=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: pytest.fail("set_device reached"))
    with pytest.raises(ValueError, match="backend='gloo'"):
        initialize_distributed(backend="nccl", init_method=init, rank=1, world_size=2,
                               local_rank=1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="backend='gloo'"):
        initialize_distributed(init_method=init, rank=0, world_size=2, local_rank=0)
    assert not dist.is_initialized()
    assert tmesh.process_index_count() == (0, 1)
    for rk in tp_ranks:       # rank r's dp group {r % 2, r % 2 + 2}, tp group {2 (r // 2), +1}
        r = rk["rank"]
        assert rk["group_sums"] == {"dp": 2.0 * (r % 2) + 2, "tp": 4.0 * (r // 2) + 1,
                                    "world": 6.0}
