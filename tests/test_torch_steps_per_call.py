"""The trainers' chunked `run(steps_per_call > 1)` on the CPU: stage 1's
chunk (on the CPU a loop of train_step) bit-equal to the same steps one a
call, its chunks bounded by the log and save cadence and its occupancy grid
refreshed at a chunk's start exactly as the JAX trainer's run does (the JAX
trainer's run driven with its compiled steps stood in for); stage 2's
chunks drawing their crops on the device within the JAX trainer's bounds,
each step bit-equal to train_step on the same crop, the chunks bounded as
the JAX trainer bounds them; the device-side learning rate and anneal
against the JAX schedules."""
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

import iron_tpu.volume.occupancy as j_occupancy
from iron_tpu.data.dataset import RayDataset as JRayDataset
from iron_tpu.data.synthetic import render_synthetic_dataset as j_synthetic
from iron_tpu.fields.sdf import SDFConfig as JSDFConfig
from iron_tpu.train.schedules import cos_anneal_ratio as j_cos_anneal
from iron_tpu.train.schedules import warmup_cosine_schedule as j_schedule
from iron_tpu.train.stage1 import Stage1Config as JStage1Config
from iron_tpu.train.stage1 import Stage1Trainer as JStage1Trainer
from iron_tpu.train.stage2 import Stage2Config as JStage2Config
from iron_tpu.train.stage2 import Stage2Trainer as JStage2Trainer

from iron_tpu_torch.data.dataset import RayDataset
from iron_tpu_torch.fields.nerf import NeRFConfig
from iron_tpu_torch.fields.rendering import RenderingConfig
from iron_tpu_torch.fields.sdf import SDFConfig
from iron_tpu_torch.surface.render import SurfaceRenderConfig
from iron_tpu_torch.train.schedules import cos_anneal_ratio, warmup_cosine_schedule
from iron_tpu_torch.train.stage1 import Stage1Config, Stage1Trainer
from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer
from iron_tpu_torch.volume.integrator import NeuSRenderConfig

NARROW = dict(d_out=17, d_hidden=16, n_layers=3, skip_in=(), multires=2)
COLOR = dict(d_feature=16, mode="idr", d_in=9, d_out=3, d_hidden=16, n_layers=2,
             multires=2, multires_view=2, squeeze_out=True, skip_in=())
NERF = dict(D=2, W=16, skips=(0,), multires=2, multires_view=2)
RENDER = dict(n_samples=8, n_importance=8, n_outside=4, up_sample_steps=2, perturb=1.0)


@pytest.fixture(scope="module")
def scene():
    return j_synthetic("sphere", n_views=2, H=24, W=24, light=30.0, rig_kwargs={"focal": 30.0})


def _stage1(scene, **kw):
    cfg = Stage1Config(sdf=SDFConfig(**NARROW), color=RenderingConfig(**COLOR),
                       nerf=NeRFConfig(**NERF), render=NeuSRenderConfig(**RENDER),
                       batch_size=16, warm_up_end=3, end_iter=40, anneal_end=6, **kw)
    ds = RayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], scene["masks"],
                                device="cpu")
    return Stage1Trainer(cfg, ds, generator=torch.Generator().manual_seed(3), device="cpu")


def _state(tr):
    return ([p.detach().clone() for p in tr.params.parameters()],
            [{k: v.clone() for k, v in tr.opt.state[p].items()} for p in tr.params.parameters()])


def test_stage1_chunk_is_bit_equal_to_single_steps(scene):
    """run(k, steps_per_call=k), occupancy off, against run(k,
    steps_per_call=1) from the same trainer state and seed: the parameters,
    Adam's moments and steps, and every step's metrics bit-equal; the steps
    at a learning rate and anneal that change on every step."""
    k = 5
    runs = []
    for spc in (k, 1):
        tr = _stage1(scene)
        history = []
        m = tr.run(num_iters=k, seed=4, steps_per_call=spc, history=history)
        assert tr.step == tr.opt_count == k and all(np.isfinite(v) for v in m.values())
        runs.append((_state(tr), history))
    (pa, aa), ha = runs[0]
    (pb, ab), hb = runs[1]
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert all(torch.equal(x[key], y[key]) for x, y in zip(aa, ab) for key in x)
    assert len(ha) == len(hb) == k
    assert all(torch.equal(x[key], y[key]) for x, y in zip(ha, hb) for key in x)
    assert len({float(h["loss"]) for h in ha}) == k


@pytest.mark.parametrize("num_iters,spc,log_every,save_freq,every", [
    (10, 4, 3, 1000, 2), (9, 16, 0, 4, 3), (7, 1, 0, 1000, 2), (12, 5, 4, 6, 5)])
def test_stage1_chunks_and_occupancy_follow_the_jax_run(scene, monkeypatch, tmp_path,
                                                        num_iters, spc, log_every, save_freq,
                                                        every):
    """The chunks (their sizes), the steps where the occupancy grid is
    refreshed (at a chunk's start when step % occupancy_update_every <
    chunk, or before the first) and the saves of the port's run against the
    JAX trainer's run on the same options; the JAX trainer's compiled
    single and chunked steps are stood in for by recorders (its host loop is
    what is held), and so is its grid update."""
    jcfg = JStage1Config(sdf=JSDFConfig(**NARROW), batch_size=16, use_occupancy=True,
                         occupancy_update_every=every, save_freq=save_freq)
    jds = JRayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"])
    jt = JStage1Trainer(jcfg, jds, out_dir=str(tmp_path / "j"))
    j_rec = {"chunks": [], "grids": [], "saves": []}
    jt._train_step = lambda p, o, step, key, occ=None: (j_rec["chunks"].append(1) or
                                                         (p, o, {"loss": jnp.float32(0)}))
    jt._train_steps = lambda p, o, step, key, chunk, occ=None: (
        j_rec["chunks"].append(chunk) or (p, o, {"loss": jnp.float32(0)}))
    monkeypatch.setattr(j_occupancy, "update_occupancy_grid",
                        lambda fn, cfg: j_rec["grids"].append(jt.step) or jnp.zeros((2, 2, 2)))
    jt.save = lambda: j_rec["saves"].append(jt.step)
    jt.run(num_iters=num_iters, log_every=log_every, steps_per_call=spc)

    tr = _stage1(scene, use_occupancy=True, occupancy_update_every=every, save_freq=save_freq)
    tr.out_dir = str(tmp_path / "t")
    t_rec = {"chunks": [], "grids": [], "saves": []}
    chunk = tr.run_chunk
    tr.run_chunk = lambda n, g, h=None: t_rec["chunks"].append(n) or chunk(n, g, h)
    update = tr.update_occupancy
    tr.update_occupancy = lambda: t_rec["grids"].append(tr.step) or update()
    tr.save = lambda: t_rec["saves"].append(tr.step)
    tr.run(num_iters=num_iters, log_every=log_every, steps_per_call=spc)
    assert t_rec == j_rec and sum(t_rec["chunks"]) == num_iters == tr.step


def test_stage1_device_schedules_match_jax():
    """The learning rate and the anneal computed from a step tensor (what a
    captured step reads) against the JAX schedules in f32, over the warm-up,
    its end and the cosine; the host float versions beside them."""
    steps = np.array([0, 1, 2, 99, 100, 101, 5000, 49999, 50000, 100000], np.int64)
    sched = warmup_cosine_schedule(5e-4, 100, 100001, 0.05)
    jsched = j_schedule(5e-4, 100, 100001, 0.05)
    got = sched(torch.as_tensor(steps)).numpy()
    ref = np.asarray(jsched(jnp.asarray(steps)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose([sched(int(s)) for s in steps], ref, rtol=1e-6)
    an = cos_anneal_ratio(torch.as_tensor(steps), 50000).numpy()
    np.testing.assert_array_equal(an, np.asarray(j_cos_anneal(jnp.asarray(steps), 50000)))
    assert cos_anneal_ratio(torch.as_tensor(7), 0) == 1.0


def _stage2(scene, **kw):
    cfg = Stage2Config(renderer_name="ggx", patch_size=16, sdf=SDFConfig(**NARROW),
                       surface=SurfaceRenderConfig(edge_budget=64), **kw)
    return Stage2Trainer(cfg, scene["images"], scene["Ks"], scene["W2Cs"],
                         generator=torch.Generator().manual_seed(6), device="cpu")


def test_stage2_chunk_draws_crops_on_the_device(scene):
    """run(4, steps_per_call=4): the crops drawn from the device generator
    (one [4, 3] draw) within the JAX trainer's bounds ([0, n_imgs), [0,
    max_col), [0, max_row)); the parameters after the chunk bit-equal to
    train_step on the same crops and eikonal points from the same start."""
    tr = _stage2(scene)
    crops, eiks = [], []
    step = tr.train_step
    tr.train_step = lambda i, c, r, e: (crops.append((i, c, r)) or eiks.append(e.clone())
                                        or step(i, c, r, e))
    history = []
    m = tr.run(num_iters=4, seed=2, steps_per_call=4, history=history)
    assert tr.step == 4 and len(history) == 4 and all(np.isfinite(v) for v in m.values())
    n_imgs, H, W = scene["images"].shape[:3]
    max_col, max_row = max(W - 16, 1), max(H - 16, 1)
    g = torch.Generator().manual_seed(3 * 1_000_003)
    want = (torch.randint(0, 1 << 31, (4, 3), generator=g)
            % torch.tensor([n_imgs, max_col, max_row])).tolist()
    assert [list(c) for c in crops] == want
    assert all(0 <= i < n_imgs and 0 <= c < max_col and 0 <= r < max_row for i, c, r in crops)
    ref = _stage2(scene)
    for (i, c, r), e in zip(crops, eiks):
        ref.train_step(i, c, r, e)
    for p, q in zip(tr.params.parameters(), ref.params.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("num_iters,spc,log_every,save_freq,val_every", [
    (10, 4, 3, 1000, 0), (9, 16, 0, 4, 0), (8, 3, 0, 1000, 5)])
def test_stage2_chunks_follow_the_jax_run(scene, tmp_path, num_iters, spc, log_every,
                                          save_freq, val_every):
    """The chunk sizes, saves and validations of the port's chunked stage-2
    run against the JAX trainer's chunked run (its compiled chunk stood in
    for by a recorder) on the same options."""
    for d in ("j", "t"):
        (tmp_path / d).mkdir()
    jt = JStage2Trainer(JStage2Config(renderer_name="ggx", patch_size=16,
                                      sdf=JSDFConfig(**NARROW), save_freq=save_freq),
                        scene["images"], scene["Ks"], scene["W2Cs"],
                        key=jax.random.PRNGKey(0), out_dir=str(tmp_path / "j"))
    j_rec = {"chunks": [], "saves": [], "vals": []}
    jt._train_steps = lambda p, o, key, chunk: (j_rec["chunks"].append(chunk) or
                                                (p, o, {"loss": jnp.float32(0)}))
    jt.save = lambda: j_rec["saves"].append(jt.step)
    val_fn = (lambda rec: lambda t: rec.append(t.step) or 0.0)
    jt.run(num_iters=num_iters, log_every=log_every, steps_per_call=spc,
           val_fn=val_fn(j_rec["vals"]) if val_every else None, val_every=val_every)

    tr = _stage2(scene, save_freq=save_freq)
    tr.out_dir = str(tmp_path / "t")
    t_rec = {"chunks": [], "saves": [], "vals": []}
    step = tr.train_step
    starts = []
    tr.train_step = lambda i, c, r, e: starts.append(tr.step) or step(i, c, r, e)
    tr.save = lambda: t_rec["saves"].append(tr.step)
    tr.run(num_iters=num_iters, log_every=log_every, steps_per_call=spc,
           val_fn=val_fn(t_rec["vals"]) if val_every else None, val_every=val_every)
    # the chunks: runs of steps between the cadence's stops
    stops = sorted(set(t_rec["saves"]) | set(t_rec["vals"]) |
                   ({s for s in range(1, num_iters + 1) if s % log_every == 0}
                    if log_every else set()) | {num_iters})
    assert t_rec["saves"] == j_rec["saves"] and t_rec["vals"] == j_rec["vals"]
    assert len(starts) == num_iters == sum(j_rec["chunks"])
    ends = np.cumsum(j_rec["chunks"]).tolist()
    assert set(ends) >= set(stops) and all(c <= spc for c in j_rec["chunks"])
