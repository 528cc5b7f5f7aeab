"""The port's stage-2 curriculum (train/curriculum.py) against the JAX
package's on the CPU, at tests/test_curriculum_interp.py's configuration
(3 views of 48x48, 16x16 crops, the small tracer budgets) with a narrow
SDF: the rgb, refrac and env phases of 2 steps each.  Every phase starts
from the JAX parameters at that phase's start, a fresh optimizer and the
phase's freezing; each step takes the JAX run's crop and eikonal points."""
import dataclasses

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp
import optax

from iron_tpu.data.synthetic import render_synthetic_dataset as j_synthetic
from iron_tpu.fields.sdf import SDFConfig as JSDFConfig
from iron_tpu.surface.render import SurfaceRenderConfig as JSurf
from iron_tpu.surface.tracer import TracerConfig as JTracer
from iron_tpu.train.curriculum import PHASE_PLANS as J_PLANS
from iron_tpu.train.stage2 import Stage2Config as JStage2Config
from iron_tpu.train.stage2 import Stage2Trainer as JStage2Trainer

from iron_tpu_torch.fields.sdf import SDFConfig
from iron_tpu_torch.surface.render import SurfaceRenderConfig
from iron_tpu_torch.surface.tracer import TracerConfig
from iron_tpu_torch.train.checkpoints import params_from_numpy, params_to_numpy
from iron_tpu_torch.train.curriculum import PHASE_PLANS, CurriculumPhase, CurriculumTrainer
from iron_tpu_torch.train.stage2 import Stage2Config

NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
SURF = dict(edge_budget=32, edge_side_fallback_budget=16)
TRACE = dict(sphere_tracing_iters=16, dense_iters=8, fallback_budget=64)
PHASES = ("rgb", "refrac", "env")
STEPS = 2
PS = 16


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.array(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _adam_grads(opt_state):
    """The gradients of a fresh Adam's first step, per trainable leaf, read
    back from optax's first moment (mu = 0.1 g); frozen leaves carry no
    state (set_to_zero)."""
    out = {}
    for st in opt_state.inner_states.values():
        for s in jax.tree_util.tree_leaves(
                st.inner_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
            if isinstance(s, optax.ScaleByAdamState):
                out.update({k: v / np.float32(0.1) for k, v in _leaves(s.mu).items()})
    return out


def _cfgs():
    common = dict(renderer_name="comp", patch_size=PS)
    return (JStage2Config(sdf=JSDFConfig(**NARROW),
                          surface=JSurf(tracer=JTracer(**TRACE), **SURF), **common),
            Stage2Config(sdf=SDFConfig(**NARROW),
                         surface=SurfaceRenderConfig(tracer=TracerConfig(**TRACE), **SURF),
                         **common))


@pytest.fixture(scope="module")
def data():
    return j_synthetic("sphere", n_views=3, H=48, W=48, light=30.0)


@pytest.fixture(scope="module")
def jax_run(data):
    """The JAX curriculum as iron_tpu/train/curriculum.py:84-106 runs it, each
    phase's steps as Stage2Trainer.run takes them (iron_tpu/train/
    stage2.py:624-640: the host crop RNG, a key split a step), recording per
    phase its start, each step's crop, eikonal points, metrics and
    parameters after."""
    jcfg, _ = _cfgs()
    params, step, out = None, 0, []
    for name in PHASES:
        plan = J_PLANS[name]
        cfg = dataclasses.replace(jcfg, use_env_light=plan["use_env_light"])
        tr = JStage2Trainer(cfg, data["images"], data["Ks"], data["W2Cs"],
                            trainable=plan["trainable"])
        if params is not None:
            tr.params = params
            tr.opt_state = tr.tx.init(tr.params)
        rec = {"name": name, "start": _leaves(tr.params), "start_tree":
               jax.tree_util.tree_map(np.array, tr.params), "step": step, "steps": []}
        key = jax.random.PRNGKey(1)
        g = np.random.default_rng(1_000_003 + step)
        p, o = tr.params, tr.opt_state
        for _ in range(STEPS):
            key, k_s = jax.random.split(key)
            crop = tuple(int(g.integers(0, n)) for n in (3, 48 - PS, 48 - PS))
            k_eik, = jax.random.split(k_s, 1)
            eik = np.asarray(jax.random.uniform(k_eik, ((PS * PS) // 2, 3), minval=-1.0,
                                                maxval=1.0))
            p, o, m = tr._train_step(p, o, k_s, *(jnp.asarray(c, jnp.int32) for c in crop))
            rec["steps"].append({"crop": crop, "eik": eik, "after": _leaves(p),
                                 "metrics": {k: float(v) for k, v in m.items()}})
            if len(rec["steps"]) == 1:
                rec["grads"] = _adam_grads(o)
        params, step = p, step + STEPS
        out.append(rec)
    return out


def test_phase_plans_match_jax():
    assert PHASE_PLANS == J_PLANS


def _hold_first_step(tr, ref_g, old, ref_p):
    """The first step of a phase as tests/test_torch_train.py::
    test_one_training_step_matches_jax holds a step: every trainable leaf's
    gradient to rtol 2e-3 and 4e-3 of its largest entry (+ 1e-10); the
    parameters after the fresh Adam's first update, lr * g / (|g| + 1e-8), to
    1e-3 of the group's learning rate where |g| exceeds both 1e-6 and ten
    times the leaf's largest gradient difference, elsewhere (the update's
    size or sign follows rounding) to 2 lr.

    The gradient hold is twice that test's 2e-3 of the largest entry: the
    two tracers' roots agree to the 5e-5 root threshold, not bit for bit,
    and here the 256 points of a 16x16 crop (a quarter of that test's)
    carry them into the positionally encoded heads (the diffuse albedo net
    at up to 2^9, metallic_k at 2^5); the largest difference is 2.7e-3 of
    its leaf's largest entry (diffuse_albedo_network layer 1 in the rgb
    phase, metallic_k_network layer 0 in the refrac phase)."""
    named = dict(tr.params.named_parameters())
    grads = {}
    for k in ref_g:
        name = ".".join(x.strip("[]'") for x in k.split("]")[:-1])
        p = named[name]
        grads[k] = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy().copy()
    lrs = {g["name"]: g["lr"] for g in tr.opt.opt.param_groups}
    got_p = _leaves(params_to_numpy(tr.params))
    assert ref_g
    for k, a in ref_g.items():
        np.testing.assert_allclose(grads[k], a, rtol=2e-3,
                                   atol=4e-3 * float(np.abs(a).max()) + 1e-10, err_msg=k)
        net = "sdf" if k.startswith("['sdf']") else "mat/" + k.split("'")[3]
        lr = lrs[net]
        g_err = float(np.abs(grads[k] - a).max())
        loose = np.abs(a) < max(1e-6, 10 * g_err)
        err = np.abs(got_p[k] - ref_p[k]) - 1e-7 * np.abs(ref_p[k])
        assert np.all(err[~loose] <= 1e-3 * lr), k
        assert np.all(err[loose] <= 2 * lr), k
    for k in set(old) - set(ref_g):
        np.testing.assert_array_equal(got_p[k], ref_p[k], err_msg=k)


@pytest.mark.parametrize("phase", PHASES)
def test_curriculum_phase_matches_jax(data, jax_run, phase):
    """The phase's trainer (CurriculumTrainer.phase_trainer, from the JAX
    parameters at the phase's start): its first step's loss and metrics to
    2e-4 relative, its gradients and update held by _hold_first_step; over
    the phase's 2 steps the set of leaves that moved equals JAX's, and every
    frozen leaf is bit-equal to its value at the phase's start, in both."""
    rec = next(r for r in jax_run if r["name"] == phase)
    _, tcfg = _cfgs()
    cur = CurriculumTrainer(tcfg, data["images"], data["Ks"], data["W2Cs"],
                            phases=[CurriculumPhase(phase, STEPS)], device="cpu")
    cur.params = params_from_numpy(rec["start_tree"], "cpu", tcfg.sdf, "comp")
    cur.step = rec["step"]
    tr = cur.phase_trainer(cur.phases[0])
    assert tr.cfg.use_env_light == (phase == "env") and tr.step == rec["step"]
    trainable = PHASE_PLANS[phase]["trainable"]
    groups = {g["name"] for g in tr.opt.opt.param_groups}
    assert groups == {"sdf" if k == "sdf" else f"mat/{k}" for k, on in trainable.items() if on}

    for i, s in enumerate(rec["steps"]):
        m = tr.train_step(*s["crop"], torch.as_tensor(s["eik"]))
        if i == 0:
            assert set(m) == set(s["metrics"])
            for k, v in s["metrics"].items():
                np.testing.assert_allclose(float(m[k]), v, rtol=2e-4, atol=1e-7, err_msg=k)
            _hold_first_step(tr, rec["grads"], rec["start"], s["after"])
    assert tr.step == rec["step"] + STEPS

    start, ref = rec["start"], rec["steps"][-1]["after"]
    got = _leaves(params_to_numpy(tr.params))
    moved = lambda tree: {k for k in start if not np.array_equal(tree[k], start[k])}
    net = lambda k: "sdf" if k.startswith("['sdf']") else k.split("'")[3]
    frozen = {k for k in start if not trainable[net(k)]}
    assert frozen and moved(ref) and not (moved(ref) & frozen)
    assert moved(got) == moved(ref)
    for k in frozen:
        np.testing.assert_array_equal(got[k], start[k], err_msg=k)


def test_curriculum_run_carries_parameters_and_step(data, tmp_path):
    """CurriculumTrainer.run: 3 phases of 1 step, the parameters and step
    carried over (the next phase's trainer holds the same modules), a save
    at each phase's end, frozen leaves untouched within each phase; CUDA
    without a card raises."""
    _, tcfg = _cfgs()
    cur = CurriculumTrainer(tcfg, data["images"], data["Ks"], data["W2Cs"],
                            phases=[CurriculumPhase(n, 1) for n in PHASES],
                            out_dir=str(tmp_path), device="cpu", seed=3)
    seen = []
    make = cur.phase_trainer

    def traced(phase):
        tr = make(phase)
        seen.append((phase.name, tr, _leaves(params_to_numpy(tr.params)), tr.step))
        return tr

    cur.phase_trainer = traced
    m = cur.run()
    assert np.isfinite(m["loss"]) and cur.step == 3
    assert [s[3] for s in seen] == [0, 1, 2]
    assert seen[1][1].params is seen[0][1].params and cur.params is seen[2][1].params
    for i, (name, tr, start, _) in enumerate(seen):
        end = seen[i + 1][2] if i + 1 < len(seen) else _leaves(params_to_numpy(cur.params))
        trainable = PHASE_PLANS[name]["trainable"]
        for k, a in start.items():
            net = "sdf" if k.startswith("['sdf']") else k.split("'")[3]
            if not trainable[net]:
                np.testing.assert_array_equal(end[k], a, err_msg=f"{name} {k}")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_0000001.pkl", "ckpt_0000002.pkl", "ckpt_0000003.pkl"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CurriculumTrainer(tcfg, data["images"], data["Ks"], data["W2Cs"], device="cuda")
