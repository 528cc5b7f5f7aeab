"""The port's K4 (the 3-pass accurate trace evaluator of
Stage2Config.trace_pallas) and K5 (the f32 full-output SDF) on the CPU: each
kernel's plain PyTorch version (what the wrapper computes for a CPU tensor,
and what the kernel is held to on the card by chip_smoke.py) against the JAX
package's Pallas kernel in interpret mode and at the tolerances of
tests/test_kernels.py, the hi/lo weight split, and the slice as a whole:
render_camera at the full default width with its trace through K4, against
the JAX render with its trace through the JAX kernel's own body."""
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.core.camera import make_camera as j_make_camera
from iron_tpu.fields.sdf import SDFConfig as JSDFConfig, init_sdf as j_init_sdf
from iron_tpu.fields.sdf import sdf_only as j_sdf_only, sdf_value_feat_grad as j_vfg
from iron_tpu.kernels.fused_sdf import (_fused_sdf_panel_3pass, _prepare_3pass_weights,
                                        make_pallas_sdf_fn, make_pallas_sdf_only_3pass_fn)
from iron_tpu.shading.materials import shade_points as j_shade
from iron_tpu.surface.render import SurfaceRenderConfig as JSurf, render_camera as j_render
from iron_tpu.surface.tracer import TracerConfig as JTracerConfig
from iron_tpu.train.stage2 import Stage2Config as JStage2Config
from iron_tpu.train.stage2 import init_light_from_cameras as j_init_light
from iron_tpu.train.stage2 import init_stage2_params as j_init_stage2

from iron_tpu_torch.core.camera import make_camera
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy, sdf_only, sdf_value_feat_grad
from iron_tpu_torch.kernels import fused_sdf as K4
from iron_tpu_torch.kernels import fused_sdf_grad as K5
from iron_tpu_torch.kernels import launch_counts, make_sdf_fn, reset_launch_counts
from iron_tpu_torch.shading.materials import renderer_network_configs, shade_points
from iron_tpu_torch.surface.render import SurfaceRenderConfig, render_camera
from iron_tpu_torch.surface.tracer import TracerConfig
from iron_tpu_torch.train.checkpoints import params_from_numpy

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()


def _nets(seed=0, **kw):
    jcfg = JSDFConfig(**kw)
    params = jax.tree_util.tree_map(np.asarray, j_init_sdf(jax.random.PRNGKey(seed), jcfg))
    return params, jcfg, sdf_from_numpy(params, SDFConfig(**kw), "cpu")


def _uniform(seed, shape, lim):
    return np.random.default_rng(seed).uniform(-lim, lim, size=shape).astype(np.float32)


def test_sdf_only_3pass_plain_matches_jax_kernel():
    """K4's plain version against the JAX kernel (Pallas interpret mode,
    tile 128, so 7 grid steps) at the full SDFConfig() on 777 points: the
    same arithmetic up to the order of f32 sums, atol 5e-5."""
    params, jcfg, net = _nets()
    x = _uniform(3, (777, 3), 1.0)
    ref = np.asarray(make_pallas_sdf_only_3pass_fn(params, jcfg, tile=128,
                                                   interpret=True)(jnp.asarray(x)))
    reset_launch_counts()
    got = N(K4.sdf_only_3pass(K4.prepare_3pass_weights(net), T(x)))
    assert all(v == 0 for v in launch_counts().values())   # CPU tensors: plain versions
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=5e-5)


def test_sdf_only_3pass_plain_is_f32_class():
    """The criteria of tests/test_kernels.py for the JAX kernel: within 5e-4
    of the f32 SDF, and under 0.3 x the error of the bf16 coarse evaluator
    (K2's plain version) on the same points."""
    params, jcfg, net = _nets()
    x = _uniform(3, (777, 3), 1.0)
    ref = np.asarray(j_sdf_only(params, jnp.asarray(x), jcfg))
    got = N(K4.sdf_only_3pass(K4.prepare_3pass_weights(net), T(x)))
    coarse = N(K4.sdf_only_bf16(K4.prepare_bf16_weights(net), T(x)))
    np.testing.assert_allclose(got, ref, atol=5e-4)
    assert np.abs(got - ref).max() < 0.3 * np.abs(coarse - ref).max()


def test_sdf_only_3pass_plain_leading_dims_and_scale():
    params, jcfg, net = _nets(seed=1, scale=1.7)
    x = _uniform(5, (6, 37, 3), 0.8)
    got = N(K4.make_sdf_only_3pass_fn(net)(T(x)))
    assert got.shape == (6, 37)
    np.testing.assert_allclose(got, np.asarray(j_sdf_only(params, jnp.asarray(x), jcfg)),
                               atol=5e-4)


def test_3pass_weight_split_reproduces_the_layout():
    """hi + lo reproduces every matrix of padded_layers (the final one's sdf
    column) to 2^-16 of each entry: hi rounds to 8 significant bits and lo
    to 8 more.  Both halves carry the f32 biases unchanged."""
    _, _, net = _nets()
    mats, biases, skip = K4.padded_layers(net)
    w = K4.prepare_3pass_weights(net)
    mats = mats[:-1] + [mats[-1][:, :1]]
    assert len(w.hi.mats) == len(w.lo.mats) == len(mats) and w.hi.skip == skip
    for m, hi, lo in zip(mats, w.hi.mats, w.lo.mats):
        assert torch.equal(hi, hi.to(torch.bfloat16).float())
        assert torch.equal(lo, lo.to(torch.bfloat16).float())
        assert bool(((hi + lo - m).abs() <= 2.0 ** -16 * m.abs()).all())
    for a, b, ref in zip(w.hi.biases, w.lo.biases, biases[:-1] + [biases[-1][:1]]):
        assert torch.equal(a, ref) and torch.equal(b, ref)
    torch.testing.assert_close(w.lo.wlast.float(), w.lo.mats[-1][:, 0], rtol=0, atol=0)


def test_k4_weight_stream_cluster_slices_reproduce_the_layout():
    """K4's weight stream: the packed matrices in layer order are a sequence
    of k-tiles of 16 x 256 (1,024 uint2 each, `n_ktiles` in all), and CTA r
    of a cluster copies the 2 KB at uint2 offset 1,024 c + 256 r of k-tile c,
    its 8 n-tiles.  Unpacked, those slices are rows [16 kt, 16 kt + 16) and
    columns [64 r, 64 r + 64) of the hi and lo matrices, and hi + lo
    reproduces the f32 layout to 2^-16 of each entry."""
    _, _, net = _nets(seed=1, scale=1.7)
    w = K4.prepare_3pass_weights(net)
    mats, _, skip = K4.padded_layers(net)
    per_tile = 16 * K4.HID                       # bf16 values in a packed k-tile
    n_ktiles = w.hi.wpack.numel() // per_tile
    ktiles = [(mi, kt) for mi, m in enumerate(mats[:-1]) for kt in range(m.shape[0] // 16)]
    assert n_ktiles == len(ktiles) == 3 + 7 * 16 + 3 and skip == 4
    for c, (mi, kt) in enumerate(ktiles):
        for r in range(4):
            lo_hi = []
            for half in (w.hi, w.lo):
                sl = half.wpack.reshape(-1)[c * per_tile + 1024 * r:c * per_tile + 1024 * (r + 1)]
                # [8 n-tiles, lanes (g, t), (half8, pair)] -> [16 k, 64 n]
                sl = sl.reshape(8, 8, 4, 2, 2).permute(3, 2, 4, 0, 1).reshape(16, 64).float()
                assert torch.equal(sl, half.mats[mi][16 * kt:16 * kt + 16, 64 * r:64 * r + 64])
                lo_hi.append(sl)
            ref = mats[mi][16 * kt:16 * kt + 16, 64 * r:64 * r + 64]
            assert bool(((lo_hi[0] + lo_hi[1] - ref).abs() <= 2.0 ** -16 * ref.abs()).all())


@pytest.mark.parametrize("n,width", [(1, 4), (1852, 4), (4096, 4), (4224, 2), (8384, 2),
                                     (8448, 1), (262144, 1)])
def test_k4_width(n, width):
    """K4's cluster width on a 132-SM card: 4 CTAs a 64-row tile for the
    trace_pallas step's small calls (a 1,852-point call runs 116 CTAs), then
    the narrowest width whose grid covers the SMs: 2 from 66 tiles, 1 (one
    CTA a tile) from 132."""
    assert K4.k4_width(n, 132) == width
    tiles = -(-n // 64)
    assert width * tiles >= 132 or width == 4


@pytest.mark.parametrize("shape,seed", [((300, 3), 1), ((7, 11, 3), 2)])
def test_sdf_full_plain_matches_jax_kernel(shape, seed):
    """K5's plain version against the JAX kernel (interpret mode, tile 128)
    at the full SDFConfig(): all 257 columns, atol 2e-5 / rtol 1e-5, the
    tolerances of tests/test_kernels.py."""
    params, jcfg, net = _nets()
    x = (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(np.float32)
    ref = np.asarray(make_pallas_sdf_fn(params, jcfg, tile=128, interpret=True)(jnp.asarray(x)))
    reset_launch_counts()
    got = N(make_sdf_fn(net)(T(x)))
    assert all(v == 0 for v in launch_counts().values())
    assert got.shape == shape[:-1] + (jcfg.d_out,) == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_sdf_full_plain_is_k3_forward():
    """K5 is K3-fwd's forward sweep alone: its columns are K3-fwd's value and
    features on the same prepared weights, bit for bit on the CPU, and
    they carry no graph."""
    _, _, net = _nets(seed=2, scale=2.0)
    x = T(_uniform(4, (64, 3), 0.5)).requires_grad_(True)
    w = K5.prepare_grad_weights(net)
    full = K5.sdf_full(w, x)
    v, f, _ = K5.sdf_value_feat_grad_plain(w, x)
    assert not full.requires_grad
    torch.testing.assert_close(full[:, 0], v, rtol=0, atol=0)
    torch.testing.assert_close(full[:, 1:], f, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

BUDGETS = dict(fallback_budget=64, edge_side_fallback_budget=32)


@pytest.fixture(scope="module")
def full_width_scene():
    """JAX stage-2 parameters at the full default SDF width with the comp
    renderer (init from PRNGKey(0), the light from the camera), a 32x32 view
    of the geometric-init sphere, and the JAX render_camera of that view in
    eval and in training mode, with trace_sdf_fn bound to the JAX kernel's
    own body (_fused_sdf_panel_3pass on _prepare_3pass_weights, what
    interpret mode runs per tile).  Both modes are one jit, with the weights
    as its arguments, so that XLA compiles once and folds no weights."""
    H = 32
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 1.25 * H
    K[0, 2] = K[1, 2] = H / 2
    W2C = np.eye(4, dtype=np.float32)
    W2C[:3, :3] = np.diag([1.0, -1.0, -1.0])
    W2C[2, 3] = 3.0
    jcfg = JStage2Config()
    params, jmats = j_init_stage2(jax.random.PRNGKey(0), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["materials"]["point_light_network"]["light"] = np.asarray(
        j_init_light(W2C[None], jcfg.init_light_scale), np.float32)
    scale = np.float32(1.0 / jcfg.sdf.scale)
    Whi, Wlo, b, skip = _prepare_3pass_weights(params["sdf"], jcfg.sdf)
    surf = JSurf(tracer=JTracerConfig(fallback_budget=BUDGETS["fallback_budget"]),
                 edge_side_fallback_budget=BUDGETS["edge_side_fallback_budget"])

    def renders(p, Whi, Wlo, b):
        def j_trace(x):
            flat = _fused_sdf_panel_3pass(x.reshape(-1, 3), Whi, Wlo, b, jcfg.sdf, skip)
            return (flat[:, 0] * scale).reshape(x.shape[:-1])
        return {is_training: j_render(
            lambda x: j_sdf_only(p["sdf"], x, jcfg.sdf), lambda x: j_vfg(p["sdf"], x, jcfg.sdf),
            lambda *a: j_shade("comp", p["materials"], jmats, *a),
            j_make_camera(K, W2C, H, H), surf, is_training=is_training, trace_sdf_fn=j_trace)
            for is_training in (False, True)}

    refs = jax.jit(renders)(params, Whi, Wlo, b)
    return {"H": H, "K": K, "W2C": W2C, "params": params,
            "refs": {m: {k: np.asarray(v) for k, v in r.items()} for m, r in refs.items()}}


@pytest.mark.parametrize("is_training", [False, True])
def test_render_camera_with_k4_trace_matches_jax(full_width_scene, is_training):
    """render_camera at 32x32 and the full default width (comp), every trace
    evaluation (refine, stragglers, fallback revalidation, bisection, the
    edge-side traces) through K4 (its plain version on the CPU), against
    the JAX render of the fixture, in eval and in training mode.  The
    fallback budgets are cut to 64 image rays and 32 rays a side (the
    defaults sweep every ray of a 32x32 view, 2 x 131,072 points a render),
    so the image trace takes the budgeted path of a full-size render and the
    test stays short.  Identical hit, convergent and edge masks.  Roots agree
    to the tracer's 5e-5 threshold (each package takes its own f32 step
    sequence), so depth and normals to 1e-4 as in the whole-slice render
    test (5.1e-5 and 9.3e-5 measured)."""
    s = full_width_scene
    H, ref = s["H"], s["refs"][is_training]
    tp = params_from_numpy(s["params"], "cpu", SDFConfig(), "comp")
    net = tp["sdf"]
    tcfgs = renderer_network_configs("comp")
    k4 = K4.make_sdf_only_3pass_fn(net)
    traced = []
    res = render_camera(lambda p: sdf_only(net, p), lambda p: sdf_value_feat_grad(net, p),
                        lambda *a: shade_points("comp", tp["materials"], tcfgs, *a),
                        make_camera(s["K"], s["W2C"], H, H, device="cpu"),
                        SurfaceRenderConfig(
                            tracer=TracerConfig(fallback_budget=BUDGETS["fallback_budget"]),
                            edge_side_fallback_budget=BUDGETS["edge_side_fallback_budget"]),
                        is_training=is_training,
                        trace_sdf_fn=lambda p: traced.append(p.shape) or k4(p))
    assert len(traced) > 10    # the trace and the edge-side traces went through K4
    got = {k: N(v) for k, v in res.items() if isinstance(v, torch.Tensor)}
    for k in ("convergent_mask", "hit_mask", "edge_mask"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert ref["hit_mask"].sum() > 100 and ref["edge_mask"].sum() > 10
    m = ref["hit_mask"] | ref["edge_mask"]
    np.testing.assert_allclose(got["depth"][m], ref["depth"][m], atol=1e-4)
    np.testing.assert_allclose(got["normal"][m], ref["normal"][m], atol=1e-4)
