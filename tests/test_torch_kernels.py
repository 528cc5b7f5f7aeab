"""The port's kernel modules on the CPU: each kernel's plain PyTorch version
(what the wrapper computes for a CPU tensor, and what the kernel is held to
on the card by chip_smoke.py) against the JAX package, plus the host-side
weight layout the CUDA kernels read."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.fields.sdf import SDFConfig as JSDFConfig, init_sdf as j_init_sdf
from iron_tpu.fields.sdf import sdf_only as j_sdf_only, sdf_value_feat_grad as j_vfg
from iron_tpu.kernels.fused_sdf import _fused_sdf_panel_bf16, _prepare_bf16_weights
from iron_tpu.surface.tracer import TracerConfig as JTracerConfig, raytrace as j_raytrace

from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy, sdf_only
from iron_tpu_torch.kernels import build
from iron_tpu_torch.kernels import fused_sdf as K12
from iron_tpu_torch.kernels import fused_sdf_grad as K3
from iron_tpu_torch.kernels import launch_counts, reset_launch_counts
from iron_tpu_torch.surface.tracer import TracerConfig, raytrace

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nets(seed=0, **kw):
    jcfg = JSDFConfig(**kw)
    params = jax.tree_util.tree_map(np.asarray, j_init_sdf(jax.random.PRNGKey(seed), jcfg))
    return params, jcfg, sdf_from_numpy(params, SDFConfig(**kw), "cpu")


def test_sdf_only_bf16_plain_matches_jax_sdf_only():
    """K2's arithmetic stays inside the coarse error budget of the JAX
    package's bf16 kernel (atol 1.2e-2, tests/test_kernels.py)."""
    params, jcfg, net = _nets()
    x = np.random.default_rng(3).uniform(-1, 1, size=(777, 3)).astype(np.float32)
    w = K12.prepare_bf16_weights(net)
    got = N(K12.sdf_only_bf16(w, T(x)))
    ref = np.asarray(j_sdf_only(params, jnp.asarray(x), jcfg))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1.2e-2)


def test_sdf_only_bf16_plain_leading_dims_and_scale():
    params, jcfg, net = _nets(seed=5, scale=2.0)
    x = np.random.default_rng(6).uniform(-0.5, 0.5, size=(5, 9, 3)).astype(np.float32)
    got = N(K12.sdf_only_bf16(K12.prepare_bf16_weights(net), T(x)))
    assert got.shape == (5, 9)
    np.testing.assert_allclose(got, np.asarray(j_sdf_only(params, jnp.asarray(x), jcfg)),
                               atol=1.2e-2)


def test_sdf_only_bf16_plain_is_the_jax_kernels_arithmetic():
    """Against the JAX kernel's own body run outside Pallas (bf16 operands,
    f32 accumulation): the same function up to the order of f32 sums, which
    can move a bf16 rounding of an activation by one unit."""
    params, jcfg, net = _nets()
    x = np.random.default_rng(7).uniform(-1, 1, size=(512, 3)).astype(np.float32)
    mats, biases, skip = _prepare_bf16_weights(params, jcfg)
    ref = np.asarray(_fused_sdf_panel_bf16(jnp.asarray(x), mats, biases, jcfg, skip))[:, 0]
    got = N(K12.sdf_only_bf16_plain(K12.prepare_bf16_weights(net), T(x)))
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_pack_mma_b_fragment_layout():
    """The packed B fragments hold what mma.sync m16n8k16 expects: lane
    (g, t) of n-tile nt and k-tile kt holds W[16kt + 2t + {0,1,8,9}, 8nt + g]."""
    w = torch.arange(48 * 256, dtype=torch.float32).reshape(48, 256) % 251
    p = K12.pack_mma_b(w).float()
    assert p.shape == (3, 32, 32, 4)
    for kt in range(3):
        for nt in (0, 5, 31):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                rows = [16 * kt + 2 * t + d for d in (0, 1, 8, 9)]
                np.testing.assert_array_equal(N(p[kt, nt, g * 4 + t]),
                                              N(w[rows, 8 * nt + g]))


def test_prepared_layout_reproduces_the_sdf():
    """The padded layout of padded_layers (PE rows padded to 48, the layer
    feeding the skip padded to 256, skip split in two) is the same SDF."""
    params, jcfg, net = _nets()
    x = np.random.default_rng(8).normal(size=(64, 3)).astype(np.float32) * 0.5
    w = K3.prepare_grad_weights(net)
    v, f, _ = K3.sdf_value_feat_grad_plain(w, T(x))
    with torch.no_grad():
        ref = sdf_only(net, T(x))
    np.testing.assert_allclose(N(v), N(ref), atol=2e-5)


def test_sdf_value_feat_grad_plain_matches_jax():
    """K3-fwd's sweeps against the JAX autodiff reference, at the 1e-5 of
    the JAX fused-kernel test (tests/test_kernels.py)."""
    params, jcfg, net = _nets()
    x = (np.random.default_rng(1).normal(size=(200, 3)) * 0.4).astype(np.float32)
    v1, f1, g1 = j_vfg(params, jnp.asarray(x), jcfg)
    v2, f2, g2 = K3.sdf_value_feat_grad(K3.prepare_grad_weights(net), T(x))
    for a, b in [(v1, v2), (f1, f2), (g1, g2)]:
        np.testing.assert_allclose(N(b), np.asarray(a), rtol=1e-5, atol=1e-5)


def test_raytrace_with_coarse_plain_versions_matches_jax_accurate():
    """The port's raytrace with K1's plain version as coarse_march_fn and
    K2's as coarse_sdf_fn, against the JAX accurate-only raytrace on the
    geometric-init SDF: the same convergent set, distances within 2e-3, and
    every root on the accurate surface."""
    params, jcfg, net = _nets()
    n = 256
    g = np.random.default_rng(3)
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray_o = (2.5 * d).astype(np.float32)
    ray_d = 0.2 * g.normal(size=(n, 3)) - ray_o
    ray_d = (ray_d / np.linalg.norm(ray_d, axis=-1, keepdims=True)).astype(np.float32)
    min_dis = np.full((n,), 0.5, np.float32)
    max_dis = np.full((n,), 4.5, np.float32)
    work = np.ones((n,), bool)

    ref = j_raytrace(lambda p: j_sdf_only(params, p, jcfg), *map(jnp.asarray, (
        ray_o, ray_d, min_dis, max_dis, work)), JTracerConfig())
    tc = TracerConfig()
    w = K12.prepare_bf16_weights(net)
    march = lambda *a: K12.coarse_march(w, *a, threshold=tc.coarse_threshold)
    sdf_fn = lambda p: sdf_only(net, p)
    reset_launch_counts()
    with torch.no_grad():
        got = raytrace(sdf_fn, *map(T, (ray_o, ray_d, min_dis, max_dis, work)), tc,
                       coarse_sdf_fn=lambda p: K12.sdf_only_bf16(w, p), coarse_march_fn=march)
        hit_sdf = N(sdf_fn(got["points"]))
    assert all(v == 0 for v in launch_counts().values())   # CPU tensors: plain versions
    ref_conv, got_conv = np.asarray(ref["convergent_mask"]), N(got["convergent_mask"])
    assert ref_conv.sum() > 50
    np.testing.assert_array_equal(got_conv, ref_conv)
    np.testing.assert_allclose(N(got["distance"])[ref_conv],
                               np.asarray(ref["distance"])[ref_conv], atol=2e-3)
    assert np.abs(hit_sdf[got_conv]).max() <= tc.sdf_threshold * 1.01


def test_coarse_march_plain_semantics():
    """K1's plain version: rays stop at |sdf| <= threshold or max_dis, an
    inactive ray keeps its state, and the loop honours n_iters."""
    params, jcfg, net = _nets()
    w = K12.prepare_bf16_weights(net)
    n = 64
    ro = np.tile(np.array([0, 0, 3.0], np.float32), (n, 1))
    tgt = np.random.default_rng(2).uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    rd = tgt - ro
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    work = np.ones(n, bool)
    work[::4] = False
    acc0 = np.full(n, 1.0, np.float32)
    act, acc, s = K12.coarse_march(w, T(ro), T(rd), T(acc0), T(work), T(np.full(n, 4.0,
                                   np.float32)), 40, 2e-2)
    act, acc, s = N(act), N(acc), N(s)
    assert not act.any()
    np.testing.assert_array_equal(acc[~work], acc0[~work])
    assert np.all(np.abs(s[work]) <= 2e-2) and np.all(acc[work] > 2.0)
    act1, acc1, _ = K12.coarse_march(w, T(ro), T(rd), T(acc0), T(work),
                                     T(np.full(n, 4.0, np.float32)), 1, 2e-2)
    assert N(act1)[work].all() and np.all(N(acc1)[work] > acc0[work])


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """Loading a kernel whose library is not built, with no nvcc to build
    it, raises: nothing falls back to the plain version."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("fused_sdf")


def test_port_imports_without_jax_nvcc_or_triton():
    """Every module of the port imports in a process without nvcc on PATH,
    and none of them imports JAX or the JAX package."""
    code = ("import pkgutil, sys, iron_tpu_torch\n"
            "for m in pkgutil.walk_packages(iron_tpu_torch.__path__, 'iron_tpu_torch.'):\n"
            "    __import__(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'iron_tpu' or m.startswith('iron_tpu.') or m == 'triton']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
