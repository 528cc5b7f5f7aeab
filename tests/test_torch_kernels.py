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
from torch.overrides import TorchFunctionMode
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.fields.sdf import SDFConfig as JSDFConfig, init_sdf as j_init_sdf
from iron_tpu.fields.sdf import sdf_only as j_sdf_only, sdf_value_feat_grad as j_vfg
from iron_tpu.kernels.fused_sdf import _fused_sdf_panel_bf16, _prepare_bf16_weights
from iron_tpu.surface.tracer import TracerConfig as JTracerConfig, raytrace as j_raytrace

from iron_tpu_torch.core.embedder import positional_encoding
from iron_tpu_torch.fields.sdf import (SDFConfig, sdf_from_numpy, sdf_only, sdf_value_feat_grad,
                                      softplus100)
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


def _second_order_loss(v, ft, g, lib):
    """tests/test_kernels.py's eikonal-style loss, in JAX or PyTorch."""
    if lib is jnp:
        return (jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2) + jnp.mean(v ** 2)
                + 1e-3 * jnp.mean(ft ** 2))
    return (((torch.linalg.norm(g, dim=-1) - 1.0) ** 2).mean() + (v ** 2).mean()
            + 1e-3 * (ft ** 2).mean())


def _torch_grads(net, x, fn):
    """d loss / d (x, every layer's v, g, b) with the values of fn(x)."""
    xt = T(x).requires_grad_(True)
    loss = _second_order_loss(*fn(xt), torch)
    leaves = [xt] + [getattr(l, k) for l in net.layers for k in ("v", "g", "b")]
    return [N(t) for t in torch.autograd.grad(loss, leaves)]


@pytest.fixture(scope="module")
def jax_backward_reference():
    """The JAX package's fused kernel pair (forward and `_core_bwd`, Pallas
    in interpret mode, tile 128 so that dW accumulates over two tiles) at the
    full default SDFConfig: d loss / d (x, every layer's v, g, b) of the
    second-order loss of tests/test_kernels.py on 200 points."""
    from iron_tpu.kernels.fused_sdf_grad import make_fused_sdf_grad_fn as j_make_fused
    params, jcfg, _ = _nets()
    x = (np.random.default_rng(1).normal(size=(200, 3)) * 0.4).astype(np.float32)
    fused = j_make_fused(jcfg, tile=128, interpret=True)
    jgp, jgx = jax.grad(lambda p, xx: _second_order_loss(*fused(p, xx), jnp),
                        argnums=(0, 1))(params, jnp.asarray(x))
    leaves = [np.asarray(jgp["layers"][i][k]) for i in range(len(params["layers"]))
              for k in ("v", "g", "b")]
    return x, np.asarray(jgx), leaves


def _assert_matches_jax_backward(got, ref):
    """dx to rtol 1e-4 / atol 1e-7 and every parameter leaf to rtol 1e-4 /
    atol 1e-6: the tolerances of tests/test_kernels.py for the JAX kernel."""
    x, jgx, leaves = ref
    np.testing.assert_allclose(got[0], jgx, rtol=1e-4, atol=1e-7)
    assert len(leaves) == len(got) - 1
    for a, b in zip(got[1:], leaves):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_sdf_value_feat_grad_bwd_plain_matches_jax_backward_kernel(jax_backward_reference):
    """K3-bwd's plain version, through the port's autograd Function and the
    differentiable weight preparation, against the JAX package's fused
    kernel pair on the second-order loss of tests/test_kernels.py."""
    _, _, net = _nets()
    x = jax_backward_reference[0]
    w = K3.prepare_grad_weights(net, differentiable=True)
    reset_launch_counts()
    got = _torch_grads(net, x, lambda xt: K3.sdf_value_feat_grad(w, xt))
    assert all(v == 0 for v in launch_counts().values())   # CPU tensors: plain versions
    _assert_matches_jax_backward(got, jax_backward_reference)


def _round_tf32(t):
    """t rounded to tf32 as the kernel's split_tf32 does (csrc/split3.cuh):
    add half a unit of the 11th significant bit to the bit pattern, clear the
    13 bits below it."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _round_bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


class _SplitProducts(TorchFunctionMode):
    """Every matrix product a @ b as a 3-pass tensor-core kernel issues it:
    each operand split into hi = round(v) and lo = round(v - hi), then
    a_hi b_hi + a_hi b_lo + a_lo b_hi with f32 sums (the products of the
    parts are exact in f32)."""

    def __init__(self, rnd):
        super().__init__()
        self.rnd = rnd

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__):
            a, b = args
            ah, bh = self.rnd(a), self.rnd(b)
            al, bl = self.rnd(a - ah), self.rnd(b - bh)
            return ah @ bh + ah @ bl + al @ bh
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("parts", ["tf32", "bf16"])
def test_split_backward_against_jax_backward_kernel(jax_backward_reference, parts):
    """The backward computed with split products (every product of the
    plain adjoint, the recomputed forward chain and u-chain included)
    against the JAX package's `_core_bwd`, at the tolerances that hold the
    plain f32 version (above).  With tf32 parts, K3-bwd's route (3xTF32),
    it meets them; with bf16 parts (three bf16 passes, K4's route) the
    parameter gradients miss them, which is why K3-bwd runs tf32."""
    _, _, net = _nets()
    x = jax_backward_reference[0]
    w = K3.prepare_grad_weights(net, differentiable=True)
    rnd = _round_tf32 if parts == "tf32" else _round_bf16

    class SplitCore(torch.autograd.Function):
        @staticmethod
        def forward(ctx, xt, *params):
            ctx.save_for_backward(xt)
            return K3.sdf_value_feat_grad_plain(w, xt)

        @staticmethod
        def backward(ctx, dv, df, dg):
            (xt,) = ctx.saved_tensors
            with _SplitProducts(rnd):
                dW, db, dx = K3.sdf_value_feat_grad_bwd_plain(w, xt, dv, df, dg)
            return (dx, *dW, *db)

    got = _torch_grads(net, x, lambda xt: SplitCore.apply(xt, *w.mats, *w.biases))
    if parts == "tf32":
        _assert_matches_jax_backward(got, jax_backward_reference)
    else:
        with pytest.raises(AssertionError):
            _assert_matches_jax_backward(got, jax_backward_reference)


def _unpack_tf32_b(p):
    """The inverse of pack_tf32_b: [KS, NT, 32, 2] -> [8 KS, 8 NT]."""
    ks, nt = p.shape[:2]
    return p.reshape(ks, nt, 8, 4, 2).permute(0, 4, 3, 1, 2).reshape(8 * ks, 8 * nt)


def test_tf32_packs_reproduce_the_layout():
    """K3-bwd's weights: `bwd_wf` holds every hidden layer's prepared matrix
    (the skip's two) and `bwd_wt` their transposes, then the final layer's
    transpose with its rows padded to a multiple of 8, each packed into
    m16n8k8 tf32 B fragments: lane (g, t) of n-tile nt and k-step ks holds
    W[8 ks + t, 8 nt + g] and W[8 ks + t + 4, 8 nt + g]; unpacked, the f32
    matrices come back bit for bit."""
    _, _, net = _nets(seed=2, scale=2.0)
    w = K3.prepare_grad_weights(net)
    fwd = w.mats[:-1]
    out_pad = -(-w.d_out // 8) * 8
    tr = [m.T for m in fwd] + [torch.nn.functional.pad(w.mats[-1].T, (0, 0, 0, out_pad - w.d_out))]
    for buf, mats in ((w.bwd_wf, fwd), (w.bwd_wt, tr)):
        off = 0
        for m in mats:
            p = buf[off:off + m.numel()].reshape(m.shape[0] // 8, m.shape[1] // 8, 32, 2)
            off += m.numel()
            assert torch.equal(_unpack_tf32_b(p), m)
            for ks, nt, lane in ((0, 0, 0), (1, 2, 13), (m.shape[0] // 8 - 1, m.shape[1] // 8 - 1, 31)):
                g, t = lane >> 2, lane & 3
                assert torch.equal(p[ks, nt, lane], m[[8 * ks + t, 8 * ks + t + 4], 8 * nt + g])
        assert off == buf.numel()


def test_tf32_packs_are_made_at_first_use():
    """Only K3-bwd reads the tf32 packs: preparing the weights and running
    the forward sweep (K3-fwd's and K5's plain versions) packs nothing; the
    first read packs both and later reads get the same tensors."""
    _, _, net = _nets(seed=2, scale=2.0)
    w = K3.prepare_grad_weights(net)
    x = torch.as_tensor((np.random.default_rng(5).normal(size=(7, 3)) * 0.3).astype(np.float32))
    K3.sdf_value_feat_grad_fwd(w, x)
    K3.sdf_full(w, x)
    assert w._bwd_packs is None
    wf, wt = w.bwd_wf, w.bwd_wt
    assert w.bwd_wf is wf and w.bwd_wt is wt
    assert wf.numel() == sum(m.numel() for m in w.mats[:-1])


@pytest.mark.parametrize("n,rows,clusters", [(1, 16, 1), (63, 16, 4), (1024, 48, 22),
                                             (2048, 48, 30), (4096, 48, 30), (100000, 64, 30)])
def test_bwd_tiling(n, rows, clusters):
    """K3-bwd's tiles on a card that holds 30 clusters of 4 CTAs (an H100
    SXM): the fewest rounds 64-row tiles allow, the shortest tile (a
    multiple of 16 rows) that covers the points in them, and tiles spread
    evenly: no cluster takes two tiles more than another."""
    got = K3.bwd_tiling(n, 30)
    assert got == (rows, clusters)
    tiles = -(-n // rows)
    assert rows % 16 == 0 and 16 <= rows <= 64 and tiles * rows >= n
    assert -(-tiles // clusters) == max(1, -(-n // (64 * 30)))


def test_sdf_value_feat_grad_bwd_plain_matches_torch_double_backward():
    """The same adjoint against PyTorch's own double backward through the
    port's autograd `fields.sdf.sdf_value_feat_grad` (create_graph): both
    f32 on the CPU, so they agree to rounding: rtol 1e-4 / atol 1e-6 (dx
    reaches 2 here, where f32 sums in another order differ by a few 1e-7)."""
    _, _, net = _nets(seed=3)
    with torch.no_grad():   # move the PE rows the geometric init zeroes
        for l in net.layers:
            l.v.add_(0.02 * torch.randn(l.v.shape, generator=torch.Generator().manual_seed(4)))
    x = (np.random.default_rng(2).normal(size=(96, 3)) * 0.5).astype(np.float32)
    ref = _torch_grads(net, x, lambda xt: sdf_value_feat_grad(net, xt))
    w = K3.prepare_grad_weights(net, differentiable=True)
    got = _torch_grads(net, x, lambda xt: K3.sdf_value_feat_grad(w, xt))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_sdf_value_feat_grad_bwd_plain_cotangents_and_shapes():
    """The backward of each output alone, on points with leading dims and
    scale 2 (the value's cotangent carries 1/scale, the gradient's none),
    against autograd through the same function in the prepared layout: the
    shapes of the prepared matrices, biases and points, and values to rtol
    1e-4 / atol 1e-6 times each leaf's largest entry (entries reach 20
    here; f32 sums in another order)."""
    _, _, net = _nets(seed=2, scale=2.0)
    x = torch.as_tensor((np.random.default_rng(5).normal(size=(4, 6, 3)) * 0.3)
                        .astype(np.float32))
    w = K3.prepare_grad_weights(net)
    g = np.random.default_rng(6)
    cots = [torch.as_tensor(g.normal(size=s).astype(np.float32))
            for s in ((4, 6), (4, 6, w.d_out - 1), (4, 6, 3))]
    for i in range(3):
        c = [t if j == i else torch.zeros_like(t) for j, t in enumerate(cots)]
        dW, db, dx = K3.sdf_value_feat_grad_bwd(w, x, *c)
        assert [t.shape for t in dW] == [m.shape for m in w.mats]
        assert [t.shape for t in db] == [b.shape for b in w.biases] and dx.shape == x.shape
        xg = x.clone().requires_grad_(True)
        mats = [m.clone().requires_grad_(True) for m in w.mats]
        biases = [b.clone().requires_grad_(True) for b in w.biases]
        wg = K3.GradWeights(**{**w.__dict__, "mats": mats, "biases": biases})
        out = sdf_value_feat_grad_autograd_reference(wg, xg)
        ref = torch.autograd.grad(sum((o * t).sum() for o, t in zip(out, c)),
                                  [xg] + mats + biases)
        for a, b in zip([dx] + dW + db, ref):
            np.testing.assert_allclose(N(a), N(b), rtol=1e-4,
                                       atol=1e-6 * max(1.0, float(b.abs().max())))


def sdf_value_feat_grad_autograd_reference(w, x):
    """K3's function written with autograd in the prepared layout: the
    value, the features, and the gradient by a create_graph backward."""
    xx = x.reshape(-1, 3)
    y = xx * w.scale
    pe = torch.nn.functional.pad(positional_encoding(y, w.multires), (0, K12.PE_W - w.d_embed))
    h, mi = pe, 0
    for l in range(w.n_layers):
        z = h @ w.mats[mi]
        mi += 1
        if l == w.skip:
            z = z + pe @ w.mats[mi]
            mi += 1
        z = z + w.biases[l]
        h = softplus100(z) if l < w.n_layers - 1 else z
    (grad,) = torch.autograd.grad(h[:, 0].sum(), xx, create_graph=True)
    shape = x.shape[:-1]
    return (h[:, 0].reshape(shape) / w.scale, h[:, 1:].reshape(shape + (w.d_out - 1,)),
            grad.reshape(shape + (3,)) / w.scale)
