"""K1 (the coarse march) and K3-fwd (value, feature and gradient) as their
Hopper kernels compute them, on the CPU: the arithmetic of each kernel's
products and schedule against the JAX package, and the host-side choices of
width and tiling that the wrappers hand the kernels."""
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.fields.sdf import SDFConfig as JSDFConfig, init_sdf as j_init_sdf

from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy
from iron_tpu_torch.kernels import fused_sdf as K12
from iron_tpu_torch.kernels import fused_sdf_grad as K3
from iron_tpu_torch.kernels import launch_counts, reset_launch_counts
from test_torch_kernels import _SplitProducts, _round_tf32

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()


def _nets(seed=0, perturb=0.0):
    """The JAX geometric init at the full default SDFConfig, every v moved
    by `perturb` x N(0, 1) (the init zeroes the PE rows), and the port's
    network on the same numbers."""
    jcfg = JSDFConfig()
    params = jax.tree_util.tree_map(np.asarray, j_init_sdf(jax.random.PRNGKey(seed), jcfg))
    g = np.random.default_rng(seed + 11)
    for layer in params["layers"]:
        layer["v"] = (layer["v"] + perturb * g.normal(size=layer["v"].shape)).astype(np.float32)
    return params, jcfg, sdf_from_numpy(params, SDFConfig(), "cpu")


@pytest.fixture(scope="module")
def jax_forward_reference():
    """The JAX package's fused forward kernel (Pallas in interpret mode, tile
    128 so that 200 points span two tiles) on perturbed init weights."""
    from iron_tpu.kernels.fused_sdf_grad import make_fused_sdf_grad_fn as j_make_fused
    params, jcfg, _ = _nets(perturb=0.02)
    x = (np.random.default_rng(1).normal(size=(200, 3)) * 0.4).astype(np.float32)
    out = j_make_fused(jcfg, tile=128, interpret=True)(params, jnp.asarray(x))
    return x, [np.asarray(o) for o in out]


@pytest.mark.parametrize("parts", ["tf32", "f32"])
def test_fwd_split_products_against_jax_forward_kernel(jax_forward_reference, parts):
    """K3-fwd's sweeps with every product as the kernel issues it, against
    the JAX forward kernel at its own test's rtol = atol = 1e-5
    (tests/test_kernels.py): with tf32 parts (3xTF32 on the tensor cores,
    hi hi + hi lo + lo hi, the route the kernel takes) and with plain f32
    products (the CUDA-core route it replaced)."""
    x, ref = jax_forward_reference
    _, _, net = _nets(perturb=0.02)
    w = K3.prepare_grad_weights(net)
    if parts == "tf32":
        with _SplitProducts(_round_tf32):
            got = K3.sdf_value_feat_grad_plain(w, T(x))
    else:
        got = K3.sdf_value_feat_grad_plain(w, T(x))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(N(a), b, rtol=1e-5, atol=1e-5)


def test_fwd_bf16_split_products_miss_the_jax_forward_kernel(jax_forward_reference):
    """With three bf16 passes a product (K4's arithmetic) the sweeps miss the
    JAX forward kernel's 1e-5 hold (the gradient by several times): why
    K3-fwd's products run 3xTF32."""
    from test_torch_kernels import _round_bf16
    x, ref = jax_forward_reference
    _, _, net = _nets(perturb=0.02)
    w = K3.prepare_grad_weights(net)
    with _SplitProducts(_round_bf16):
        got = K3.sdf_value_feat_grad_plain(w, T(x))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(N(got[2]), ref[2], rtol=1e-5, atol=1e-5)


def _march_rays(n, seed):
    """n rays from a ring of radius 2.5 at points near the init sphere, half
    of them grazing it, every fifth outside `work`."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro = (2.5 * d).astype(np.float32)
    rd = 0.45 * g.normal(size=(n, 3)) - ro
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    acc0 = g.uniform(0.4, 0.8, size=n).astype(np.float32)
    work = np.ones(n, bool)
    work[::5] = False
    max_dis = np.full(n, 4.5, np.float32)
    return ro, rd, acc0, work, max_dis


def test_coarse_march_plain_matches_jax_march_kernel():
    """K1's plain version against the JAX package's coarse march kernel
    (Pallas in interpret mode, tile 128, two tiles) on the same weights and
    rays.  The two sum the same bf16 products in other orders, so an
    activation can round one bf16 unit apart and the sdf moves by up to the
    reordering error (5e-3, chip_smoke.py's BF16_REORDER_TOL).  Held, as
    chip_smoke.py holds K1 against this plain version on the card: the
    active masks differ only on rays whose sdf lies within that error of the
    2e-2 threshold in both versions; distances and sdf agree within 1e-2
    except on rays with the same outcome at other distances (past max_dis,
    or still marching, in both) and on grazes, at most 2% of the marching
    rays: rays that stopped at |sdf| <= threshold in one version and marched
    on in the other, whose earlier stop has |sdf| within threshold + 5e-3
    under both arithmetics; the rays outside `work` keep acc0."""
    from iron_tpu.kernels.fused_sdf import make_pallas_coarse_march_fn
    params, jcfg, net = _nets()
    thr, tol = 2e-2, 5e-3
    ro, rd, acc0, work, max_dis = _march_rays(200, 4)
    march = make_pallas_coarse_march_fn(params, jcfg, threshold=thr, tile=128, interpret=True)
    w = K12.prepare_bf16_weights(net)
    for n_iters in (3, 40):
        ja, jacc, js = (np.asarray(o) for o in march(*map(jnp.asarray, (
            ro, rd, acc0, work, max_dis)), n_iters))
        a, acc, s = (N(o) for o in K12.coarse_march_plain(
            w, *map(T, (ro, rd, acc0, work, max_dis)), n_iters, thr))
        flip = a != ja
        assert flip.sum() <= 2
        assert np.all(np.abs(np.abs(s[flip]) - thr) <= tol)
        assert np.all(np.abs(np.abs(js[flip]) - thr) <= tol)
        apart = (np.abs(acc - jacc) > 1e-2) | (np.abs(s - js) > 1e-2)
        # the same outcome at other distances: past max_dis, or still
        # marching, in both
        same = ((acc >= max_dis) & (jacc >= max_dis)) | (a & ja)
        graze = apart & ~same
        assert graze.sum() <= 0.02 * work.sum()
        early = np.minimum(acc, jacc)[graze]
        assert np.all(early < max_dis[graze])
        p = ro[graze] + rd[graze] * early[:, None]
        s_port = np.abs(N(K12.sdf_only_bf16_plain(w, T(p))))
        s_jax = np.abs(np.asarray(_jax_sdf_bf16(params, jcfg, p)))
        assert np.all(s_port <= thr + tol) and np.all(s_jax <= thr + tol)
        assert np.array_equal(acc[~work], acc0[~work]) and not a[~work].any()


def _jax_sdf_bf16(params, jcfg, x):
    """The JAX coarse kernel's body (bf16 operands, f32 sums) outside
    Pallas: the sdf under the JAX march's arithmetic."""
    from iron_tpu.kernels.fused_sdf import _fused_sdf_panel_bf16, _prepare_bf16_weights
    mats, biases, skip = _prepare_bf16_weights(params, jcfg)
    return _fused_sdf_panel_bf16(jnp.asarray(x), mats, biases, jcfg, skip)[:, 0]


@pytest.mark.parametrize("n,n_iters", [(200, 40), (1000, 40), (333, 2), (65, 0)])
def test_compacted_schedule_is_bit_equal_to_coarse_march_plain(n, n_iters):
    """K1's schedule (the list of active rays, 64-ray tiles of it, one
    iteration after another) gives every ray the very numbers of the masked
    march of coarse_march_plain, bit for bit: a row's arithmetic does not
    depend on the rows that share its tile.  Its counts: every ray once,
    then each active ray once an iteration, and never more 64-ray
    tile-evaluations than one block a tile marching until its slowest ray
    stops."""
    _, _, net = _nets()
    w = K12.prepare_bf16_weights(net)
    args = [T(a) for a in _march_rays(n, n)]
    ref = K12.coarse_march_plain(w, *args, n_iters, 2e-2)
    *got, st = K12.coarse_march_schedule(w, *args, n_iters, 2e-2)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    per = st["per_iteration"]
    assert per[0] == (n, -(-n // 64))
    assert all(p[1] == -(-p[0] // 64) for p in per)
    assert st["iterations"] == len(per) - 1 <= n_iters
    assert st["evaluations"] == sum(p[0] for p in per)
    assert all(b[0] <= a[0] for a, b in zip(per, per[1:]))
    assert st["tile_evals"] <= st["tile_evals_blocks"]
    if n_iters == 40:   # the march ends with every ray stopped
        assert not got[0].any() and st["iterations"] < n_iters


@pytest.mark.parametrize("n,card,ctas", [(1, 264, 1), (64, 264, 1), (65, 264, 2),
                                         (2048, 264, 32), (16384, 264, 256),
                                         (262144, 264, 264), (262144, 132, 132)])
def test_k1_ctas(n, card, ctas):
    """K1's persistent grid: every CTA the card holds at once (two an SM of
    an H100: 264), at most one a 64-ray tile of the call."""
    assert K12.k1_ctas(n, card) == ctas


def test_coarse_march_cpu_launches_nothing():
    """A CPU tensor takes the plain version; no kernel launch is counted."""
    _, _, net = _nets()
    w = K12.prepare_bf16_weights(net)
    reset_launch_counts()
    K12.coarse_march(w, *[T(a) for a in _march_rays(10, 1)], 5, 2e-2)
    assert all(v == 0 for v in launch_counts().values())


@pytest.mark.parametrize("n,rows,width,clusters", [
    (262144, 64, 1, 132), (8448, 64, 1, 132), (4225, 64, 1, 67), (4224, 64, 2, 66),
    (4096, 64, 2, 64), (3168, 48, 2, 66), (2112, 32, 2, 66), (2048, 32, 2, 64),
    (1920, 64, 4, 30), (1024, 48, 4, 22), (480, 16, 4, 30), (1, 16, 4, 1)])
def test_fwd_tiling(n, rows, width, clusters):
    """K3-fwd's work for n points on a card that holds 30 clusters of 4, 66
    of 2 and 132 CTAs: the widest cluster (4, then 2 CTAs) whose clusters
    take the call in one round of tiles of at most 64 rows, with the
    shortest such tile (a multiple of 16 rows, at least 32 at width 2);
    else one CTA a 64-row tile on a persistent grid."""
    held = {1: 132, 2: 66, 4: 30}
    got = K3.fwd_tiling(n, held.get)
    assert got == (rows, width, clusters)
    assert clusters <= held[width]
    if width == 1:   # a persistent grid: every CTA the card holds, or one a tile
        assert clusters == min(held[1], -(-n // 64))
    else:            # one round: a tile a cluster, covering the points
        assert clusters == -(-n // rows) and clusters * rows >= n


def test_fwd_packs_hold_the_final_layer():
    """K3-fwd's final-layer pack: the final matrix, columns padded with zeros
    to a multiple of 8, packed as pack_tf32_b does (unpacked, the f32
    matrix comes back bit for bit); made with the other packs, once."""
    _, _, net = _nets(seed=2)
    w = K3.prepare_grad_weights(net)
    assert w._packs is None
    p = w.fwd_wlast
    out_pad = -(-w.d_out // 8) * 8
    ks, nt = 256 // 8, out_pad // 8
    u = p.reshape(ks, nt, 8, 4, 2).permute(0, 4, 3, 1, 2).reshape(8 * ks, 8 * nt)
    assert torch.equal(u[:, :w.d_out], w.mats[-1]) and not u[:, w.d_out:].any()
    assert w.fwd_wlast is p and w._packs[2] is p
