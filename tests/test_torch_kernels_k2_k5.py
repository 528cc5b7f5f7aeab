"""K2 (the coarse SDF of the fallback sweep), K5 (the f32-class SDF sweep)
and K1's launch as their Hopper kernels take them, on the CPU: the layouts
the host hands K2's warpgroup products, K5's 3xTF32 route against the JAX
kernel, and the host-side rules of tiling and launch."""
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.fields.sdf import SDFConfig as JSDFConfig, init_sdf as j_init_sdf
from iron_tpu.kernels.fused_sdf import make_pallas_sdf_fn

from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy
from iron_tpu_torch.kernels import fused_sdf as K12
from iron_tpu_torch.kernels import fused_sdf_grad as K3
from test_torch_kernels import _SplitProducts, _round_tf32

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()


def _nets(seed=0, perturb=0.0):
    """The JAX geometric init at the full default SDFConfig, every v moved
    by `perturb` x N(0, 1), and the port's network on the same numbers."""
    jcfg = JSDFConfig()
    params = jax.tree_util.tree_map(np.asarray, j_init_sdf(jax.random.PRNGKey(seed), jcfg))
    g = np.random.default_rng(seed + 11)
    for layer in params["layers"]:
        layer["v"] = (layer["v"] + perturb * g.normal(size=layer["v"].shape)).astype(np.float32)
    return params, jcfg, sdf_from_numpy(params, SDFConfig(), "cpu")


def _wgmma_read(ktile: np.ndarray) -> np.ndarray:
    """The 16 x 256 B operand that wgmma reads from one 8 KB k-tile of
    K2's ring under its descriptor (csrc/sm90.cuh::wgmma_desc_k16_sw32):
    K-major, 8-column atoms of 256 bytes at a stride of 256 bytes (SBO), a
    column's 16 values in 32 bytes, then the 32-byte swizzle on the byte
    address: bit 4 ^= bit 7."""
    raw = ktile.view(np.uint8)
    k = np.arange(16)[:, None]
    n = np.arange(256)[None, :]
    addr = 256 * (n // 8) + 32 * (n % 8) + 16 * (k // 8) + 2 * (k % 8)
    addr = addr ^ (((addr >> 7) & 1) << 4)
    lo, hi = raw[addr].astype(np.uint16), raw[addr + 1].astype(np.uint16)
    return (lo | (hi << 8)).view(np.uint16)


_W2 = None


def _bf16_weights():
    global _W2
    if _W2 is None:
        _W2 = K12.prepare_bf16_weights(_nets(perturb=0.02)[2])
    return _W2


@pytest.mark.parametrize("mat", range(9))
def test_wgmma_pack_holds_each_matrix(mat):
    """K2's weight stream (Bf16Weights.wgpack): read as the wgmma
    descriptor reads it, every k-tile of every matrix of the stream (layer
    0, the hidden layers, the skip layer's hidden and PE matrices) gives
    back that matrix of the bf16 layout exactly, in the order of the
    layers; the stream holds nothing else."""
    w = _bf16_weights()
    mats = w.mats[:-1]
    assert len(mats) == 9   # 8 hidden layers, the skip's split in two
    stream = w.wgpack.view(torch.int16).numpy().view(np.uint16).reshape(-1, 4096)
    assert stream.shape[0] == sum(m.shape[0] // 16 for m in mats) == 118
    first = sum(m.shape[0] // 16 for m in mats[:mat])
    m = mats[mat].to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    got = np.concatenate([_wgmma_read(stream[first + kt]) for kt in range(m.shape[0] // 16)])
    np.testing.assert_array_equal(got, m)
    assert np.array_equal(mats[mat].numpy(), K12._bf16(mats[mat]).numpy())


def test_accumulator_is_the_next_layers_a_operand():
    """K2 keeps activations in registers: the f32 accumulator of a 64 x 256
    wgmma (n-tile j of 8 columns in d[4 j .. 4 j + 3]: rows g and g + 8 of
    the warp's 16, columns 8 j + 2 t, + 1) is repacked by the epilogue into
    the next layer's A fragments, k-tile kt from d[8 kt .. 8 kt + 7], in
    the m16n8k16 A order (rows g, g + 8; columns 16 kt + 2 t (+1), + 8).
    Read back through both layouts, every element lands where it was."""
    c = np.arange(64 * 256, dtype=np.float64).reshape(64, 256)
    back = np.full_like(c, -1.0)
    for thread in range(128):
        warp, lane = thread // 32, thread % 32
        g, t = lane // 4, lane % 4
        d = np.empty(128)
        for i in range(128):   # the accumulator layout
            j, e = i // 4, i % 4
            d[i] = c[16 * warp + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)]
        for kt in range(16):   # a[kt][r] = (d[8 kt + 2 r], d[8 kt + 2 r + 1])
            for r in range(4):
                row = 16 * warp + g + 8 * (r & 1)
                col = 16 * kt + 2 * t + 8 * (r >> 1)
                back[row, col], back[row, col + 1] = d[8 * kt + 2 * r], d[8 * kt + 2 * r + 1]
    np.testing.assert_array_equal(back, c)


@pytest.mark.parametrize("n,grid", [(1, 1), (64, 1), (129, 2), (131072, 132), (262144, 132)])
def test_k2_tiling(n, grid):
    """K2's work for n points on an H100 (132 SMs, one CTA an SM): 128 rows
    a CTA at a time (two warpgroups of 64), a persistent grid of every CTA
    the card holds but no more than the call has tiles; one CTA a cluster
    (the 2-CTA multicast variant measured slower and is not built)."""
    rows, got = K12.k2_tiling(n, 132)
    assert (rows, got) == (128, grid)
    tiles = -(-n // rows)
    assert got == min(132, tiles) and -(-tiles // got) * got * rows >= n


@pytest.fixture(scope="module")
def jax_sdf_reference():
    """The JAX package's make_pallas_sdf_fn (Pallas in interpret mode, tile
    128 so that 300 points span three tiles) at the full SDFConfig(), on
    perturbed init weights."""
    params, jcfg, _ = _nets(perturb=0.02)
    x = (np.random.default_rng(3).normal(size=(300, 3)) * 0.5).astype(np.float32)
    return x, np.asarray(make_pallas_sdf_fn(params, jcfg, tile=128, interpret=True)(jnp.asarray(x)))


def test_k5_split_products_against_jax_sdf_kernel(jax_sdf_reference):
    """K5's route: its forward sweep with every product as the kernel issues
    it, 3xTF32 on the tensor cores (hi hi + hi lo + lo hi of tf32 parts),
    against the JAX kernel it replaces: all 257 columns within atol 2e-5,
    rtol 1e-5, the JAX package's hold on its K5 (tests/test_kernels.py)."""
    x, ref = jax_sdf_reference
    w = K3.prepare_grad_weights(_nets(perturb=0.02)[2])
    with _SplitProducts(_round_tf32):
        got = K3.sdf_full_plain(w, T(x))
    assert got.shape == ref.shape == (300, 257)
    np.testing.assert_allclose(N(got), ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("n,held,grid", [(1, 132, 1), (96, 132, 1), (97, 132, 2),
                                         (12672, 132, 132), (262144, 132, 132),
                                         (262144, 66, 66)])
def test_k5_grid(n, held, grid):
    """K5's persistent grid: one CTA a tile of K5_ROWS (96) rows, every CTA
    the card holds at once (one an SM) but no more than the call has
    tiles.  The tile height does not depend on the call."""
    assert K3.K5_ROWS == 96
    assert K3.k5_grid(n, held) == grid


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on a card: takes a wrapper's CUDA
    branch up to its first call into the card."""

    @property
    def is_cuda(self):
        return True


def test_coarse_march_raises_without_cooperative_launch(monkeypatch):
    """K1's grid meets at a grid-wide barrier, so it is launched
    cooperatively.  On a card that cannot (cudaDevAttrCooperativeLaunch
    0, or an error reading it) the wrapper raises before any launch, and
    has no fallback; the answer is read once per device."""
    _, _, net = _nets()
    w = K12.prepare_bf16_weights(net)
    n = 8
    args = [torch.zeros((n, 3)), torch.ones((n, 3)), torch.zeros(n),
            torch.ones(n, dtype=torch.bool).as_subclass(_FakeCuda), torch.full((n,), 4.0)]
    queries = []
    for answer in (0, -1):
        monkeypatch.setattr(K12, "_COOPERATIVE", {})
        monkeypatch.setattr(K12, "_cooperative_launch",
                            lambda dev, a=answer: queries.append(dev) or a)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="cooperative"):
                K12.coarse_march(w, *args, 5, 2e-2)
    assert queries == [torch.device("cpu")] * 2
