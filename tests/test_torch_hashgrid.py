"""The port's hash-grid fields against the JAX package on the CPU: the level
resolutions, the corner rows each point reads (the dense and the hashed
levels, the uint32 hash), the encoding and its gradients, the hash SDF's
value / features / gradient (and the eikonal term's second-order
gradient), the rendering head and the NeRF.  Weights are drawn from a numpy
seed in the JAX trees' shapes and carried across with the `*_from_numpy`
functions; the tables are drawn at U(-0.5, 0.5) (the init's 1e-4 would
hide errors)."""
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu.fields import hashgrid as J
from iron_tpu_torch.fields import hashgrid as H

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)

# 4 levels at 4, 8, 16, 32 cells a side in a 1,024-row table: the first two
# dense ((r + 1)^3 <= 1024), the last two hashed
SMALL = dict(n_levels=4, base_resolution=4, per_level_scale=2.0, log2_hashmap_size=10)


def _cfgs(**grid):
    return J.HashGridConfig(**grid), H.HashGridConfig(**grid)


def _random_tree(tree, seed):
    """A tree of tree's shapes drawn from a numpy seed: tables U(-0.5, 0.5),
    weights U(-1/sqrt(d_in), 1/sqrt(d_in)), biases U(-0.1, 0.1)."""
    g = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if name.endswith("['table']"):
            a = g.uniform(-0.5, 0.5, shape)
        elif name.endswith("['w']"):
            a = g.uniform(-1, 1, shape) / np.sqrt(shape[0])
        else:
            a = g.uniform(-0.1, 0.1, shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, to_np(tree))


def _points(n, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def test_level_resolutions_match_jax():
    for grid in (SMALL, {}, dict(base_resolution=16, per_level_scale=1.5, n_levels=20)):
        jc, tc = _cfgs(**grid)
        np.testing.assert_array_equal(tc.level_resolutions(), jc.level_resolutions())
        assert tc.out_dim == jc.out_dim


def _row_weights_jax(table, x, jc):
    """Per point and level, the trilinear weight on each table row, read off
    the JAX encoding's gradient with respect to the table: [n, L, T]."""
    L, F = jc.n_levels, jc.n_features_per_level
    f = lambda tab, xi: jnp.sum(J.hashgrid_encode({"table": tab}, xi[None], jc)[0]
                                .reshape(L, F)[:, 0])
    return np.asarray(jax.vmap(jax.grad(f), in_axes=(None, 0))(table, x))[..., 0]


def test_corner_rows_match_jax_dense_and_hashed():
    """Each point's 8 corner rows on each level (and their weights) are the
    rows the JAX encoding reads, on the dense levels and the hashed ones."""
    jc, tc = _cfgs(**SMALL)
    table = _random_tree(J.init_hashgrid(jax.random.PRNGKey(0), jc), 1)["table"]
    x = _points(48, 2)
    ref = _row_weights_jax(jnp.asarray(table), jnp.asarray(x), jc)
    idx, w = map(N, H.hashgrid_corners(T(x), tc))
    assert idx.shape == w.shape == (48, 4, 8) and idx.min() >= 0 and idx.max() < 1024
    got = np.zeros_like(ref)
    n, l = np.meshgrid(np.arange(48), np.arange(4), indexing="ij")
    np.add.at(got, (n[..., None], l[..., None], idx), w)
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_corner_rows_match_jax_at_the_default_grid():
    """At the default grid (16 levels, 2^19 rows, resolutions 16 to 2,048:
    the first levels dense, the rest through the uint32 hash, whose products
    wrap mod 2^32) on 512 points: the table rows each level reads, with
    their weights summed under a random cotangent, are those of the JAX
    encoding's table gradient, row for row."""
    jc, tc = _cfgs()
    res = jc.level_resolutions()
    assert any((r + 1) ** 3 <= 1 << 19 for r in res) and any((r + 1) ** 3 > 1 << 19 for r in res)
    x = _points(512, 3)
    cot = np.random.default_rng(4).uniform(0.5, 1.5, (512, 16)).astype(np.float32)
    table = jnp.zeros((16, 1 << 19, 2), jnp.float32)
    ref = np.asarray(jax.grad(lambda tab: jnp.sum(
        J.hashgrid_encode({"table": tab}, jnp.asarray(x), jc).reshape(512, 16, 2)[..., 0]
        * cot))(table))[..., 0]
    idx, w = map(N, H.hashgrid_corners(T(x), tc))
    got = np.zeros_like(ref)
    np.add.at(got, (np.arange(16)[None, :, None], idx), w * cot[..., None])
    assert idx.max() < 1 << 19
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grid", ["small", "default"])
def test_encoding_and_its_gradients_match_jax(grid):
    """The encoding within 1e-6; its gradients with respect to x and the
    table under a random cotangent within 1e-5 of their largest entry."""
    jc, tc = _cfgs(**(SMALL if grid == "small" else {}))
    tree = _random_tree(J.init_hashgrid(jax.random.PRNGKey(0), jc), 5)
    x = _points(256, 6)
    cot = np.random.default_rng(7).normal(size=(256, jc.out_dim)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p, xx: J.hashgrid_encode(p, xx, jc),
                       jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    g_tab, g_x = vjp(jnp.asarray(cot))
    grid_t = H.hashgrid_from_numpy(tree, "cpu")
    xt = T(x).requires_grad_(True)
    got = H.hashgrid_encode(grid_t, xt, tc)
    got.backward(T(cot))
    np.testing.assert_allclose(N(got), np.asarray(ref), rtol=0, atol=1e-6)
    for a, b in ((xt.grad, g_x), (grid_t.table.grad, g_tab["table"])):
        b = np.asarray(b)
        np.testing.assert_allclose(N(a), b, rtol=0, atol=1e-5 * float(np.abs(b).max()))


def _sdf_pair(seed=8):
    jc = J.HashSDFConfig(grid=J.HashGridConfig(**SMALL), d_hidden=32, d_feature=7)
    tc = H.HashSDFConfig(grid=H.HashGridConfig(**SMALL), d_hidden=32, d_feature=7)
    tree = _random_tree(J.init_hash_sdf(jax.random.PRNGKey(0), jc), seed)
    return jc, tc, tree, H.hash_sdf_from_numpy(tree, "cpu")


def test_hash_sdf_value_features_and_gradient_match_jax():
    """hash_sdf_apply / hash_sdf_only / hash_sdf_value_feat_grad within
    1e-5; the port's trees round-trip."""
    jc, tc, tree, net = _sdf_pair()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    x = _points(200, 9, -0.9, 0.9)
    v, f, g = J.hash_sdf_value_feat_grad(jp, jnp.asarray(x), jc)
    tv, tf, tg = H.hash_sdf_value_feat_grad(net, T(x), tc)
    for a, b in ((tv, v), (tf, f), (tg, g)):
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(N(H.hash_sdf_only(net, T(x), tc)),
                               np.asarray(J.hash_sdf_only(jp, jnp.asarray(x), jc)), atol=1e-5)
    np.testing.assert_allclose(N(H.hash_sdf_apply(net, T(x), tc)),
                               np.asarray(J.hash_sdf_apply(jp, jnp.asarray(x), jc)), atol=1e-5)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, H.hash_sdf_to_numpy(net), tree))


def test_eikonal_gradient_through_the_grid_matches_jax():
    """The eikonal term mean((|grad_x sdf| - 1)^2) differentiated with
    respect to every parameter (second order through the trilinear weights
    and the table gathers), against jax.grad of the JAX package's vjp: each
    leaf within 1e-4 of its largest entry."""
    jc, tc, tree, net = _sdf_pair(10)
    x = _points(128, 11, -0.9, 0.9)

    def j_eik(p):
        _, _, g = J.hash_sdf_value_feat_grad(p, jnp.asarray(x), jc)
        return jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    ref_val, ref = jax.value_and_grad(j_eik)(jax.tree_util.tree_map(jnp.asarray, tree))
    _, _, g = H.hash_sdf_value_feat_grad(net, T(x), tc)
    loss = torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref_val), rtol=1e-5)
    # a bias the gradient does not see (the last layer's) takes none, as
    # JAX gives it zeros
    G = lambda p: np.zeros(p.shape, np.float32) if p.grad is None else N(p.grad)
    got = {"grid": {"table": G(net.grid.table)},
           "layers": [{"w": G(l.w), "b": G(l.b)} for l in net.layers]}
    assert np.abs(got["grid"]["table"]).max() > 0
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(to_np(ref)),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * float(np.abs(a).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_hash_rendering_head_matches_jax():
    grid = dict(SMALL, log2_hashmap_size=8)
    jc = J.HashRenderingConfig(grid=J.HashGridConfig(**grid), d_feature=7, d_hidden=32)
    tc = H.HashRenderingConfig(grid=H.HashGridConfig(**grid), d_feature=7, d_hidden=32)
    tree = _random_tree(J.init_hash_rendering(jax.random.PRNGKey(1), jc), 12)
    g = np.random.default_rng(13)
    pts, nrm, dirs = (_points(160, s, -0.9, 0.9) for s in (14, 15, 16))
    feat = g.normal(size=(160, 7)).astype(np.float32)
    ref = J.hash_rendering_apply(jax.tree_util.tree_map(jnp.asarray, tree), jc,
                                 *map(jnp.asarray, (pts, nrm, dirs, feat)))
    got = H.hash_rendering_apply(H.hash_rendering_from_numpy(tree, "cpu"), tc,
                                 *map(T, (pts, nrm, dirs, feat)))
    np.testing.assert_allclose(N(got), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("pts_dim", [3, 4])
def test_hash_nerf_matches_jax(pts_dim):
    """Density and colour within 1e-5, on 3-d points and on the background's
    4-d (x/r, 1/r)."""
    jc = J.HashNeRFConfig(grid=J.HashGridConfig(**SMALL), d_hidden=32, d_color_hidden=32)
    tc = H.HashNeRFConfig(grid=H.HashGridConfig(**SMALL), d_hidden=32, d_color_hidden=32)
    tree = _random_tree(J.init_hash_nerf(jax.random.PRNGKey(2), jc), 17)
    x = _points(160, 18, -0.9, 0.9)
    pts = np.concatenate([x, np.full((160, 1), 0.5, np.float32)], -1) if pts_dim == 4 else x
    views = _points(160, 19)
    ref = J.hash_nerf_apply(jax.tree_util.tree_map(jnp.asarray, tree), jc, jnp.asarray(pts),
                            jnp.asarray(views))
    net = H.hash_nerf_from_numpy(tree, "cpu")
    got = H.hash_nerf_apply(net, tc, T(pts), T(views))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=0, atol=1e-5)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, H.hash_nerf_to_numpy(net), tree))


def test_inits_have_the_jax_shapes():
    """Each init gives the JAX init's tree of shapes; the tables lie in
    [-1e-4, 1e-4] and the biases are zero."""
    gen = torch.Generator().manual_seed(0)
    jc, tc = _cfgs(**SMALL)
    pairs = [
        (J.init_hash_sdf(jax.random.PRNGKey(0), J.HashSDFConfig(grid=jc)),
         H.hash_sdf_to_numpy(H.init_hash_sdf(H.HashSDFConfig(grid=tc), gen, "cpu"))),
        (J.init_hash_rendering(jax.random.PRNGKey(0), J.HashRenderingConfig(grid=jc)),
         H.hash_rendering_to_numpy(H.init_hash_rendering(H.HashRenderingConfig(grid=tc), gen,
                                                         "cpu"))),
        (J.init_hash_nerf(jax.random.PRNGKey(0), J.HashNeRFConfig(grid=jc)),
         H.hash_nerf_to_numpy(H.init_hash_nerf(H.HashNeRFConfig(grid=tc), gen, "cpu"))),
    ]
    for ref, got in pairs:
        shapes = lambda t: jax.tree_util.tree_map(np.shape, to_np(t))
        assert shapes(got) == shapes(ref)
        assert np.abs(got["grid"]["table"]).max() <= 1e-4
        for path, leaf in jax.tree_util.tree_leaves_with_path(got):
            if jax.tree_util.keystr(path).endswith("['b']"):
                assert not leaf.any()
