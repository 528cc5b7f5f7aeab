"""The PyTorch port's core (iron_tpu_torch.core) against the JAX package on
the CPU: the positional encoding, the ray-sphere intersection and every
camera function, from the same numpy inputs."""
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax.numpy as jnp

from iron_tpu.core import camera as jcam
from iron_tpu.core.embedder import pe_dim as j_pe_dim, positional_encoding as j_pe
from iron_tpu.core.rays import intersect_sphere as j_isect

import iron_tpu_torch
from iron_tpu_torch.core import camera as tcam
from iron_tpu_torch.core.embedder import pe_dim, positional_encoding
from iron_tpu_torch.core.rays import intersect_sphere

T = lambda a: torch.as_tensor(np.asarray(a))
N = lambda t: t.detach().cpu().numpy()


def _cam_mats(rng):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 50.0 + rng.uniform(), 48.0 + rng.uniform()
    K[0, 2], K[1, 2] = 20.0, 17.5
    a = rng.normal(size=3)
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    W2C = np.eye(4, dtype=np.float32)
    W2C[:3, :3] = R.astype(np.float32)
    W2C[:3, 3] = (0.1 * a + np.array([0, 0, 3.0])).astype(np.float32)
    return K, W2C


@pytest.mark.parametrize("multires", [0, 4, 6, 10])
def test_positional_encoding_matches_jax(multires, rng):
    # f32 sin/cos of the same angles (2^k x is exact): agreement to 1 ulp class
    x = rng.uniform(-1.5, 1.5, size=(5, 7, 3)).astype(np.float32)
    got = N(positional_encoding(T(x), multires))
    ref = np.asarray(j_pe(jnp.asarray(x), multires))
    assert pe_dim(multires) == j_pe_dim(multires) == got.shape[-1]
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_intersect_sphere_matches_jax(rng):
    o = rng.normal(size=(64, 3)).astype(np.float32) * 2.0
    d = rng.normal(size=(64, 3)).astype(np.float32)
    m, near, far = intersect_sphere(T(o), T(d), 1.0)
    jm, jn, jf = j_isect(jnp.asarray(o), jnp.asarray(d), 1.0)
    np.testing.assert_array_equal(N(m), np.asarray(jm))
    # f32 reductions in another order: a few ulps of values of order 1
    np.testing.assert_allclose(N(near), np.asarray(jn), atol=2e-6)
    np.testing.assert_allclose(N(far), np.asarray(jf), atol=2e-6)


def test_camera_functions_match_jax(rng):
    K, W2C = _cam_mats(rng)
    H, W = 35, 40
    c = tcam.make_camera(K, W2C, H, W, device="cpu")
    jc = jcam.make_camera(K, W2C, H, W)
    # f32 4x4 inverses by different LU codes agree to a few ulps
    for a, b in [(c.K_inv, jc.K_inv), (c.C2W, jc.C2W)]:
        np.testing.assert_allclose(N(a), np.asarray(b), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(N(tcam.camera_origin(c)), np.asarray(jcam.camera_origin(jc)),
                               atol=1e-6)
    uv = tcam.pixel_grid(H, W, device="cpu")
    np.testing.assert_array_equal(N(uv), np.asarray(jcam.pixel_grid(H, W)))

    ro, rd, rn = tcam.get_rays(c, uv)
    jro, jrd, jrn = jcam.get_rays(jc, jnp.asarray(N(uv)))
    np.testing.assert_allclose(N(ro), np.asarray(jro), atol=1e-6)
    np.testing.assert_allclose(N(rd), np.asarray(jrd), atol=2e-6)
    np.testing.assert_allclose(N(rn), np.asarray(jrn), rtol=2e-6)

    pts = rng.uniform(-0.8, 0.8, size=(100, 3)).astype(np.float32)
    # pixel coordinates of order 50: 1e-4 is about 20 ulps
    np.testing.assert_allclose(N(tcam.project(c, T(pts))),
                               np.asarray(jcam.project(jc, jnp.asarray(pts))), atol=1e-4)

    cc = tcam.crop_camera(c, 7, 5, 16, 12)
    jcc = jcam.crop_camera(jc, 7, 5, 16, 12)
    assert (cc.H, cc.W) == (jcc.H, jcc.W) == (12, 16)
    np.testing.assert_allclose(N(cc.K), np.asarray(jcc.K), atol=1e-6)
    np.testing.assert_allclose(N(cc.K_inv), np.asarray(jcc.K_inv), atol=1e-6, rtol=1e-5)

    rc = tcam.resize_camera(c, 0.5)
    jrc = jcam.resize_camera(jc, 0.5)
    assert (rc.H, rc.W) == (jrc.H, jrc.W)
    np.testing.assert_allclose(N(rc.K), np.asarray(jrc.K), atol=1e-5)


def test_cuda_entry_point_raises_without_a_card(monkeypatch):
    """device='cuda' (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iron_tpu_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcam.make_camera(np.eye(4), np.eye(4), 4, 4)
    assert iron_tpu_torch.resolve_device("cpu").type == "cpu"
