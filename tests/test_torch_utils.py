"""The port's utilities on the CPU: the profiling and numerical-debug
switches (utils/profiling.py: Timer, trace, debug_nans, checkify_fn) and
the visualisation (utils/visualize.py: frustum_lines against the JAX
package, the plots where matplotlib is installed)."""
import json
import os

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

from iron_tpu.utils import visualize as jvis
from iron_tpu_torch.utils import profiling as prof
from iron_tpu_torch.utils import visualize as tvis


def test_timer_sections_and_summary():
    t = prof.Timer()
    x = torch.ones(8)
    for _ in range(3):
        with t.section("a", sync=x):
            x = x * 2
    with t.section("b", sync={"out": [x]}):
        pass
    assert t.counts == {"a": 3, "b": 1}
    s = t.summary()
    assert set(s) == {"a", "b"} and all(v >= 0 for v in s.values())
    assert s["a"] == pytest.approx(t.totals["a"] / 3)


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path / "tb")) as p:
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    (name,) = os.listdir(tmp_path / "tb")
    path = str(tmp_path / "tb" / name)
    assert name.startswith("trace_") and os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert p.key_averages()


def test_debug_nans_raises_inside_and_not_outside():
    """A NaN made by a forward op, or by an op of the backward, raises
    FloatingPointError inside the block; the same code outside it runs."""
    x = torch.tensor([1.0, -1.0])
    assert torch.isnan(torch.sqrt(x)).any()
    with pytest.raises(FloatingPointError, match="nan generated by aten.sqrt"):
        with prof.debug_nans():
            torch.sqrt(x)
    z = torch.zeros(1, requires_grad=True)
    (torch.sqrt(z) * 0.0).sum().backward()          # 0 * inf in the backward
    assert torch.isnan(z.grad).all()
    z.grad = None
    with pytest.raises(FloatingPointError):
        with prof.debug_nans():
            (torch.sqrt(z) * 0.0).sum().backward()
    with prof.debug_nans():
        torch.sqrt(torch.tensor([4.0])).sum()
    with prof.debug_nans(enable=False):
        torch.sqrt(x)


def test_checkify_fn_names_the_failed_check():
    f = prof.checkify_fn(lambda t: torch.log(t) + 1)
    err, out = f(torch.tensor([1.0, 2.0]))
    assert err is None and torch.allclose(out, torch.log(torch.tensor([1.0, 2.0])) + 1)
    err, out = f(torch.tensor([-1.0]))
    assert err == "nan generated by aten.log.default" and torch.isnan(out).all()
    assert f(torch.tensor([0.0]))[0] == "inf generated by aten.log.default"
    g = prof.checkify_fn(lambda t, i: t[i] * 2)
    assert g(torch.arange(4.0), torch.tensor([1, 3]))[0] is None
    err, out = g(torch.arange(4.0), torch.tensor([1, 5]))
    assert err.startswith("index out of range in aten.index.Tensor") and out is None
    assert g(torch.arange(4.0), torch.tensor([-4, 3]))[0] is None
    assert g(torch.arange(4.0), torch.tensor([-5]))[0].startswith("index out of range")
    h = prof.checkify_fn(lambda t, i: torch.gather(t, 0, i))
    assert "aten.gather" in h(torch.arange(4.0), torch.tensor([-1]))[0]
    assert "aten.gather" in h(torch.arange(4.0), torch.tensor([4]))[0]
    assert h(torch.arange(4.0), torch.tensor([0, 3]))[0] is None


def test_frustum_lines_match_jax():
    g = np.random.default_rng(0)
    for _ in range(4):
        K = np.eye(4)
        K[0, 0], K[1, 1] = g.uniform(100, 400, 2)
        K[:2, 2] = g.uniform(100, 300, 2)
        W2C = np.eye(4)
        q, _ = np.linalg.qr(g.normal(size=(3, 3)))
        W2C[:3, :3], W2C[:3, 3] = q, g.normal(size=3)
        size = (int(g.integers(64, 600)), int(g.integers(64, 600)))
        got = tvis.frustum_lines(K, W2C, size, 0.4)
        assert got.shape == (16, 3)
        np.testing.assert_array_equal(got, jvis.frustum_lines(K, W2C, size, 0.4))


def test_plots_write_images(tmp_path):
    """Both plots write PNGs of matplotlib's sizes at dpi 120, with no
    matplotlib (the port draws them itself)."""
    from iron_tpu_torch.data.io import read_image
    cams = {"train": {f"{i}.png": {"K": np.eye(4).ravel().tolist(),
                                   "W2C": np.eye(4).ravel().tolist(), "img_size": (64, 48)}
                      for i in range(2)},
            "test": {"0.png": {"K": np.eye(4).ravel().tolist(),
                               "W2C": np.eye(4).ravel().tolist()}}}
    tvis.plot_cameras(cams, str(tmp_path / "cams.png"))
    tvis.plot_fresnel_terms(str(tmp_path / "fresnel.png"))
    for name, shape in (("cams.png", (960, 960, 3)), ("fresnel.png", (480, 1200, 3))):
        with open(tmp_path / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        assert read_image(str(tmp_path / name)).shape == shape
