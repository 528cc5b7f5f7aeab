"""The port's plots (iron_tpu_torch/utils/visualize.py) without matplotlib:
the camera plot and the Fresnel plot drawn by the port's numpy rasteriser
and written through its PNG writer, held to the content of the JAX
package's matplotlib figures (iron_tpu/utils/visualize.py): the figure
sizes at dpi 120, a white ground, each split's frustum segments in its
tab10 colour along the projected frustum lines of the JAX package's
`frustum_lines`, the gray sphere wireframe, and each Fresnel curve within a
pixel of the port's Fresnel values (which equal the JAX package's)."""
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax.numpy as jnp

from iron_tpu.shading.brdf import CONDUCTOR_IOR_850NM as J_IOR
from iron_tpu.shading.fresnel import fresnel_conductor_exact as j_conductor
from iron_tpu.shading.fresnel import fresnel_dielectric as j_dielectric
from iron_tpu.utils import visualize as jvis
from iron_tpu_torch.data import io as tio
from iron_tpu_torch.utils import visualize as tvis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ring(n: int, radius: float, height: float, size=(64, 48)) -> dict:
    """n cameras on a ring looking at the origin."""
    cams = {}
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array([radius * np.cos(a), radius * np.sin(a), height])
        f = -eye / np.linalg.norm(eye)
        r = np.cross(f, [0, 0, 1.0])
        r /= np.linalg.norm(r)
        d = np.cross(f, r)
        W2C = np.eye(4)
        W2C[:3, :3] = np.stack([r, d, f])
        W2C[:3, 3] = -W2C[:3, :3] @ eye
        K = np.eye(4)
        K[0, 0] = K[1, 1] = 60.0
        K[:2, 2] = size[0] / 2, size[1] / 2
        cams[f"{i}.png"] = {"K": K.ravel().tolist(), "W2C": W2C.ravel().tolist(),
                            "img_size": size}
    return cams


CAMS = {"train": _ring(5, 2.5, 0.8), "test": _ring(3, 2.0, -0.6, (40, 40)),
        "val": _ring(2, 3.0, 1.5)}


@pytest.fixture(scope="module")
def plots(tmp_path_factory):
    d = tmp_path_factory.mktemp("plots")
    tvis.plot_cameras(CAMS, str(d / "cams.png"))
    tvis.plot_fresnel_terms(str(d / "fresnel.png"))
    out = {}
    for name in ("cams", "fresnel"):
        with open(d / f"{name}.png", "rb") as f:
            data = f.read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        out[name] = tio.decode_image(data)
    return out


@pytest.mark.parametrize("name, shape", [("cams", (960, 960, 3)), ("fresnel", (480, 1200, 3))])
def test_figure_size_and_white_ground(plots, name, shape):
    """matplotlib's pixel sizes at dpi 120 (8 x 8 and 10 x 4 inches), read
    back by the port's PNG decoder, on a white ground."""
    img = plots[name]
    assert img.shape == shape and img.dtype == np.uint8
    white = (img == 255).all(-1)
    assert white.mean() > 0.8 and white[0].all() and white[:, 0].all()


def _covering(colours, i: int):
    """The colour of item i and of every item drawn after it."""
    return {tuple(tvis.TAB10[c]) for c in colours[i:]}


def test_frustum_pixels_lie_on_the_projected_frustum_lines(plots):
    """Each camera's 8 segments (the JAX package's frustum_lines) through
    the plot's projection: within one pixel of every point along them lies
    a pixel of the split's tab10 colour, or of a camera drawn after it;
    each split's colour shows, in the JAX package's split order (red, blue,
    green)."""
    img = plots["cams"].astype(np.int64)
    segs = tvis.camera_segments(CAMS)
    grid = tvis._sphere_grid(1.0).reshape(-1, 3)
    project = tvis.camera_projection(np.concatenate([grid] + [s.reshape(-1, 3)
                                                             for _, s in segs]))
    colours = [c for c, _ in segs]
    assert colours == ["tab:red"] * 5 + ["tab:blue"] * 3 + ["tab:green"] * 2
    for i, (split, cams) in enumerate(CAMS.items()):
        for name, entry in cams.items():
            k = sum(len(c) for c in list(CAMS.values())[:i]) + list(cams).index(name)
            lines = jvis.frustum_lines(np.asarray(entry["K"]).reshape(4, 4),
                                       np.asarray(entry["W2C"]).reshape(4, 4),
                                       entry["img_size"])
            np.testing.assert_allclose(segs[k][1].reshape(-1, 3), lines, rtol=0, atol=1e-12)
            t = np.linspace(0, 1, 41)[:, None]
            cover = np.array(sorted(_covering(colours, k)))
            for s in range(0, 16, 2):
                px = np.rint(project(lines[s] + (lines[s + 1] - lines[s]) * t)).astype(int)
                near = np.stack([img[px[:, 1] + dy, px[:, 0] + dx] for dy in (-1, 0, 1)
                                 for dx in (-1, 0, 1)], 1)          # [41, 9, 3]
                hit = (near[:, :, None] == cover[None, None]).all(-1).any((1, 2))
                assert hit.all(), (split, name, s, np.flatnonzero(~hit))
    for c in ("tab:red", "tab:blue", "tab:green"):
        assert (img == tvis.TAB10[c]).all(-1).sum() > 50


def test_sphere_wireframe_is_gray_at_alpha_0_2(plots):
    """The unit sphere's wireframe (24 x 12 grid) is gray at alpha 0.2 over
    white where no frustum covers it."""
    img = plots["cams"].astype(np.int64)
    segs = tvis.camera_segments(CAMS)
    grid = tvis._sphere_grid(1.0)
    project = tvis.camera_projection(np.concatenate([grid.reshape(-1, 3)] +
                                                    [s.reshape(-1, 3) for _, s in segs]))
    px = np.rint(project(grid.reshape(-1, 3))).astype(int)
    vals = img[px[:, 1], px[:, 0]]
    blend = np.rint(0.2 * np.array(tvis.TAB10["tab:gray"]) + 0.8 * 255)
    on = (vals == blend).all(-1)
    frustum = np.isin(vals, [tvis.TAB10[c] for c in tvis.SPLIT_COLOURS]).all(-1)
    assert on.mean() > 0.9 and (on | frustum).all()


def test_fresnel_values_are_the_jax_packages():
    """The curves the plot draws: the port's Fresnel at the JAX package's
    256 cosines equals the JAX package's Fresnel."""
    diel, cond = tvis.fresnel_curves()
    cos = jnp.asarray(np.linspace(0.01, 1.0, 256))
    for (_, got), eta in zip(diel, (1.3, 1.5, 1.8)):
        np.testing.assert_allclose(got, np.asarray(j_dielectric(cos, eta)), rtol=0, atol=2e-6)
    for (_, got), (eta, k) in zip(cond, J_IOR.values()):
        np.testing.assert_allclose(got, np.asarray(j_conductor(cos, eta, k)), rtol=0, atol=2e-6)
    assert [c for c, _ in diel] == ["tab:blue", "tab:orange", "tab:green"]


@pytest.mark.parametrize("panel", [0, 1])
def test_fresnel_curve_pixels_within_a_pixel_of_the_values(plots, panel):
    """Each curve's 256 points mapped through the panel's autoscaled limits
    (the data range plus 5% margins): the pixel there, and every pixel
    within one of it, read back from the PNG, holds the curve's colour or
    that of a curve drawn after it; the panel's frame is black."""
    img = plots["fresnel"].astype(np.int64)
    curves = tvis.fresnel_curves()[panel]
    project = tvis.fresnel_projection(panel, [v for _, v in curves])
    colours = [c for c, _ in curves]
    for i, (col, values) in enumerate(curves):
        px = np.rint(project(tvis.FRESNEL_COS, values)).astype(int)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                got = {tuple(v) for v in img[px[:, 1] + dy, px[:, 0] + dx].tolist()}
                assert got <= _covering(colours, i), (col, dx, dy, got)
        ends = project(np.array([0.01 - 0.0495, 1.0 + 0.0495]), np.array([0.0, 0.0]))[:, 0]
        assert abs(px[0, 0] - ends[0]) > 1 and abs(px[-1, 0] - ends[1]) > 1
    W, H = 1200, 480
    x0, y0, x1, y1 = tvis.FRESNEL_PANELS[panel]
    assert (img[int(round((1 - y1) * H)), int(x0 * W) + 5:int(x1 * W) - 5] == 0).all()


def test_plots_run_without_matplotlib_opencv_pil_or_jax(tmp_path):
    """plot_cameras and plot_fresnel_terms in a subprocess with matplotlib,
    cv2, PIL, jax and iron_tpu blocked: the card's machine has none of
    them; the PNGs read back at their sizes."""
    code = ("import sys\n"
            "for m in ('matplotlib', 'cv2', 'PIL', 'jax', 'iron_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np\n"
            "from iron_tpu_torch.utils import visualize as v\n"
            "from iron_tpu_torch.data import io\n"
            "cams = {'train': {'0.png': {'K': np.eye(4).ravel().tolist(),\n"
            "                            'W2C': np.eye(4).ravel().tolist()}}}\n"
            f"v.plot_cameras(cams, {str(tmp_path / 'c.png')!r})\n"
            f"v.plot_fresnel_terms({str(tmp_path / 'f.png')!r})\n"
            f"assert io.read_image({str(tmp_path / 'c.png')!r}).shape == (960, 960, 3)\n"
            f"assert io.read_image({str(tmp_path / 'f.png')!r}).shape == (480, 1200, 3)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
