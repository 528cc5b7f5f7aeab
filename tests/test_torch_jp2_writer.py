"""The port's JPEG 2000 writer (iron_tpu_torch/data/jp2_enc.py, reached
through data/io.py::write_image) against cv2.imwrite, which writes .jp2
through OpenJPEG 2.5.3 at a 4:1 rate cut.

  * Bytes: equal to cv2.imencode(".jp2") on the fixture images of
    tests/data_jp2w/ (scripts/make_jp2w_fixtures.py): the "required" set,
    which OpenCV's file decodes exactly (ramps from 32 x 32 to odd sizes,
    12.png at 512^2, a mask), and the "cut" set, where the rate cut binds
    and the file is lossy (seeded noise, textured crops, the writers'
    64 x 48 images); and on seeded images of other sizes and channel
    counts.  The recorded hashes are OpenCV's of today.
  * cv2.imread and the port's own decode_jp2 read every file the writer
    makes to the same array.
  * write_image of gray, RGB and RGBA arrays (uint8 and float) gives the
    JAX package's file (its cv2.imwrite), the RGBA in its channel order.
  * An image with a side under 32 (OpenCV writes a 77-byte file it cannot
    read) and a two-channel image (OpenCV raises) raise and leave no file.
  * The forward 5/3 wavelet is inverted exactly by the decoder's _idwt53.
"""
import hashlib
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

from iron_tpu.data import io as jio

from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.jp2 import _idwt53, decode_jp2
from iron_tpu_torch.data.jp2_enc import _fdwt53, encode_jp2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data_jp2w")
with open(os.path.join(FIXTURE, "opencv_sha256.json")) as _f:
    RECORDED = json.load(_f)
INPUTS = dict(np.load(os.path.join(FIXTURE, "inputs.npz")))


def _to_opencv(img: np.ndarray) -> np.ndarray:
    """RGB(A) -> BGR(A) (the permutation is its own inverse); gray kept."""
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return np.ascontiguousarray(img)


def _opencv_jp2(img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".jp2", _to_opencv(img))
    assert ok
    return buf.tobytes()


def _decodes_alike(data: bytes, shape) -> np.ndarray:
    """cv2.imdecode and the port's decode_jp2 of the same bytes: equal arrays
    of the image's shape (RGB(A) order)."""
    ours = decode_jp2(data)
    theirs = _to_opencv(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))
    assert theirs.shape == ours.shape and np.array_equal(ours, theirs)
    return ours.reshape(shape)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def _record(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


@pytest.mark.parametrize("name", sorted(k for k, v in RECORDED.items() if v["set"] == "required"))
def test_required_set_is_opencvs_bytes_and_exact(name):
    """Where OpenCV's cut does not bind: the port's bytes are OpenCV's (its
    recorded hash and a fresh cv2.imencode), and the file decodes exactly,
    in cv2 and in the port's decoder."""
    img, want = INPUTS[name], RECORDED[name]
    data = encode_jp2(img)
    assert {"sha256": hashlib.sha256(data).hexdigest(), "size": len(data)} == want["bytes"]
    assert data == _opencv_jp2(img)
    back = _decodes_alike(data, img.shape)
    assert np.array_equal(back, img) and _record(back) == want["decoded"]


@pytest.mark.parametrize("name", sorted(k for k, v in RECORDED.items() if v["set"] == "cut"))
def test_cut_set_is_opencvs_bytes(name):
    """Where OpenCV's 4:1 cut binds: the same bytes all the same (the rate
    allocation is OpenJPEG's), so the file is no longer than OpenCV's and
    its PSNR is OpenCV's; cv2.imread and decode_jp2 read it alike."""
    img, want = INPUTS[name], RECORDED[name]
    data = encode_jp2(img)
    assert {"sha256": hashlib.sha256(data).hexdigest(), "size": len(data)} == want["bytes"]
    assert data == _opencv_jp2(img)
    back = _decodes_alike(data, img.shape)
    assert _record(back) == want["decoded"] and not np.array_equal(back, img)
    assert abs(_psnr(img, back) - want["psnr"]) < 1e-9
    assert len(data) <= img.size / 4 + 16          # the budget: a quarter of the raw bytes


def _seeded(seed: int, h: int, w: int, c: int, kind: str) -> np.ndarray:
    g = np.random.default_rng(seed)
    shape = (h, w) if c == 1 else (h, w, c)
    if kind == "noise":
        return g.integers(0, 256, shape, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.sin(7 * xx + 2 * yy)[..., None] * np.linspace(60, 100, c) + 128
    img = base + g.normal(0, 6 if kind == "photo" else 1, (h, w, c))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8).reshape(shape)


@pytest.mark.parametrize("seed,h,w,c,kind", [
    (1, 32, 32, 1, "noise"), (2, 32, 33, 3, "photo"), (3, 47, 32, 4, "photo"),
    (4, 40, 56, 3, "soft"), (5, 33, 65, 1, "soft"), (6, 64, 64, 3, "noise"),
    (7, 50, 35, 4, "noise"), (8, 81, 40, 3, "photo"), (9, 32, 100, 3, "soft"),
    (10, 45, 45, 4, "soft")])
def test_bytes_are_opencvs_at_sizes_and_channels(seed, h, w, c, kind):
    """Seeded images, cut or not, gray / RGB / RGBA, from 32 pixels a side:
    OpenCV's bytes, read back alike by cv2 and decode_jp2."""
    img = _seeded(seed, h, w, c, kind)
    data = encode_jp2(img)
    assert data == _opencv_jp2(img)
    _decodes_alike(data, img.shape)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "rgb_float", "rgba_float"])
def test_write_image_matches_the_jax_package(kind, tmp_path):
    """write_image(".jp2") against the JAX package's (cv2.imwrite of the
    reversed array): the same file, the RGBA one (G, B, A, R) as RGBA."""
    img = INPUTS["writers_gray" if kind == "gray" else "writers_" + kind.split("_")[0]]
    if kind.endswith("float"):
        img = img.astype(np.float32) / 255.0
    t, j = str(tmp_path / "t.jp2"), str(tmp_path / "j.jp2")
    tio.write_image(t, img)
    jio.write_image(j, img)
    with open(t, "rb") as f, open(j, "rb") as g:
        assert f.read() == g.read()
    with open(t, "rb") as f:
        _decodes_alike(f.read(), img.shape)
    assert tio.read_image(t).shape == img.shape[:2] + (3,)


@pytest.mark.parametrize("shape", [(31, 40, 3), (40, 31), (20, 20, 4), (1, 500, 3), (32, 16, 3)])
def test_too_small_for_five_levels_raises_and_leaves_no_file(shape, tmp_path):
    """A side under 32: OpenCV's imwrite returns False and leaves a 77-byte
    file it cannot read; the port raises and leaves none."""
    path = str(tmp_path / "a.jp2")
    img = np.full(shape, 90, np.uint8)
    jpath = str(tmp_path / "j.jp2")
    assert not cv2.imwrite(jpath, img)
    assert cv2.imread(jpath, cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError, match="too small"):
        tio.write_image(path, img)
    assert not os.path.exists(path)


def test_two_channels_raise_as_in_opencv(tmp_path):
    img = np.zeros((40, 40, 2), np.uint8)
    with pytest.raises(cv2.error):
        cv2.imencode(".jp2", img)
    path = str(tmp_path / "a.jp2")
    with pytest.raises(ValueError, match="1, 3 or 4 channels"):
        tio.write_image(path, img)
    assert not os.path.exists(path)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 33, 64, 65])
@pytest.mark.parametrize("cas", [0, 1])
def test_forward_53_inverts_exactly(n, cas):
    """_fdwt53 then the decoder's _idwt53 give the signal back, on both
    parities and odd lengths."""
    g = np.random.default_rng(n * 2 + cas)
    x = g.integers(-128, 128, (5, n)).astype(np.int64)
    sn = (n + 1 - cas) // 2
    y = _fdwt53(x, sn, cas)
    assert np.array_equal(_idwt53(y, sn, cas), x)


def test_writer_runs_without_opencv_pil_jax_or_the_jax_package():
    """With cv2, PIL, glymur, jax and iron_tpu blocked (the card's machine
    has none of them), write_image writes the recorded bytes of two
    fixture images and decode_jp2 reads them back."""
    code = f"""
import sys, json, hashlib, os, tempfile
for m in ('cv2', 'PIL', 'glymur', 'jax', 'iron_tpu'):
    sys.modules[m] = None
import numpy as np
from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.jp2 import decode_jp2
root = {FIXTURE!r}
rec = json.load(open(root + "/opencv_sha256.json"))
inputs = np.load(root + "/inputs.npz")
ok = {{}}
with tempfile.TemporaryDirectory() as tmp:
    for key in ("ramp_33x65", "noise_53x37"):
        path = os.path.join(tmp, key + ".jp2")
        tio.write_image(path, inputs[key])
        data = open(path, "rb").read()
        ok[key] = hashlib.sha256(data).hexdigest() == rec[key]["bytes"]["sha256"]
        ok[key + "_decoded"] = decode_jp2(data).shape == inputs[key].shape
ok["blocked"] = [m for m in ('cv2', 'PIL', 'glymur', 'jax', 'iron_tpu')
                 if sys.modules.get(m) is not None]
print(json.dumps(ok))
"""
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got.pop("blocked") == [] and len(got) == 4 and all(got.values()), got
