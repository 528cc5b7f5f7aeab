"""The port's image writers (iron_tpu_torch/data/io.py::write_image, jpeg.py,
formats.py, tiff.py, webp_enc.py) and its `preprocess` commands against the
JAX package's, which write through cv2.imwrite and read through cv2.imread.

  * JPEG: the port's bytes are cv2.imencode's (libjpeg-turbo's compressor at
    OpenCV's defaults) at every size and quality tried.
  * write_image of gray, RGB and RGBA arrays, uint8 or float, to every
    extension it takes: OpenCV's bytes where the format is deterministic
    (.jpg, .bmp, .pam, .ras / .sr, .pfm, .hdr / .pic, PNM), cv2.imread's
    array where OpenCV's PNG and TIFF encoders choose their own compression
    (.png, .tif); lossless WebP and GIF are the port's own encoders, held to
    what they must decode to; and where OpenCV writes nothing or a file it
    cannot read, the port raises and leaves no file.  An RGBA array goes in
    the JAX package's channel order: all four reversed for OpenCV, so the
    file holds (G, B, A, R).
  * preprocess make-masks / apply-alpha on files named .png whose content
    is another format or not RGBA: the same folders as the JAX package's.
"""
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

from iron_tpu.cli import preprocess as j_preprocess
from iron_tpu.data import io as jio

from iron_tpu_torch.cli import preprocess as t_preprocess
from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.formats import read_gif, write_gif, write_hdr, write_sunras
from iron_tpu_torch.data.jpeg import encode_jpeg
from iron_tpu_torch.data.webp import decode_webp
from iron_tpu_torch.data.webp_enc import _canonical_codes, _huffman_lengths, encode_webp_lossless

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_writer_fixtures as F  # noqa: E402


def _photo(seed: int, H: int, W: int, C: int = 3) -> np.ndarray:
    """A smooth image with noise (a stand-in for a photograph)."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * xx + 1) * 0.5 + 0.5, np.cos(4 * yy) * 0.5 + 0.5, xx * yy,
                     0.6 + 0.4 * np.sin(5 * xx * yy)][:C], -1)
    return (np.clip(base + 0.05 * g.normal(size=base.shape), 0, 1) * 255).astype(np.uint8)


def _render_like(res: int = 512) -> np.ndarray:
    """A shaded sphere with a specular highlight on black, float RGB [0, 1]
    (what the stage-2 validation renders look like)."""
    yy, xx = (np.mgrid[0:res, 0:res] + 0.5) / res * 2 - 1
    r2 = xx ** 2 + yy ** 2
    hit = r2 < 0.6
    z = np.sqrt(np.clip(0.6 - r2, 0, None)) / np.sqrt(0.6)
    n = np.stack([xx / np.sqrt(0.6), -yy / np.sqrt(0.6), z], -1)
    light = np.array([0.4, 0.5, 0.77])
    diffuse = np.clip(n @ light, 0, 1)
    spec = np.clip(n @ np.array([0.2, 0.3, 0.93]), 0, 1) ** 40
    albedo = np.stack([0.8 + 0.2 * xx, 0.5 + 0.3 * yy, 0.3 + 0.2 * z], -1)
    img = albedo * diffuse[..., None] + spec[..., None]
    return np.where(hit[..., None], np.clip(img, 0, 1), 0).astype(np.float32)


def _bgr(img: np.ndarray) -> np.ndarray:
    return img if img.ndim == 2 else np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])


def _cv2(ext: str, img: np.ndarray, *flags) -> bytes:
    ok, buf = cv2.imencode(ext, img, *flags)
    assert ok
    return buf.tobytes()


def _imread(path: str):
    """cv2.imread(IMREAD_UNCHANGED) with the channels in RGB(A) order."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return None if img is None else _bgr(img)


def _decode(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return None if img is None else _bgr(img)


# ---------------------------------------------------------------------------
# JPEG: libjpeg's bytes
# ---------------------------------------------------------------------------

def _jpeg_equal(img: np.ndarray, quality: int = 95) -> bool:
    return encode_jpeg(img, quality) == _cv2(".jpg", _bgr(img), [cv2.IMWRITE_JPEG_QUALITY, quality])


@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
@pytest.mark.parametrize("width", [16, 13])
def test_jpeg_bytes_are_opencvs_at_every_height(width, gray):
    """Every height from 1 to 64 (odd and even, across the 8- and 16-row
    MCU edges where libjpeg pads chroma after downsampling and codes dummy
    blocks), noise so every coefficient counts."""
    g = np.random.default_rng(width + gray)
    bad = [h for h in range(1, 65)
           if not _jpeg_equal(g.integers(0, 256, (h, width) if gray else (h, width, 3),
                                         dtype=np.uint8))]
    assert not bad, bad


@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (100, 131), (511, 509), (512, 512)])
def test_jpeg_bytes_are_opencvs_at_sizes(shape, gray):
    img = _photo(sum(shape), *shape)
    assert _jpeg_equal(img[..., 0] if gray else img)


@pytest.mark.parametrize("quality", list(range(50, 101)))
def test_jpeg_bytes_are_opencvs_at_qualities(quality):
    img = _photo(quality, 37, 53)
    assert _jpeg_equal(img, quality) and _jpeg_equal(img[..., 1], quality)


# ---------------------------------------------------------------------------
# write_image against the JAX package's, every extension
# ---------------------------------------------------------------------------

def _inputs(kind: str) -> np.ndarray:
    img = _photo(7, 30, 40, 4)
    img[..., 3][:, :9] = 0                       # some alpha 0 (GIF's transparency)
    img[2, :, 0] = 0                             # and some R 0: the stored alpha of an RGBA
    return {"gray": img[..., 1], "rgb": img[..., :3], "rgba": img,
            "float_rgb": img[..., :3] / 255.0 + 0.001,
            "float_rgba": img / 255.0 + 0.001}[kind]


def _expected(img: np.ndarray) -> np.ndarray:
    """The uint8 array a lossless writer keeps from write_image's input:
    8 bits, an RGBA array's channels as the JAX package's reversal leaves
    them, gray as three channels (WebP)."""
    img = jio.to8b(img) if img.dtype != np.uint8 else img
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    return img[..., [1, 2, 3, 0]] if img.shape[2] == 4 else img


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "float_rgb", "float_rgba"])
@pytest.mark.parametrize("ext", F.EXTENSIONS)
def test_write_image_matches_the_jax_package(ext, kind, tmp_path):
    img = _inputs(kind)
    j, t = str(tmp_path / ("j" + ext)), str(tmp_path / ("t" + ext))
    jio.write_image(j, img)
    ref = _imread(j) if os.path.exists(j) else None
    if ref is None:
        # OpenCV wrote nothing, or a file it cannot read: the port refuses
        with pytest.raises(ValueError):
            tio.write_image(t, img)
        assert not os.path.exists(t)
        return
    tio.write_image(t, img)
    with open(t, "rb") as f:
        ours = f.read()
    with open(j, "rb") as f:
        theirs = f.read()
    got = _imread(t)
    if ext in F.BYTE_EQUAL:
        assert ours == theirs
        return
    if ext in (".png", ".tif", ".tiff"):
        assert got.shape == ref.shape and got.dtype == ref.dtype and np.array_equal(got, ref)
        return
    with open(t, "rb") as f:
        port = tio.decode_image(f.read(), t)
    assert port.shape == got.shape and np.array_equal(port, got)      # both decoders agree
    exp = _expected(img)
    if ext == ".webp":
        # lossless: the input exactly (three channels where alpha is 255
        # everywhere, as OpenCV's file says); OpenCV's own file equal to it
        # but where the stored alpha is 0 (libwebp replaces those colours)
        if exp.shape[2] == 4 and (exp[..., 3] == 255).all():
            exp = exp[..., :3]
        assert got.shape == exp.shape and np.array_equal(got, exp)
        keep = exp[..., 3] > 0 if exp.shape[2] == 4 else np.ones(exp.shape[:2], bool)
        assert ref.shape == got.shape and np.array_equal(ref[keep], got[keep])
        return
    # .gif: OpenCV reads its transparency as alpha 0 transparent (black),
    # the rest opaque; the image's own colours where it has few enough,
    # else no further from the input than OpenCV's own file
    if exp.shape[2] == 4:
        clear = exp[..., 3] == 0
        exp = exp.copy()
        exp[clear] = 0
        exp[~clear, 3] = 255
        if not clear.any():
            exp = exp[..., :3]
    assert got.shape == ref.shape == exp.shape
    err = np.abs(got.astype(np.float64) - exp).mean()
    if len(np.unique(exp[..., :3].reshape(-1, 3), axis=0)) <= 255:
        assert err == 0
    else:
        assert err <= np.abs(ref.astype(np.float64) - exp).mean()


def test_rgba_goes_in_the_jax_packages_channel_order(tmp_path):
    """The JAX package reverses all four channels of an RGBA array before
    cv2.imwrite, which takes them as BGRA: the PNG, BMP, TIFF and WebP files
    hold (G, B, A, R) and the JPEG (G, B, A), in both packages."""
    img = _photo(3, 8, 10, 4)
    img[..., 3] = 200
    gbar = img[..., [1, 2, 3, 0]]
    for ext in (".png", ".bmp", ".tif", ".webp", ".jpg"):
        p = str(tmp_path / ("a" + ext))
        tio.write_image(p, img)
        got = _imread(p)
        if ext == ".jpg":
            assert got.shape == (8, 10, 3)
            with open(p, "rb") as f:
                assert f.read() == encode_jpeg(gbar[..., :3])
            continue
        assert np.array_equal(got, gbar), ext
        jio.write_image(str(tmp_path / ("j" + ext)), img)
        # libwebp replaces the colour where the stored alpha (R) is 0
        keep = gbar[..., 3] > 0 if ext == ".webp" else np.ones(gbar.shape[:2], bool)
        assert np.array_equal(_imread(str(tmp_path / ("j" + ext)))[keep], gbar[keep]), ext


@pytest.mark.parametrize("name", ["a.avif", "a.xyz", "noextension"])
def test_write_image_names_the_extensions_it_does_not_write(name, tmp_path):
    path = str(tmp_path / name)
    what = {"a.avif": "AVIF, which OpenCV writes", "a.xyz": "'.xyz'", "noextension": "''"}[name]
    with pytest.raises(ValueError, match=what):
        tio.write_image(path, _inputs("rgb"))
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# the simple writers in depth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (3, 1), (1, 1, 3), (4, 9, 3)])
def test_sun_raster_pads_odd_rows_as_opencv(shape):
    """A row of odd length is padded with the byte after it in OpenCV's
    buffer: the next row's first; the last row's pad is past the image, so
    whatever OpenCV's memory holds (the port writes 0): every other byte
    is OpenCV's."""
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    ours, theirs = write_sunras(img), _cv2(".ras", _bgr(img))
    assert len(ours) == len(theirs) and ours[:-1] == theirs[:-1] and ours[-1] == 0


@pytest.mark.parametrize("width", [1, 2, 7, 8, 9, 127, 128, 129, 300])
def test_hdr_bytes_are_opencvs_flat_and_run_length(width):
    """Radiance: flat RGBE below 8 pixels a row, the new run-length form
    from 8; runs of every length from 1 to past 127 and literal stretches
    past 128, gray repeated to three channels."""
    g = np.random.default_rng(width)
    lens = g.integers(1, 140, 64)
    row = np.repeat(g.integers(0, 256, (64, 3)), lens, 0)[:width]
    row = np.concatenate([row, g.integers(0, 256, (max(0, width - len(row)), 3))])[:width]
    img = np.stack([row, row[::-1], g.integers(0, 256, (width, 3))]).astype(np.uint8)
    assert write_hdr(img) == _cv2(".hdr", _bgr(img))
    assert write_hdr(img[..., 0]) == _cv2(".hdr", img[..., 0])
    if width == 300:
        hdr = write_hdr(np.zeros((40, 300, 3), np.uint8))
        assert b"-Y 40 +X 300\n\x02\x02\x01\x2c" in hdr


# ---------------------------------------------------------------------------
# lossless WebP
# ---------------------------------------------------------------------------

WEBP_CASES = {
    "noise": lambda: np.random.default_rng(0).integers(0, 256, (20, 30, 3), dtype=np.uint8),
    "photo": lambda: _photo(1, 64, 80),
    "photo with alpha": lambda: _photo(2, 33, 47, 4),
    "gray": lambda: _photo(3, 9, 13)[..., 0],
    "1x1": lambda: np.array([[[7, 8, 9]]], np.uint8),
    "alpha 255 everywhere": lambda: np.dstack([_photo(4, 16, 16), np.full((16, 16), 255,
                                                                          np.uint8)]),
    "flat (runs past 4096)": lambda: np.zeros((100, 100, 3), np.uint8),
    "render": lambda: tio.to8b(_render_like(128)),
}


@pytest.mark.parametrize("case", sorted(WEBP_CASES))
def test_webp_lossless_reads_back_exactly(case):
    """The port's VP8L file decodes, in OpenCV and in the port, to the
    input (gray as three channels; three channels where alpha is 255
    everywhere), as OpenCV's own lossless file decodes in OpenCV."""
    img = WEBP_CASES[case]()
    data = encode_webp_lossless(img)
    exp = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img
    if exp.shape[2] == 4 and (exp[..., 3] == 255).all():
        exp = exp[..., :3]
    got, port = _decode(data), decode_webp(data)
    assert got.shape == port.shape == exp.shape
    assert np.array_equal(got, exp) and np.array_equal(port, exp)
    theirs = _decode(_cv2(".webp", _bgr(img)))
    assert np.array_equal(theirs, exp)


def test_webp_keeps_the_colour_under_alpha_0():
    """libwebp's lossless encoder (not `exact`, as OpenCV calls it)
    replaces the colour of pixels whose alpha is 0 by values of its own; the
    port keeps the input's, and the rest of the image equals OpenCV's."""
    img = _photo(5, 40, 40, 4)
    img[..., 3][10:30, 10:30] = 0
    got = _decode(encode_webp_lossless(img))
    theirs = _decode(_cv2(".webp", _bgr(img)))
    clear = img[..., 3] == 0
    assert np.array_equal(got, img)
    assert np.array_equal(theirs[~clear], img[~clear])
    assert not np.array_equal(theirs[clear], img[clear])


def test_webp_prefix_codes_are_complete_and_at_most_15_bits():
    """Huffman lengths of a Fibonacci histogram (a code of 30 bits
    unlimited) cut to 15 bits: still a complete code, the counts' order
    kept, and canonical codes that are a prefix code."""
    counts = np.zeros(280, np.int64)
    a, b = 1, 1
    for s in range(30):
        counts[s * 9] = a
        a, b = b, a + b
    lengths = _huffman_lengths(counts, 15)
    used = np.flatnonzero(counts)
    assert lengths[used].max() == 15 and (lengths[counts == 0] == 0).all()
    assert sum(2.0 ** -int(lengths[s]) for s in used) == 1.0
    order = used[np.argsort(-counts[used], kind="stable")]
    assert (np.diff(lengths[order]) >= 0).all()
    codes = _canonical_codes(lengths)
    words = {format(int(format(int(codes[s]), f"0{lengths[s]}b")[::-1], 2), f"0{lengths[s]}b")
             for s in used}
    assert not any(u != v and v.startswith(u) for u in words for v in words)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def _fixture_rgb() -> np.ndarray:
    return dict(np.load(os.path.join(REPO, "tests", "data_writers", "inputs.npz")))["rgb"]


GIF_CASES = {
    "photo fixture": _fixture_rgb,
    "photo fixture with alpha": lambda: np.dstack([_fixture_rgb(), np.where(
        np.arange(64)[None, :] < 20, 0, 255).repeat(48, 0).astype(np.uint8)]),
    "512^2 render": lambda: tio.to8b(_render_like(512)),
    "64 colours": lambda: np.random.default_rng(6).integers(0, 256, (64, 3), dtype=np.uint8)[
        np.random.default_rng(7).integers(0, 64, (30, 40))],
    "256 colours, noise (LZW table resets)": lambda: np.random.default_rng(8).integers(
        0, 256, (256, 3), dtype=np.uint8)[np.random.default_rng(9).integers(0, 256, (120, 160))],
}


@pytest.mark.parametrize("case", sorted(GIF_CASES))
def test_gif_decodes_alike_and_no_worse_than_opencvs(case):
    """OpenCV's GIF writer maps colours onto a fixed palette (lossy even at
    64 colours), so the port's is held to: OpenCV and the port's reader
    decode its file alike; an image of at most 256 colours comes back
    exactly; any other no further from the input on average than OpenCV's
    own file."""
    img = GIF_CASES[case]()
    data = write_gif(img)
    got, port = _decode(data), read_gif(data)
    assert got.shape == port.shape and np.array_equal(got, port)
    exp = img.copy()
    if exp.shape[2] == 4:
        clear = exp[..., 3] == 0
        exp[clear] = 0
        exp[~clear, 3] = 255
    theirs = _decode(_cv2(".gif", _bgr(img)))
    assert theirs.shape == got.shape == exp.shape
    colours = len(np.unique(img[..., :3].reshape(-1, 3), axis=0))
    err = np.abs(got.astype(np.float64) - exp).mean()
    if colours <= 255:
        assert err == 0
    else:
        assert err <= np.abs(theirs.astype(np.float64) - exp).mean()


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------

def _preprocess_both(tmp_path, files: dict):
    """Each package's make-masks then apply-alpha on its own copy of
    `files` (name -> bytes) -> the two roots."""
    roots = []
    for pkg, lib in (("j", j_preprocess), ("t", t_preprocess)):
        root = tmp_path / pkg
        os.makedirs(root / "image")
        for name, data in files.items():
            (root / "image" / name).write_bytes(data)
        lib.main(["make-masks", "--image_dir", str(root / "image")])
        lib.main(["apply-alpha", "--image_dir", str(root / "image")])
        roots.append(root)
    return roots


def test_preprocess_matches_the_jax_package(tmp_path):
    """tests/data_preprocess/'s gray + alpha, JPEG-in-.png, RGBA, RGBA16,
    palette + tRNS, gray and no-image files: both packages leave the same
    images (cv2.imread-equal) and masks, and skip the file of no image."""
    src = os.path.join(REPO, "tests", "data_preprocess", "image")
    files = {n: open(os.path.join(src, n), "rb").read() for n in sorted(os.listdir(src))}
    assert set(files) == {"gray.png", "gray_alpha.png", "jpeg_inside.png", "no_image.png",
                          "palette_trns.png", "rgba.png", "rgba16.png"}
    j, t = _preprocess_both(tmp_path, files)
    for sub in ("image", "masks"):
        names = sorted(os.listdir(j / sub))
        assert names == sorted(os.listdir(t / sub))
        for n in names:
            a, b = _imread(str(j / sub / n)), _imread(str(t / sub / n))
            if a is None:
                assert b is None and n == "no_image.png"
                continue
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), n
    assert "no_image.png" not in os.listdir(t / "masks")
    assert _imread(str(t / "image" / "gray_alpha.png")).shape == (24, 32, 3)


@pytest.mark.parametrize("command", ["make-masks", "apply-alpha"])
def test_preprocess_raises_naming_avif_content(command, tmp_path):
    """A .png holding AVIF, which OpenCV reads and the port does not:
    the JAX package processes it, the port raises naming AVIF rather than
    skip it unseen."""
    rgba = _photo(9, 16, 16, 4)
    data = _cv2(".avif", _bgr(rgba))
    os.makedirs(tmp_path / "j")
    (tmp_path / "j" / "a.png").write_bytes(data)
    j_preprocess.main([command, "--image_dir", str(tmp_path / "j")])
    os.makedirs(tmp_path / "t")
    (tmp_path / "t" / "a.png").write_bytes(data)
    with pytest.raises(ValueError, match="AVIF"):
        t_preprocess.main([command, "--image_dir", str(tmp_path / "t")])


def test_preprocess_skips_what_opencv_refuses(tmp_path):
    """Files that are an image format OpenCV refuses (a hierarchical JPEG,
    a byte-encoded Sun raster) are skipped by both packages, as cv2.imread
    gives None; the folder's other files are processed."""
    import image_format_writers as W
    rgba = _bgr(_photo(10, 12, 14, 4))
    jpg = _cv2(".jpg", np.ascontiguousarray(rgba[..., 1]))
    i = jpg.index(b"\xff\xc0")
    hier = jpg[:i] + b"\xff\xc5" + jpg[i + 2:]
    ras = W.encode_sunras(rgba[..., 0], 8, np.repeat(np.arange(256)[:, None], 3, 1).astype(
        np.uint8), kind=2)
    files = {"hier.png": hier, "ras.png": ras, "rgba.png": _cv2(".png", rgba)}
    j, t = _preprocess_both(tmp_path, files)
    assert sorted(os.listdir(t / "masks")) == sorted(os.listdir(j / "masks")) == ["rgba.png"]
    assert np.array_equal(_imread(str(j / "image" / "rgba.png")),
                          _imread(str(t / "image" / "rgba.png")))


# ---------------------------------------------------------------------------
# the committed fixtures and the card's machine
# ---------------------------------------------------------------------------

def _sha(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def test_writer_fixture_matches_its_manifest(tmp_path):
    """tests/data_writers/ (scripts/make_writer_fixtures.py), which
    chip_smoke.py's phase 8m holds on the card: every image through every
    extension gives the recorded bytes or decoded array, or is refused;
    the recorded hashes are still the JAX package's."""
    root = os.path.join(REPO, "tests", "data_writers")
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        want = json.load(f)
    inputs = dict(np.load(os.path.join(root, "inputs.npz")))
    assert inputs.keys() == F.writer_inputs().keys()
    assert all(np.array_equal(inputs[k], v) for k, v in F.writer_inputs().items())
    assert len(want) == len(inputs) * len(F.EXTENSIONS)
    for key, w in sorted(want.items()):
        name, ext = os.path.splitext(key)
        p = str(tmp_path / key)
        if "refused" in w:
            with pytest.raises(ValueError):
                tio.write_image(p, inputs[name])
            assert not os.path.exists(p)
            continue
        tio.write_image(p, inputs[name])
        data = open(p, "rb").read()
        if "bytes" in w:
            assert {"sha256": hashlib.sha256(data).hexdigest(), "size": len(data)} == w["bytes"]
            jio.write_image(str(tmp_path / ("j" + ext)), inputs[name])
            assert open(str(tmp_path / ("j" + ext)), "rb").read() == data
        else:
            assert _sha(tio.decode_image(data, p)) == w["decoded"] == _sha(_imread(p)), key


def test_preprocess_fixture_matches_its_manifest(tmp_path):
    """tests/data_preprocess/: the port's make-masks then apply-alpha on a
    copy leave the arrays recorded from the JAX package's commands."""
    root = os.path.join(REPO, "tests", "data_preprocess")
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        want = json.load(f)
    assert F.run_jax_preprocess(root) == want
    shutil.copytree(os.path.join(root, "image"), tmp_path / "image")
    t_preprocess.main(["make-masks", "--image_dir", str(tmp_path / "image")])
    t_preprocess.main(["apply-alpha", "--image_dir", str(tmp_path / "image")])
    left = sorted(f"{d}/{n}" for d in ("image", "masks") for n in os.listdir(tmp_path / d))
    assert left == sorted(want)
    for key, w in want.items():
        data = open(tmp_path / key, "rb").read()
        if w is None:
            with pytest.raises(tio.NoImage):
                tio.decode_image(data, key)
        else:
            assert _sha(tio.decode_image(data, key)) == w, key


def test_writers_run_without_opencv_pil_jax_or_the_jax_package(tmp_path):
    """The writers and preprocess import and run with cv2, PIL, jax and
    iron_tpu blocked: the card's machine has none of them."""
    code = ("import sys, os, shutil\n"
            "for m in ('cv2', 'PIL', 'jax', 'iron_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np\n"
            "from iron_tpu_torch.data import io, webp_enc, formats, jpeg, tiff\n"
            "from iron_tpu_torch.cli import preprocess\n"
            "img = np.load('tests/data_writers/inputs.npz')['rgba']\n"
            f"out = {str(tmp_path)!r}\n"
            "for ext in sorted(io._WRITERS):\n"
            "    if ext in ('.pbm', '.pgm'):\n"
            "        continue\n"
            "    p = os.path.join(out, 'a' + ext)\n"
            "    io.write_image(p, img[..., :3])\n"
            "    assert io.read_image(p).shape == (48, 64, 3), ext\n"
            "shutil.copytree('tests/data_preprocess/image', os.path.join(out, 'image'))\n"
            "preprocess.main(['make-masks', '--image_dir', os.path.join(out, 'image')])\n"
            "preprocess.main(['apply-alpha', '--image_dir', os.path.join(out, 'image')])\n"
            "assert len(os.listdir(os.path.join(out, 'masks'))) == 6\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_gif_lzw_round_trips_through_the_port_reader_at_every_code_size():
    """LZW at minimum code sizes 2 to 8 (palettes of 2 to 256 colours),
    across the 12-bit table's resets."""
    g = np.random.default_rng(11)
    for k in (2, 3, 5, 9, 17, 33, 65, 129, 200):
        pal = g.integers(0, 256, (k, 3), dtype=np.uint8)
        img = pal[g.integers(0, k, (70, 90))]
        data = write_gif(img)
        assert np.array_equal(read_gif(data), img) and np.array_equal(_decode(data), img), k
        (bits,) = struct.unpack("<B", data[10:11])
        assert 2 << (bits & 7) >= k
