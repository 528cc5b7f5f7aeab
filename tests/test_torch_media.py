"""The port's media readers and writers without OpenCV, on the CPU, against
OpenCV and PIL: progressive JPEG (iron_tpu_torch/data/jpeg.py), palette,
sub-8-bit and Adam7-interlaced PNG (data/io.py), and the MPEG-4 Part 2
(`mp4v`) interpolation video (data/video.py,
Stage1Trainer.interpolate_view_video) against the JAX trainer's frame
sequence and OpenCV's own mp4v video."""
import io
import os
import struct
import types
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

from iron_tpu.data import io as jio
from iron_tpu.train.stage1 import Stage1Trainer as JStage1Trainer

from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.jpeg import decode_jpeg
from iron_tpu_torch.data.video import write_mpeg4_video
from iron_tpu_torch.train.stage1 import Stage1Trainer


def _photo(g, H, W, C=3):
    """A smooth image with noise (a stand-in for a photograph)."""
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * xx + 1) * 0.5 + 0.5, np.cos(4 * yy) * 0.5 + 0.5, xx * yy], -1)
    img = (np.clip(base + 0.05 * g.normal(size=base.shape), 0, 1) * 255).astype(np.uint8)
    return img[..., :C]


def _cv2_rgb(img):
    """cv2's channel order to the port's (BGR -> RGB, BGRA -> RGBA)."""
    if img.ndim == 2:
        return img[..., None]
    return img[..., [2, 1, 0, 3][:img.shape[2]]]


# ---------------------------------------------------------------------------
# progressive JPEG
# ---------------------------------------------------------------------------

def _cv2_progressive(img, flags):
    ok, buf = cv2.imencode(".jpg", img if img.ndim == 2 else img[..., ::-1],
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1] + flags)
    return buf.tobytes()


def _pil_progressive(img, **kw):
    f = io.BytesIO()
    Image.fromarray(img).save(f, "JPEG", progressive=True, optimize=True, **kw)
    return f.getvalue()


CASES = {
    "cv2 4:2:0 q90": lambda im: _cv2_progressive(im, [cv2.IMWRITE_JPEG_QUALITY, 90]),
    "cv2 4:4:4 q75": lambda im: _cv2_progressive(im, [
        cv2.IMWRITE_JPEG_QUALITY, 75, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "cv2 restart 2": lambda im: _cv2_progressive(im, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    "cv2 gray": lambda im: _cv2_progressive(im[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 95]),
    "PIL 4:2:0 q85": lambda im: _pil_progressive(im, quality=85, subsampling=2),
    "PIL 4:4:4 q95": lambda im: _pil_progressive(im, quality=95, subsampling=0),
    "PIL 4:2:2 q50": lambda im: _pil_progressive(im, quality=50, subsampling=1),
    "PIL gray": lambda im: _pil_progressive(im[..., 0], quality=90),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_progressive_jpeg_reads_as_opencv(case, tmp_path):
    """Progressive JPEG (SOF2: spectral selection, successive approximation,
    end-of-band runs; restart intervals) from cv2.imwrite
    (IMWRITE_JPEG_PROGRESSIVE) and PIL (progressive, optimize), colour at
    4:2:0, 4:2:2 and 4:4:4 and gray, odd sizes: the port's reader within a
    mean of 1/255 of cv2.imread (largest difference 3), and read_image as the
    JAX package's."""
    img = _photo(np.random.default_rng(7), 45, 61)
    data = CASES[case](img)
    assert data[2:].find(b"\xff\xc2") >= 0                          # SOF2
    if "restart" in case:
        assert sum(data.count(bytes([0xFF, 0xD0 + i])) for i in range(8)) > 10
    path = str(tmp_path / "p.jpg")
    with open(path, "wb") as f:
        f.write(data)
    ref = _cv2_rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED))
    got = decode_jpeg(data)
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int64) - ref)
    assert diff.mean() <= 1.0 and diff.max() <= 3
    np.testing.assert_allclose(tio.read_image(path), jio.read_image(path), atol=3.0 / 255)


def test_unsupported_jpeg_variants_still_raise():
    """The frames the reader does not decode raise, naming the variant:
    hierarchical and arithmetic-coded lossless frames and 12-bit samples
    (arithmetic-coded and lossless files are read now:
    tests/test_torch_image_formats.py)."""
    base = _cv2_progressive(_photo(np.random.default_rng(8), 16, 16),
                            [cv2.IMWRITE_JPEG_QUALITY, 90])
    for marker, what in ((b"\xff\xc5", "hierarchical"), (b"\xff\xcb", "arithmetic-coded lossless")):
        with pytest.raises(ValueError, match=what):
            decode_jpeg(base.replace(b"\xff\xc2", marker, 1))
    i = base.index(b"\xff\xc2")
    twelve = base[:i + 4] + b"\x0c" + base[i + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        decode_jpeg(twelve)


# ---------------------------------------------------------------------------
# PNG: palette, sub-8-bit, Adam7
# ---------------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """Rows of samples [h, n] at `depth` bits -> the scanlines' bytes."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(samples.shape[0], -1), axis=1)


def _png(img: np.ndarray, color: int, depth: int, interlace: bool,
         palette: np.ndarray = None, trns: bytes = None) -> bytes:
    """A PNG of samples img [H, W, C] (palette indices for colour type 3),
    every scanline with filter 1 (sub), Adam7-interlaced or not."""
    H, W, C = img.shape
    bpp = max(1, C * depth // 8)
    raw = []
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        lines = _pack(sub.reshape(sub.shape[0], -1), depth).astype(np.int64)
        filt = lines.copy()
        filt[:, bpp:] = (lines[:, bpp:] - lines[:, :-bpp]) % 256
        raw.append(np.concatenate([np.ones((len(lines), 1), np.int64), filt], 1)
                   .astype(np.uint8).tobytes())
    chunk = lambda t, b: struct.pack(">I", len(b)) + t + b + struct.pack(
        ">I", zlib.crc32(t + b) & 0xFFFFFFFF)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0,
                                                            0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(b"".join(raw))) + chunk(b"IEND", b"")


def _check_png(path, C_cv2=None):
    """read_png equal to cv2.imread(IMREAD_UNCHANGED), and read_image to the
    JAX package's read_image."""
    ref = _cv2_rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED))
    got = tio.read_png(path)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tio.read_image(path), jio.read_image(path))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_png_from_pil_reads_as_opencv(bits, tmp_path):
    """PIL's palette PNGs at 1, 2, 4 and 8 bits (and one with a tRNS chunk,
    which cv2 expands to RGBA and read_image drops) read as cv2.imread
    reads them."""
    img = _photo(np.random.default_rng(bits), 13, 19)
    path = str(tmp_path / "p.png")
    Image.fromarray(img).quantize(2 ** bits).save(path, bits=bits)
    with open(path, "rb") as f:
        assert f.read()[24:26] == bytes([bits, 3])                 # depth, colour type 3
    _check_png(path)
    Image.fromarray(img).quantize(2 ** bits).save(path, bits=bits, transparency=1)
    assert tio.read_png(path).shape == (13, 19, 4)
    _check_png(path)


def test_one_bit_gray_png_from_pil_reads_as_opencv(tmp_path):
    """PIL's 1-bit gray PNG: cv2 scales it to 0 / 255, as does the port."""
    g = np.random.default_rng(3)
    path = str(tmp_path / "g1.png")
    Image.fromarray(g.uniform(size=(9, 21)) > 0.5).save(path)
    with open(path, "rb") as f:
        assert f.read()[24:26] == bytes([1, 0])
    _check_png(path)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("color,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8),
                                         (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (6, 8),
                                         (6, 16)])
def test_png_depths_and_adam7_read_as_opencv(color, depth, interlace, tmp_path):
    """A small writer's PNGs, every colour type the JAX package's reader is
    given (gray, RGB, palette, RGBA) at each of its depths, plain and
    Adam7-interlaced, at a size (11 x 13) where some passes are narrow:
    read equal to cv2.imread."""
    g = np.random.default_rng(depth * 10 + color)
    C = {0: 1, 2: 3, 3: 1, 6: 4}[color]
    top = 2 ** depth
    palette = None
    if color == 3:
        palette = g.integers(0, 256, size=(top, 3))
    img = g.integers(0, top, size=(11, 13, C))
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(_png(img, color, depth, interlace, palette))
    _check_png(path)


# ---------------------------------------------------------------------------
# the interpolation video
# ---------------------------------------------------------------------------

def _fake_trainer(gain: float, H=24, W=32):
    """Stands in for a trainer: render_novel_view returns a smooth image
    that moves with the ratio, 0.5 + gain x [-1, 1] (a gain above 0.5 puts
    values outside [0, 1], which both packages clip)."""
    def render_novel_view(idx_0, idx_1, ratio, resolution_level=4, chunk=1024):
        yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
        img = np.stack([np.sin(5 * xx + 3 * ratio), np.cos(4 * yy - ratio),
                        2 * xx * yy - 1 + ratio], -1) * gain + 0.5
        return img.astype(np.float32)
    return types.SimpleNamespace(render_novel_view=render_novel_view)


def test_video_frames_are_the_jax_trainers(monkeypatch, tmp_path):
    """interpolate_view_video's frames, from the same renders, equal the
    JAX trainer's (its ratios, np.clip, the uint8 cast, the reversed
    half) bit for bit: cv2.VideoWriter and the port's writer both stood in
    for by recorders."""
    n = 7
    jax_frames, port_frames = [], []

    class Recorder:
        def __init__(self, path, fourcc, fps, size):
            assert size == (32, 24) and fps == 30

        def write(self, frame):
            jax_frames.append(frame[:, :, ::-1].copy())

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    JStage1Trainer.interpolate_view_video(_fake_trainer(0.7), 0, 1, str(tmp_path / "j.mp4"),
                                          n_frames=n)
    import iron_tpu_torch.train.stage1 as S1
    monkeypatch.setattr(S1, "write_mpeg4_video",
                        lambda path, frames, fps: port_frames.extend(frames))
    Stage1Trainer.interpolate_view_video(_fake_trainer(0.7), 0, 1, str(tmp_path / "t.avi"),
                                         n_frames=n)
    assert len(jax_frames) == len(port_frames) == 2 * n
    for a, b in zip(jax_frames, port_frames):
        assert b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def _capture(path, rgb=True):
    """cv2.VideoCapture's frames (RGB float, or FFmpeg's Y plane where rgb
    is False) and what it reports of the stream."""
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    if not rgb:
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    props = {"count": cap.get(cv2.CAP_PROP_FRAME_COUNT), "fps": cap.get(cv2.CAP_PROP_FPS),
             "fourcc": int(cap.get(cv2.CAP_PROP_FOURCC)),
             "size": (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT))}
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append((f[:, :, ::-1] if rgb else f).astype(np.float64))
    cap.release()
    return props, out


@pytest.mark.parametrize("ext", [".avi", ".mp4", ".mov"])
def test_video_decodes_in_opencv(ext, monkeypatch, tmp_path):
    """The written video (AVI with an mp4v stream, ISO base media with an
    mp4v sample entry) of smooth 40 x 56 frames opened by cv2.VideoCapture
    (FFmpeg): the frame count, size, fps and fourcc it reports for OpenCV's
    own mp4v file of the same frames and extension; every decoded frame
    within OpenCV's file's mean difference from its source frame plus
    0.5/255; FFmpeg's luma within a mean of 0.05 and at most 2 of the
    encoder's own reconstruction (the IDCTs round apart); the container's
    structure; another extension raises."""
    fake = _fake_trainer(0.3, H=40, W=56)
    recs = []                           # the encoder's reconstructions, kept by a wrapper
    import iron_tpu_torch.train.stage1 as S1
    monkeypatch.setattr(S1, "write_mpeg4_video",
                        lambda p, frames, fps: recs.extend(write_mpeg4_video(p, frames, fps)))
    path = str(tmp_path / ("v" + ext))
    Stage1Trainer.interpolate_view_video(fake, 0, 1, path, n_frames=5)
    frames = []
    for i in range(5):
        ratio = np.sin(((i / 5) - 0.5) * np.pi) * 0.5 + 0.5
        frames.append((np.clip(fake.render_novel_view(0, 1, ratio), 0, 1) * 255)
                      .astype(np.uint8))
    frames = frames + frames[::-1]
    ref_path = str(tmp_path / ("cv" + ext))
    writer = cv2.VideoWriter(ref_path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (56, 40))
    for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))
    writer.release()
    props, got = _capture(path)
    ref_props, ref = _capture(ref_path)
    assert props == ref_props and props["count"] == len(got) == len(ref) == len(frames) == 10
    assert props["fourcc"].to_bytes(4, "little") == b"FMP4" and props["fps"] == 30
    for a, b, f in zip(got, ref, frames):
        assert a.shape == b.shape == f.shape
        assert np.abs(a - f).mean() <= np.abs(b - f).mean() + 0.5
    _, lumas = _capture(path, rgb=False)
    assert len(lumas) == len(recs) == 10
    for y, (rgb, planes) in zip(lumas, recs):
        assert rgb.shape == (40, 56, 3) and rgb.dtype == np.uint8
        d = np.abs(y - planes[0][:40, :56])
        assert d.mean() <= 0.05 and d.max() <= 2
    with open(path, "rb") as f:
        data = f.read()
    if ext == ".avi":
        assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
        assert data[data.index(b"strh") + 12:][:4] == b"mp4v"
        assert data.count(b"00dc") == 20                   # 10 chunks, 10 index entries
    else:
        assert data[4:12] == (b"ftypqt  " if ext == ".mov" else b"ftypisom")
        assert b"mp4v" in data and b"esds" in data
    assert data.count(b"\x00\x00\x01\xb6") == 10          # one I-VOP a frame
    with pytest.raises(ValueError, match=r"\.avi"):
        write_mpeg4_video(str(tmp_path / "v.mkv"), frames)
    assert not os.path.exists(tmp_path / "v.mkv")
