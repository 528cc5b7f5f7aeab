"""The port's image readers and writers (iron_tpu_torch/data/io.py, jpeg.py,
tiff.py, formats.py) against the JAX package's, which read and write through
OpenCV: every format and variant the JAX package reads through
cv2.imread(IMREAD_UNCHANGED), written into a file by cv2 or PIL, or by a
writer in tests/image_format_writers.py where neither writes the variant.

The port's `read_image` and `iron_tpu.data.io.read_image` give the same
float32 arrays, bit for bit; the port's decoder before the float conversion
equals cv2.imread's array (channels in RGB order).  The format OpenCV reads
that the port does not (AVIF), and the files OpenCV refuses, raise; JPEG
2000, which this OpenCV also writes (.jp2), now decodes (held in depth by
tests/test_torch_jp2.py).  write_image writes what cv2.imwrite writes, or
raises."""
import io
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

import image_format_writers as W
from iron_tpu.data import io as jio
from iron_tpu.data.dataset import RayDataset as JRayDataset
from iron_tpu.data.dataset import load_image_folder as j_load_image_folder

from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.dataset import RayDataset, load_image_folder
from iron_tpu_torch.data.jpeg import ARITAB
from iron_tpu_torch.data.tiff import write_tiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _photo(seed: int, H: int = 29, W: int = 37) -> np.ndarray:
    """A smooth RGB image with noise (a stand-in for a photograph)."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * xx + 1) * 0.5 + 0.5, np.cos(4 * yy) * 0.5 + 0.5, xx * yy], -1)
    return (np.clip(base + 0.05 * g.normal(size=base.shape), 0, 1) * 255).astype(np.uint8)


IMG = _photo(0)
BGR = np.ascontiguousarray(IMG[..., ::-1])
CMYK = np.dstack([IMG, IMG[..., :1] // 2 + 60])
GRAY_PAL = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)


def _cv2(ext, img, *flags) -> bytes:
    ok, buf = cv2.imencode(ext, img, *flags)
    assert ok
    return buf.tobytes()


def _pil(img, fmt, mode=None, **kw) -> bytes:
    f = io.BytesIO()
    im = Image.fromarray(img) if mode is None else Image.fromarray(img, mode)
    im.save(f, fmt, **kw)
    return f.getvalue()


def _pil_image(im: Image.Image, fmt: str, **kw) -> bytes:
    f = io.BytesIO()
    im.save(f, fmt, **kw)
    return f.getvalue()


def _quantized(n: int):
    q = Image.fromarray(IMG).quantize(n)
    pal = np.array(q.getpalette()[:3 * n], np.uint8).reshape(n, 3)
    return np.array(q), pal


IDX16, PAL16 = _quantized(16)
IDX200, PAL200 = _quantized(200)
MASK = (IMG[..., 0] > 120).astype(np.uint8) * 255
FLOAT = (IMG.astype(np.float32) / 37.0) ** 2


def _assert_reads_as_jax(path: str) -> None:
    """The port's read_image equals the JAX package's bit for bit, and the
    port's decoder equals cv2.imread's array."""
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ref is not None, "OpenCV reads no image from the file"
    with open(path, "rb") as f:
        raw = tio.decode_image(f.read())
    if ref.ndim == 3:
        ref = np.ascontiguousarray(ref[..., [2, 1, 0, 3][:ref.shape[2]]])
    raw = np.ascontiguousarray(raw)
    assert raw.shape == ref.shape and raw.dtype == ref.dtype, (raw.shape, raw.dtype, ref.shape,
                                                                ref.dtype)
    assert np.array_equal(raw.view(np.uint8), ref.view(np.uint8))
    got, want = tio.read_image(path), jio.read_image(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _write(tmp_path, name: str, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

JPEG_CASES = {
    # the islow inverse DCT makes the existing readers bit-exact too
    "cv2 baseline 4:2:0": lambda: _cv2(".jpg", BGR, [cv2.IMWRITE_JPEG_QUALITY, 90]),
    "cv2 progressive 4:2:2": lambda: _cv2(".jpg", BGR, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "cv2 gray": lambda: _cv2(".jpg", IMG[..., 0]),
    "PIL CMYK (Adobe, inverted)": lambda: _pil(CMYK, "JPEG", "CMYK", quality=90),
    "PIL CMYK progressive": lambda: _pil(CMYK, "JPEG", "CMYK", quality=75, progressive=True),
    "libjpeg CMYK": lambda: W.libjpeg_encode(CMYK, "cmyk"),
    "libjpeg YCCK": lambda: W.libjpeg_encode(CMYK, "ycck"),
    "libjpeg Adobe RGB": lambda: W.libjpeg_encode(IMG, "rgb"),
    "libjpeg restart 3": lambda: W.libjpeg_encode(IMG, restart=3),
    "arithmetic sequential": lambda: W.libjpeg_encode(IMG, arith=True),
    "arithmetic sequential gray": lambda: W.libjpeg_encode(IMG[..., 0], "gray", arith=True),
    "arithmetic restart 2": lambda: W.libjpeg_encode(IMG, arith=True, restart=2, quality=60),
    "arithmetic progressive": lambda: W.libjpeg_encode(IMG, arith=True, progressive=True),
    "arithmetic progressive restart": lambda: W.libjpeg_encode(IMG, arith=True, progressive=True,
                                                               restart=3, quality=98),
    "arithmetic progressive gray": lambda: W.libjpeg_encode(IMG[..., 0], "gray", arith=True,
                                                            progressive=True),
    "arithmetic progressive YCCK": lambda: W.libjpeg_encode(CMYK, "ycck", arith=True,
                                                            progressive=True),
    "lossless gray predictor 7": lambda: W.encode_lossless_jpeg(IMG[..., 0], predictor=7),
    "lossless point transform 2, restarts": lambda: W.encode_lossless_jpeg(
        IMG, predictor=4, pt=2, restart_rows=5),
    "lossless one scan a component": lambda: W.encode_lossless_jpeg(
        IMG, predictor=6, interleaved=False, restart_rows=4),
    "lossless 6-bit": lambda: W.encode_lossless_jpeg(IMG >> 2, predictor=5, precision=6),
    "lossless CMYK": lambda: W.encode_lossless_jpeg(CMYK, predictor=3),
    "lossless RGB ids": lambda: W.encode_lossless_jpeg(IMG, predictor=2, ids=(82, 71, 66)),
    # subsampled components, which libjpeg-turbo upsamples by replication in
    # a lossless file
    "lossless 2x2 luma, one scan a component": lambda: W.encode_lossless_jpeg(
        IMG, predictor=4, interleaved=False, sampling=[(2, 2), (1, 1), (1, 1)]),
    "lossless 2x1 luma, interleaved": lambda: W.encode_lossless_jpeg(
        IMG, predictor=7, sampling=[(2, 1), (1, 1), (1, 1)], ids=(82, 71, 66)),
    "lossless 1x2, 2x2, 1x1, interleaved": lambda: W.encode_lossless_jpeg(
        IMG, predictor=1, sampling=[(2, 2), (1, 2), (1, 1)]),
    "lossless CMYK 2x2 and 1x1, interleaved": lambda: W.encode_lossless_jpeg(
        CMYK, predictor=5, sampling=[(2, 2), (1, 1), (1, 1), (2, 2)]),
}
JPEG_CASES.update({f"lossless predictor {p}": (lambda p=p: W.encode_lossless_jpeg(IMG, p))
                   for p in range(1, 8)})


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_variants_read_as_opencv(case, tmp_path):
    """4-component (Adobe CMYK and YCCK), lossless (SOF3: predictors 1-7,
    point transform, restarts, 1, 3 and 4 components, subsampled
    components), arithmetic-coded
    (SOF9, SOF10: restarts, the conditioning tables) and the Huffman files
    of before: bit-equal to cv2.imread, through read_image equal to the JAX
    package's."""
    data = JPEG_CASES[case]()
    frame = {"lossless": b"\xff\xc3", "arithmetic sequential": b"\xff\xc9",
             "arithmetic restart": b"\xff\xc9", "arithmetic progressive": b"\xff\xca"}
    for key, marker in frame.items():
        if case.startswith(key):
            assert marker in data
    _assert_reads_as_jax(_write(tmp_path, "a.jpg", data))


def test_qm_coder_table_is_libjpegs():
    """The port's QM-coder table (T.81 Table D.2 in libjpeg's packing) is the
    one the system's libjpeg exports."""
    assert ARITAB == W.libjpeg_aritab()


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

IMG16 = IMG.astype(np.uint16) * 257 + 3
RGBA = np.dstack([IMG, IMG[..., 1:2]])
TIFF_CASES = {
    "cv2 LZW RGB": lambda: _cv2(".tif", BGR),
    "cv2 LZW gray": lambda: _cv2(".tif", IMG[..., 0]),
    "cv2 LZW RGBA": lambda: _cv2(".tif", RGBA[..., [2, 1, 0, 3]]),
    "cv2 LZW 16-bit RGB": lambda: _cv2(".tif", IMG16[..., ::-1].copy()),
    "cv2 LZW 16-bit RGBA": lambda: _cv2(".tif", np.dstack([IMG16[..., ::-1], IMG16[..., :1]])),
    "cv2 LZW 16-bit gray": lambda: _cv2(".tif", IMG16[..., 0]),
    "cv2 none": lambda: _cv2(".tif", BGR, [cv2.IMWRITE_TIFF_COMPRESSION, 1]),
    "cv2 Deflate": lambda: _cv2(".tif", BGR, [cv2.IMWRITE_TIFF_COMPRESSION, 8]),
    "cv2 PackBits": lambda: _cv2(".tif", BGR, [cv2.IMWRITE_TIFF_COMPRESSION, 32773]),
    "cv2 strips of 4 rows": lambda: _cv2(".tif", BGR, [cv2.IMWRITE_TIFF_ROWSPERSTRIP, 4]),
    "PIL raw": lambda: _pil(IMG, "TIFF", compression="raw"),
    "PIL LZW": lambda: _pil(IMG, "TIFF", compression="tiff_lzw"),
    "PIL Deflate": lambda: _pil(IMG, "TIFF", compression="tiff_deflate"),
    "PIL Adobe Deflate": lambda: _pil(IMG, "TIFF", compression="tiff_adobe_deflate"),
    "PIL PackBits": lambda: _pil(IMG, "TIFF", compression="packbits"),
    "PIL RGBA unassociated alpha": lambda: _pil(RGBA, "TIFF"),
    "PIL gray LZW": lambda: _pil(IMG[..., 0], "TIFF", compression="tiff_lzw"),
    "PIL bilevel": lambda: _pil(IMG[..., 0] > 100, "TIFF"),
    "PIL 16-bit gray LZW": lambda: _pil_image(Image.fromarray(IMG16[..., 0]), "TIFF",
                                               compression="tiff_lzw"),
    "PIL palette": lambda: _pil_image(Image.fromarray(IMG).quantize(16), "TIFF"),
    "PIL gray + alpha": lambda: _pil(np.dstack([IMG[..., 0], IMG[..., 1]]), "TIFF"),
    "hand 16-bit tiles Deflate predictor": lambda: W.encode_tiff(IMG16, "deflate", True,
                                                                 tile=(16, 16)),
    "hand 16-bit big-endian LZW predictor": lambda: W.encode_tiff(IMG16, "lzw", True,
                                                                  big_endian=True),
    "hand 16-bit big-endian gray tiles": lambda: W.encode_tiff(IMG16[..., 0], "packbits",
                                                               tile=(16, 16), big_endian=True),
    "hand 16-bit RGBA unassociated": lambda: W.encode_tiff(np.dstack([IMG16, IMG16[..., :1]]),
                                                           "lzw", True, extra_samples=2),
    "hand 16-bit mask LZW predictor": lambda: W.encode_tiff(MASK.astype(np.uint16) * 257, "lzw",
                                                            True),
    "hand RGBA associated, planar tiles": lambda: W.encode_tiff(RGBA, "lzw", True, tile=(16, 16),
                                                                planar=True, extra_samples=1),
    "hand RGBA unassociated Deflate": lambda: W.encode_tiff(RGBA, "deflate", extra_samples=2),
    "hand RGBA without ExtraSamples": lambda: W.encode_tiff(RGBA, "none"),
    "hand min-is-white": lambda: W.encode_tiff(IMG[..., 0], "lzw", True, photometric=0),
    "hand bilevel min-is-white": lambda: W.encode_tiff(IMG[..., 0] >> 7, "packbits", bits=1,
                                                       photometric=0),
    "hand 4-bit palette": lambda: W.encode_tiff(IDX16, "none", bits=4, colormap=np.concatenate(
        [PAL16.T.astype(np.int64) * 257])),
    "hand 8-bit palette, 16-bit map": lambda: W.encode_tiff(
        IMG[..., 0], "lzw", colormap=np.arange(768).reshape(3, 256) * 80),
    "hand big LZW (table resets)": lambda: W.encode_tiff(np.tile(IMG, (6, 6, 1)), "lzw", True,
                                                         rows_per_strip=64),
    "write_tiff 16-bit": lambda: write_tiff(IMG16[..., 0]),
}
for _c in ("none", "packbits", "lzw", "deflate"):
    for _p in (False, True):
        TIFF_CASES[f"hand tiles {_c}{' predictor' if _p else ''}"] = (
            lambda c=_c, p=_p: W.encode_tiff(IMG, c, p, tile=(16, 16)))
        TIFF_CASES[f"hand planar strips {_c}{' predictor' if _p else ''}"] = (
            lambda c=_c, p=_p: W.encode_tiff(IMG, c, p, planar=True, rows_per_strip=5,
                                             big_endian=p))


@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_tiff_reads_as_opencv(case, tmp_path):
    """TIFF: strips and tiles, none / PackBits / LZW / Deflate, the
    horizontal predictor (which libtiff applies with LZW and Deflate only),
    8 and 16 bits, 1, 2, 3 and 4 samples, chunky and planar, both byte
    orders, gray / min-is-white / palette, associated and unassociated
    alpha (OpenCV's RGBA route premultiplies the latter)."""
    _assert_reads_as_jax(_write(tmp_path, "a.tif", TIFF_CASES[case]()))


# ---------------------------------------------------------------------------
# BMP, PNM, PFM, HDR, Sun raster, GIF
# ---------------------------------------------------------------------------

_RGBE = np.random.default_rng(3).integers(0, 256, (13, 19, 4)).astype(np.uint8)
_RGBE[..., 3] = np.random.default_rng(4).integers(100, 150, (13, 19))
_RGBE[0, :3, 3] = 0
_GIF_PAL = np.random.default_rng(5).integers(0, 256, (8, 3)).astype(np.uint8)
_GIF_IDX = np.random.default_rng(6).integers(0, 8, (9, 7)).astype(np.uint8)

OTHER_CASES = {
    # BMP
    "bmp cv2 24-bit": (".bmp", lambda: _cv2(".bmp", BGR)),
    "bmp cv2 8-bit gray": (".bmp", lambda: _cv2(".bmp", IMG[..., 0])),
    "bmp cv2 32-bit bit fields (alpha)": (".bmp", lambda: _cv2(".bmp", RGBA[..., [2, 1, 0, 3]])),
    "bmp PIL 32-bit": (".bmp", lambda: _pil(RGBA, "BMP")),
    "bmp PIL 1-bit": (".bmp", lambda: _pil(IMG[..., 0] > 100, "BMP")),
    "bmp PIL 8-bit palette": (".bmp", lambda: _pil_image(Image.fromarray(IMG).quantize(16),
                                                          "BMP")),
    "bmp 8-bit palette": (".bmp", lambda: W.encode_bmp(IDX200, 8, PAL200)),
    "bmp 8-bit top-down": (".bmp", lambda: W.encode_bmp(IDX200, 8, PAL200, top_down=True)),
    "bmp RLE8": (".bmp", lambda: W.encode_bmp(IDX200, 8, PAL200, rle=True)),
    "bmp RLE8 gray mask": (".bmp", lambda: W.encode_bmp(MASK, 8, GRAY_PAL, rle=True)),
    "bmp RLE4": (".bmp", lambda: W.encode_bmp(IDX16, 4, PAL16, rle=True)),
    "bmp 4-bit": (".bmp", lambda: W.encode_bmp(IDX16, 4, PAL16)),
    "bmp 1-bit colour": (".bmp", lambda: W.encode_bmp(IDX16 & 1, 1, np.array(
        [[255, 0, 0], [0, 0, 255]], np.uint8))),
    "bmp 16-bit 5-5-5": (".bmp", lambda: W.encode_bmp(np.random.default_rng(7).integers(
        0, 1 << 15, IMG.shape[:2]).astype(np.uint16), 16)),
    "bmp OS/2 8-bit": (".bmp", lambda: W.encode_bmp(IDX200, 8, np.pad(PAL200, ((0, 56), (0, 0))),
                                                     os2=True)),
    "bmp OS/2 24-bit": (".bmp", lambda: W.encode_bmp(IMG, 24, os2=True)),
    # PNM
    "ppm cv2": (".ppm", lambda: _cv2(".ppm", BGR)),
    "pgm cv2": (".pgm", lambda: _cv2(".pgm", IMG[..., 0])),
    "pbm cv2": (".pbm", lambda: _cv2(".pbm", IMG[..., 0] & 1)),
    "ppm cv2 16-bit": (".ppm", lambda: _cv2(".ppm", IMG16[..., ::-1].copy())),
    "pgm cv2 16-bit ASCII": (".pgm", lambda: _cv2(".pgm", IMG16[..., 0],
                                                   [cv2.IMWRITE_PXM_BINARY, 0])),
    "ppm cv2 ASCII": (".ppm", lambda: _cv2(".ppm", BGR, [cv2.IMWRITE_PXM_BINARY, 0])),
    "pbm cv2 ASCII": (".pbm", lambda: _cv2(".pbm", IMG[..., 0] & 1, [cv2.IMWRITE_PXM_BINARY, 0])),
    "pgm ASCII maxval 100, comment": (".pgm", lambda: b"P2\n# a comment\n37 29\n100\n" + " ".join(
        str(v) for v in (IMG[..., 0] // 2).ravel()).encode() + b"\n"),
    "pgm binary maxval 1000": (".pgm", lambda: b"P5\n37 29\n1000\n" + (
        IMG[..., 0].astype(np.int64) * 3).astype(">u2").tobytes()),
    "ppm PIL": (".ppm", lambda: _pil(IMG, "PPM")),
    "pbm P1 digits unspaced": (".pbm", lambda: b"P1\n37 29\n" + "".join(
        "01"[v] for v in (IMG[..., 0] & 1).ravel()).encode()),
    # PFM
    "pfm cv2": (".pfm", lambda: _cv2(".pfm", np.ascontiguousarray(FLOAT[..., ::-1]))),
    "pfm cv2 gray": (".pfm", lambda: _cv2(".pfm", np.ascontiguousarray(FLOAT[..., 0]))),
    "pfm big-endian, scale 3": (".pfm", lambda: b"PF\n37 29\n3.0\n" + FLOAT[::-1].astype(
        ">f4").tobytes()),
    "pfm little-endian gray, scale -0.7": (".pfm", lambda: b"Pf\n37 29\n-0.7\n" + FLOAT[
        ::-1, :, 0].astype("<f4").tobytes()),
    "pfm below 1.5": (".pfm", lambda: _cv2(".pfm", np.ascontiguousarray(
        FLOAT[..., ::-1] / FLOAT.max()))),
    # Radiance HDR
    "hdr cv2 RLE": (".hdr", lambda: _cv2(".hdr", np.ascontiguousarray(FLOAT[..., ::-1]))),
    "hdr cv2 flat": (".hdr", lambda: _cv2(".hdr", np.ascontiguousarray(FLOAT[..., ::-1]), [
        cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_NONE])),
    "hdr flat, zero exponents": (".hdr", lambda: W.encode_hdr_flat(_RGBE)),
    "hdr old-style run pixels": (".hdr", lambda: W.encode_hdr_flat(_RGBE, [(2, 3, 4), (5, 0, 2)])),
    "hdr narrower than 8": (".hdr", lambda: W.encode_hdr_flat(_RGBE[:, :5])),
    # Sun raster
    "ras cv2 24-bit": (".ras", lambda: _cv2(".ras", BGR)),
    "ras cv2 8-bit gray (read as zeros)": (".ras", lambda: _cv2(".ras", IMG[..., 0])),
    "ras 8-bit colour map": (".ras", lambda: W.encode_sunras(IDX200, 8, PAL200)),
    "ras 8-bit gray map": (".ras", lambda: W.encode_sunras(IMG[..., 0], 8, GRAY_PAL)),
    "ras 1-bit colour map": (".ras", lambda: W.encode_sunras(IDX16 & 1, 1, np.array(
        [[255, 0, 0], [0, 0, 255]], np.uint8))),
    "ras 1-bit no map": (".ras", lambda: W.encode_sunras(IDX16 & 1, 1)),
    "ras 32-bit": (".ras", lambda: W.encode_sunras(IMG, 32)),
    "ras old type": (".ras", lambda: W.encode_sunras(IDX200, 8, PAL200, kind=0)),
    # GIF
    "gif PIL": (".gif", lambda: _pil(IMG, "GIF")),
    "gif PIL gray": (".gif", lambda: _pil(IMG[..., 0], "GIF")),
    "gif PIL transparency": (".gif", lambda: _pil_image(Image.fromarray(IMG).quantize(8), "GIF",
                                                         transparency=2)),
    "gif PIL interlaced": (".gif", lambda: _pil(IMG, "GIF", interlace=True)),
    "gif PIL animation": (".gif", lambda: _pil_image(Image.fromarray(IMG), "GIF", save_all=True,
                                                      append_images=[Image.fromarray(255 - IMG)])),
    "gif frame on a larger screen": (".gif", lambda: W.encode_gif(
        [_GIF_IDX], _GIF_PAL, screen=(12, 11), offsets=[(3, 1)], background=3)),
    "gif frame with transparency on a screen": (".gif", lambda: W.encode_gif(
        [_GIF_IDX], _GIF_PAL, screen=(12, 11), offsets=[(3, 1)], transparent=[5], background=3)),
    "gif transparency in the second frame": (".gif", lambda: W.encode_gif(
        [_GIF_IDX, _GIF_IDX], _GIF_PAL, screen=(7, 9), transparent=[None, 5])),
    "gif local table, interlaced": (".gif", lambda: W.encode_gif(
        [_GIF_IDX], _GIF_PAL, screen=(7, 9), local=True, interlace=True)),
}


@pytest.mark.parametrize("case", sorted(OTHER_CASES))
def test_other_formats_read_as_opencv(case, tmp_path):
    """BMP (1/4/8/16/24/32 bits, RLE4 / RLE8, top-down, OS/2, gray
    palettes to one channel), PNM (P1-P6, 16-bit, ASCII scaled by maxval),
    PFM (either byte order, the scale's reciprocal applied), Radiance HDR
    (new RLE, flat, old-style run pixels as OpenCV reads them), Sun raster
    (maps, 1 to 32 bits, OpenCV's zeros for a gray image without a map) and
    GIF (first frame, transparency, the logical screen): bit-equal to
    cv2.imread, through read_image (the 1.5 rule on float content too)
    equal to the JAX package's."""
    ext, make = OTHER_CASES[case]
    _assert_reads_as_jax(_write(tmp_path, "a" + ext, make()))


# ---------------------------------------------------------------------------
# content sniffing and refusals
# ---------------------------------------------------------------------------

SNIFF_CASES = {
    "PNG named .jpg": ("a.jpg", lambda: _cv2(".png", BGR)),
    "JPEG named .png": ("a.png", lambda: _cv2(".jpg", BGR)),
    "BMP named .tif": ("a.tif", lambda: _cv2(".bmp", BGR)),
    "TIFF named .bmp": ("a.bmp", lambda: _cv2(".tif", BGR)),
    "lossless JPEG without extension": ("a", lambda: W.encode_lossless_jpeg(IMG)),
    "GIF named .png": ("m.png", lambda: _pil(IMG, "GIF")),
}


@pytest.mark.parametrize("case", sorted(SNIFF_CASES))
def test_read_image_chooses_by_content(case, tmp_path):
    """The decoder follows the file's first bytes, as OpenCV's findDecoder
    does, whatever the name says."""
    name, make = SNIFF_CASES[case]
    _assert_reads_as_jax(_write(tmp_path, name, make()))


def _sof_patched(marker: bytes, precision: int = 8) -> bytes:
    """A cv2 baseline gray JPEG whose frame header is made `marker` with
    `precision` bits (the entropy-coded data stays valid for it)."""
    data = _cv2(".jpg", IMG[..., 0])
    i = data.index(b"\xff\xc0")
    return data[:i] + marker + data[i + 2:i + 4] + bytes([precision]) + data[i + 5:]


def _jp2_header() -> bytes:
    box = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
    return box + b"\x00\x00\x00\x14ftypjp2 \x00\x00\x00\x00jp2 " + bytes(64)


REFUSED = {
    # OpenCV gives no image: the JAX package raises IOError, the port ValueError
    "12-bit lossless JPEG": (lambda: W.encode_lossless_jpeg(IMG, precision=12), "12-bit lossless"),
    "16-bit lossless JPEG": (lambda: W.encode_lossless_jpeg(IMG16[..., 0], precision=16),
                             "16-bit lossless"),
    "lossless JPEG in YCbCr (JFIF)": (lambda: W.encode_lossless_jpeg(IMG, jfif=True),
                                      "colour conversion"),
    "12-bit DCT JPEG": (lambda: _sof_patched(b"\xff\xc1", 12), "12-bit"),
    "hierarchical JPEG (SOF5)": (lambda: _sof_patched(b"\xff\xc5"), "hierarchical"),
    "Sun raster, byte-encoded": (lambda: W.encode_sunras(IDX200, 8, PAL200, kind=2),
                                 "byte-encoded"),
    "Sun raster, RGB order": (lambda: W.encode_sunras(IMG, 24, kind=3), "RGB-order"),
    "TIFF 4-bit gray": (lambda: W.encode_tiff(IMG[..., 0] >> 4, "none", bits=4), "4-bit"),
    "PGM ASCII ending in a digit": (lambda: b"P2\n37 29\n255\n" + " ".join(
        str(v) for v in IMG[..., 0].ravel()).encode(), "end of the file"),
    "EXR content under another name": (lambda: b"\x76\x2f\x31\x01" + bytes(64),
                                       "no image format"),
    "Radiance XYZE": (lambda: W.encode_hdr_flat(_RGBE).replace(b"rle_rgbe", b"rle_xyze"),
                      "FORMAT"),
    "JPEG 2000 header": (_jp2_header, "JPEG 2000"),
    "no image at all": (lambda: b"hello, world\n" * 8, "no image format"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_files_opencv_refuses_raise_in_both(case, tmp_path):
    """Files cv2.imread returns no image for raise in the JAX package (an
    IOError) and in the port (a ValueError naming the variant)."""
    make, what = REFUSED[case]
    path = _write(tmp_path, "a.img", make())
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(IOError):
        jio.read_image(path)
    with pytest.raises(ValueError, match=what):
        tio.read_image(path)


@pytest.mark.parametrize("fmt", ["webp", "webp lossless", "avif", "pam", "jp2"])
def test_formats_still_to_port_raise_naming_them(fmt, tmp_path):
    """Of the formats the JAX package reads through OpenCV, WebP (lossy and
    lossless), PAM and JPEG 2000 (OpenCV's own .jp2) now decode bit-equal to
    cv2's decode and read as the JAX package reads them
    (tests/test_torch_webp.py and tests/test_torch_jp2.py hold them in
    depth); AVIF still raises in the port naming the format (ROADMAP.md
    section 1 queues its decoder).  A JP2 signature followed by zeros, which
    OpenCV refuses, raises naming JPEG 2000 in
    test_files_opencv_refuses_raise_in_both.  (OpenCV's JPEG 2000 writer
    takes 6 resolutions, so its image is the test image tiled 2 x 2, at
    least 32 pixels a side.)"""
    ext = "." + fmt.split()[0]
    flags = [cv2.IMWRITE_WEBP_QUALITY, 101] if fmt == "webp lossless" else []
    bgr = np.tile(BGR, (2, 2, 1)) if fmt == "jp2" else BGR
    path = _write(tmp_path, "a" + ext, _cv2(ext, bgr, flags))
    assert jio.read_image(path).shape == bgr.shape
    if fmt == "avif":
        with pytest.raises(ValueError, match="AVIF"):
            tio.read_image(path)
        return
    with open(path, "rb") as f:
        got = tio.decode_image(f.read(), path)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if ref.ndim == 3:
        ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tio.read_image(path), jio.read_image(path))


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

WRITE_CASES = [(".bmp", "rgb"), (".bmp", "gray"), (".dib", "rgb"), (".tif", "rgb"),
               (".tiff", "gray"), (".ppm", "rgb"), (".pnm", "rgb"), (".pnm", "gray"),
               (".pgm", "gray"), (".pbm", "gray"), (".png", "rgb"),
               (".PNG", "gray"), (".BMP", "rgb")]


@pytest.mark.parametrize("ext,kind", WRITE_CASES)
def test_write_image_writes_what_opencv_writes(ext, kind, tmp_path):
    """write_image to .bmp / .dib, .tif / .tiff, .ppm / .pgm / .pbm / .pnm
    and .png (any case): cv2.imread of the port's file equals cv2.imread
    of the JAX package's (float input, so to8b's rounding is in both), and
    the file's content is the format its extension names."""
    img = IMG.astype(np.float32) / 255.0 + 0.001
    if kind == "gray":
        img = img[..., 0]
    ours, theirs = str(tmp_path / ("p" + ext)), str(tmp_path / ("j" + ext))
    tio.write_image(ours, img)
    jio.write_image(theirs, img)
    a = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    b = cv2.imread(theirs, cv2.IMREAD_UNCHANGED)
    assert a is not None and b is not None
    assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    with open(ours, "rb") as f:
        kind_of = tio.sniff(f.read(16))
    assert kind_of == {".bmp": "bmp", ".dib": "bmp", ".tif": "tiff", ".tiff": "tiff",
                       ".png": "png"}.get(ext.lower(), "pnm")


@pytest.mark.parametrize("name", ["a.avif", "a.xyz", "noextension", "a.EXR", "a.pxm"])
def test_write_image_refuses_other_extensions(name, tmp_path):
    """An extension the port has no writer for raises, naming it, and leaves
    no file behind (no PNG bytes under another name).  (.webp, .gif, .pfm,
    .hdr and .ras are written now: tests/test_torch_writers.py; .jp2:
    tests/test_torch_jp2_writer.py.)"""
    path = str(tmp_path / name)
    with pytest.raises(ValueError, match="the port writes"):
        tio.write_image(path, IMG)
    assert not os.path.exists(path)


def test_write_image_refuses_what_opencv_refuses(tmp_path):
    """A colour image to .pgm or .pbm, which cv2.imwrite refuses (the JAX
    package's write_image then writes nothing), raises."""
    for ext in (".pgm", ".pbm"):
        assert not jio.write_image(str(tmp_path / ("j" + ext)), IMG)
        assert not os.path.exists(str(tmp_path / ("j" + ext)))
        with pytest.raises(ValueError, match="one"):
            tio.write_image(str(tmp_path / ("p" + ext)), IMG)


# ---------------------------------------------------------------------------
# the datasets and the committed fixture
# ---------------------------------------------------------------------------

def _scene(tmp_path) -> str:
    """Two views (a CMYK and a lossless JPEG) of one camera, with a BMP
    (RLE8) and a 16-bit LZW TIFF mask."""
    import json
    root = tmp_path / "scene"
    (root / "image").mkdir(parents=True)
    (root / "mask").mkdir()
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 40.0
    K[0, 2], K[1, 2] = IMG.shape[1] / 2, IMG.shape[0] / 2
    W2C = np.eye(4)
    W2C[2, 3] = 2.0
    cams = {}
    for name, data, mask_name, mask in (
            ("v0.jpg", _pil(CMYK, "JPEG", "CMYK", quality=90), "v0.bmp",
             W.encode_bmp(MASK, 8, GRAY_PAL, rle=True)),
            ("v1.jpg", W.encode_lossless_jpeg(IMG, predictor=1), "v1.tif",
             W.encode_tiff(MASK.astype(np.uint16) * 257, "lzw", True))):
        _write(root / "image", name, data)
        _write(root / "mask", mask_name, mask)
        cams[name] = {"K": K.ravel().tolist(), "W2C": W2C.ravel().tolist(),
                      "img_size": [IMG.shape[1], IMG.shape[0]]}
    with open(root / "cam_dict_norm.json", "w") as f:
        json.dump(cams, f)
    return str(root)


def _assert_loaders_agree(root: str, n: int, mask_levels=(0.0, 1.0)) -> None:
    """The port's and the JAX package's loaders of a scene folder give the
    same arrays, its masks hold only `mask_levels` and some of each side."""
    mask_dir = os.path.join(root, "mask")
    jf, *jarrays = j_load_image_folder(root, mask_dir=mask_dir)
    f, *arrays = load_image_folder(root, mask_dir=mask_dir)
    assert [os.path.basename(p) for p in f] == [os.path.basename(p) for p in jf]
    assert len(f) == n
    for a, b in zip(arrays, jarrays):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    masks = arrays[-1]
    assert set(np.unique(masks)) <= set(np.float32(mask_levels)) and 0 < masks.mean() < 1
    ds = RayDataset.from_folder(root, mask_dir=mask_dir, device="cpu")
    jds = JRayDataset.from_folder(root, mask_dir=mask_dir)
    for k in ("images", "masks", "Ks", "W2Cs"):
        assert np.array_equal(getattr(ds, k).numpy(), np.asarray(getattr(jds, k))), k


def test_dataset_with_bmp_and_tiff_masks_matches_the_jax_loader(tmp_path):
    """A scene of CMYK and lossless JPEG views with BMP and 16-bit TIFF
    masks (glob(mask_dir/<stem>.*)): the port's load_image_folder and
    RayDataset.from_folder hold the JAX loader's arrays bit for bit."""
    _assert_loaders_agree(_scene(tmp_path), 2)


def test_committed_format_fixture_matches_the_jax_loader():
    """tests/data_formats/ (scripts/make_format_fixtures.py: CMYK, lossless
    and arithmetic-coded JPEG views; BMP, TIFF and PGM masks), which
    chip_smoke.py trains stage 1 on, loads in the port as in the JAX
    package."""
    root = os.path.join(REPO, "tests", "data_formats")
    _assert_loaders_agree(root, 3)
    with open(os.path.join(root, "image", "view0.jpg"), "rb") as f:
        assert b"Adobe" in f.read(4096)


def test_image_modules_import_without_opencv_or_pil():
    """The port's image modules import and decode, and its MPEG-4 video
    writer encodes, with cv2 and PIL blocked: the card's machine has
    neither."""
    code = ("import sys\n"
            "for m in ('cv2', 'PIL', 'jax', 'iron_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from iron_tpu_torch.data import io, jpeg, tiff, formats, webp_enc, video\n"
            "img = io.read_image('tests/data_formats/mask/view0.bmp')\n"
            "assert img.shape == (256, 256, 3), img.shape\n"
            "assert len(webp_enc.encode_webp_lossless((img * 255).astype('uint8'))) > 0\n"
            "head, vops, recs = video.encode_mpeg4([(img[:32, :48] * 255).astype('uint8')])\n"
            "assert head[:4] == b'\\0\\0\\1\\xb0' and len(vops) == len(recs) == 1\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr

