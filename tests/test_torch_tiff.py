"""The port's TIFF reader (iron_tpu_torch/data/tiff.py, ccitt.py and the JPEG
codec of jpeg.py) against OpenCV's, which the JAX package reads every TIFF
through (cv2.imread(IMREAD_UNCHANGED), libtiff 4.7): BigTIFF, JPEG
(RGB-photometric as PIL and cv2.imwrite write it, YCbCr with subsampling as
libtiff writes it, JPEGTables or none, strips and tiles), CCITT modified
Huffman, T.4 1D / 2D and T.6 with FillOrder 2, CMYK, YCbCr (every
subsampling libtiff's RGBA interface reads, ReferenceBlackWhite,
YCbCrCoefficients), CIELab (8 and 16 bits, white points), IEEE float
(32, 64 bits, both predictors), signed and wide unsigned integers, 16-bit
gray + alpha.

Each file is written by PIL's libtiff, cv2.imwrite, the system's libtiff
(ctypes) or by hand (tests/image_format_writers.py).  The port's decode
equals cv2.imread's array bit for bit (channels reversed to RGB(A)), and
the port's read_image equals iron_tpu.data.io.read_image bit for bit."""
import io
import os
import struct
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
from test_torch_image_formats import (IMG, _assert_loaders_agree, _assert_reads_as_jax, _cv2,
                                      _pil, _write)

from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.ccitt import decode_ccitt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, Wd = IMG.shape[:2]
BGR = np.ascontiguousarray(IMG[..., ::-1])
YCC = np.asarray(Image.fromarray(IMG).convert("YCbCr"))
MASK = (IMG[..., 0] > 120).astype(np.uint8)
CMYK = np.dstack([255 - IMG, IMG[..., 1:2] // 3])
FLOAT = (IMG.astype(np.float32) - 40) / 37.0           # negative and above 1 too
SIGNED = IMG.astype(np.int64) * 997 - 120000


def _lt(chunks, bps, spp, comp=1, photo=2, rows=None, extra=(), mode="w", tiled=False,
        width=Wd, height=H, **kw) -> bytes:
    """A file of the system's libtiff: the basic fields, then `extra`."""
    fields = [(256, width), (257, height), (258, bps), (277, spp), (259, comp), (262, photo)]
    if not tiled:
        fields.append((278, rows or height))
    return W.libtiff_encode(chunks, fields + list(extra), mode=mode, tiled=tiled, **kw)


def _strips(img: np.ndarray, rows: int):
    return [img[y:y + rows] for y in range(0, img.shape[0], rows)]


def _tiles(img: np.ndarray, size: int):
    out = []
    for y in range(0, img.shape[0], size):
        for x in range(0, img.shape[1], size):
            t = np.zeros((size, size) + img.shape[2:], img.dtype)
            b = img[y:y + size, x:x + size]
            t[:b.shape[0], :b.shape[1]] = b
            out.append(t)
    return out


def _jpeg_ycbcr(sub, rows=16, quality=75):
    """YCbCr JPEG as libtiff writes it (RGB in, JPEGCOLORMODE_RGB)."""
    return _lt(_strips(IMG, rows), 8, 3, 7, 6, rows,
               [(65538, 1), (530, *sub), (65537, quality)])


def _ccitt_lt(comp, photo=0, t4=0, fill=1, rows=16, mask=MASK):
    extra = ([(292, t4)] if t4 else []) + ([(266, fill)] if fill != 1 else [])
    return _lt([np.packbits(s, axis=1) for s in _strips(mask, rows)], 1, 1, comp, photo, rows,
               extra, width=mask.shape[1], height=mask.shape[0])


def _pil_image(im: Image.Image, **kw) -> bytes:
    f = io.BytesIO()
    im.save(f, "TIFF", **kw)
    return f.getvalue()


def _pil_bilevel(mask, compression, **kw) -> bytes:
    return _pil(mask.astype(bool), "TIFF", compression=compression, **kw)


def _lab_sweep() -> np.ndarray:
    """CIELab 8-bit samples: every L against every a, b a pattern of both."""
    L, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    return np.stack([L, a, (L * 7 + a * 13) % 256], -1).astype(np.uint8)[::4]


VARIANTS = {
    # the container
    "BigTIFF RGB (libtiff)": lambda: _lt([IMG], 8, 3, mode="w8"),
    "BigTIFF big-endian LZW predictor strips (libtiff)": lambda: _lt(
        _strips(IMG, 8), 8, 3, 5, 2, 8, [(317, 2)], mode="w8b"),
    "BigTIFF float tiles, predictor 3 (hand)": lambda: W.encode_tiff(
        FLOAT, "deflate", 3, tile=(16, 16), bigtiff=True, sample_format=3),
    "BigTIFF big-endian palette (hand)": lambda: W.encode_tiff(
        IMG[..., 0], "lzw", colormap=np.arange(768).reshape(3, 256) * 80, bigtiff=True,
        big_endian=True),
    # JPEG
    "JPEG RGB photometric (PIL)": lambda: _pil(IMG, "TIFF", compression="jpeg"),
    "JPEG RGB photometric (cv2.imwrite)": lambda: _cv2(".tif", BGR,
                                                       [cv2.IMWRITE_TIFF_COMPRESSION, 7]),
    "JPEG gray (cv2.imwrite)": lambda: _cv2(".tif", IMG[..., 0],
                                            [cv2.IMWRITE_TIFF_COMPRESSION, 7]),
    "JPEG RGB photometric, strips of 8 (libtiff)": lambda: _lt(
        _strips(IMG, 8), 8, 3, 7, 2, 8, [(65537, 40)]),
    "JPEG CMYK (libtiff)": lambda: _lt([CMYK], 8, 4, 7, 5),
    "JPEG YCbCr 2x2 tiles (libtiff)": lambda: _lt(
        _tiles(IMG, 16), 8, 3, 7, 6, extra=[(65538, 1), (530, 2, 2), (322, 16), (323, 16)],
        tiled=True),
    "JPEG YCbCr 2x2 tiles, JPEGTables (hand, the port's encoder)": lambda: W.encode_tiff(
        IMG, "jpeg", tile=(16, 16)),
    "JPEG YCbCr 2x2 strips without JPEGTables (hand)": lambda: W.encode_tiff(
        IMG, "jpeg", rows_per_strip=16, jpeg_tables=False),
    **{f"JPEG YCbCr {h}x{v} strips (libtiff)": (lambda h=h, v=v: _jpeg_ycbcr(
        (h, v), 16 * v)) for h, v in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2))},
    # CCITT
    "CCITT modified Huffman (PIL)": lambda: _pil_bilevel(MASK, "tiff_ccitt"),
    "CCITT T.4 1D (PIL)": lambda: _pil_bilevel(MASK, "group3"),
    "CCITT T.4 2D, FillOrder 2 (PIL)": lambda: _pil_bilevel(MASK, "group3",
                                                          tiffinfo={292: 1, 266: 2}),
    "CCITT T.6 (PIL)": lambda: _pil_bilevel(MASK, "group4"),
    "CCITT T.6, FillOrder 2, min-is-white strips (libtiff)": lambda: _ccitt_lt(4, 0, fill=2),
    "CCITT T.4 2D, EOLs byte-aligned, min-is-black strips (libtiff)": lambda: _ccitt_lt(
        3, 1, t4=5),
    "CCITT T.4 1D, EOLs byte-aligned (libtiff)": lambda: _ccitt_lt(3, 0, t4=4),
    "CCITT modified Huffman, FillOrder 2 (libtiff)": lambda: _ccitt_lt(2, 1, fill=2),
    "CCITT T.6 tiles (libtiff)": lambda: _lt(
        [np.packbits(t, axis=1) for t in _tiles(MASK, 16)], 1, 1, 4, 0,
        extra=[(322, 16), (323, 16)], tiled=True),
    # CMYK
    "CMYK (PIL)": lambda: _pil_image(Image.fromarray(IMG).convert("CMYK")),
    "CMYK LZW predictor (hand)": lambda: W.encode_tiff(CMYK, "lzw", True, photometric=5,
                                                       rows_per_strip=8),
    "CMYK planar tiles (hand)": lambda: W.encode_tiff(CMYK, "deflate", tile=(16, 16),
                                                      planar=True, photometric=5),
    # YCbCr without JPEG
    "YCbCr 1x1 (PIL)": lambda: _pil_image(Image.fromarray(IMG).convert("YCbCr")),
    **{f"YCbCr {h}x{v} (hand)": (lambda h=h, v=v: W.encode_tiff(
        YCC, "lzw", subsampling=(h, v), rows_per_strip=4 * v))
       for h, v in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))},
    "YCbCr 2x2 tiles (hand)": lambda: W.encode_tiff(YCC, "none", subsampling=(2, 2),
                                                    tile=(16, 16)),
    "YCbCr 2x2, ReferenceBlackWhite 16-235 / 16-240 (hand)": lambda: W.encode_tiff(
        YCC, "none", subsampling=(2, 2),
        extra_tags=[(532, 5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])]),
    "YCbCr 1x1, BT.709 YCbCrCoefficients (hand)": lambda: W.encode_tiff(
        YCC, "deflate", subsampling=(1, 1),
        extra_tags=[(529, 5, [(2126, 10000), (7152, 10000), (722, 10000)])]),
    "YCbCr 1x1 planar (libtiff)": lambda: _lt(
        [YCC[..., i] for i in range(3)], 8, 3, 1, 6, extra=[(284, 2), (530, 1, 1)]),
    # CIELab
    "CIELab (PIL)": lambda: _pil_image(Image.fromarray(IMG).convert("LAB")),
    "CIELab 8-bit, every L against every a (hand)": lambda: W.encode_tiff(
        _lab_sweep(), "deflate", photometric=8),
    "CIELab 16-bit (hand)": lambda: W.encode_tiff(
        np.random.default_rng(3).integers(0, 65536, (H, Wd, 3)).astype(np.uint16), "lzw",
        photometric=8),
    "CIELab 8-bit, white point D65 (hand)": lambda: W.encode_tiff(
        IMG, "none", photometric=8, extra_tags=[(318, 5, [(3127, 10000), (3290, 10000)])]),
    # IEEE float
    "float32 gray (PIL)": lambda: _pil_image(Image.fromarray(FLOAT[..., 0], "F")),
    "float32 RGB (cv2.imwrite)": lambda: _cv2(".tif", np.ascontiguousarray(FLOAT[..., ::-1])),
    "float64 gray (cv2.imwrite)": lambda: _cv2(".tif", FLOAT[..., 0].astype(np.float64)),
    "float32 RGBA big-endian, predictor 3 (hand)": lambda: W.encode_tiff(
        np.dstack([FLOAT, FLOAT[..., :1]]), "deflate", 3, big_endian=True, sample_format=3,
        extra_samples=2, rows_per_strip=8),
    "float64 RGB, predictor 3 tiles (libtiff)": lambda: _lt(
        _tiles(FLOAT.astype(np.float64) * 1e7, 16), 64, 3, 8, 2,
        extra=[(339, 3), (317, 3), (322, 16), (323, 16)], tiled=True),
    "float64 RGB big-endian, predictor 2 (hand)": lambda: W.encode_tiff(
        FLOAT.astype(np.float64), "lzw", 2, big_endian=True, sample_format=3),
    "float32 gray, min-is-white (libtiff)": lambda: _lt([FLOAT[..., 0]], 32, 1, 1, 0,
                                                        extra=[(339, 3)]),
    # signed and wide integers
    "int8 gray (hand)": lambda: W.encode_tiff(SIGNED[..., 0].astype(np.int8), "none",
                                              sample_format=2),
    "int8 RGB LZW (hand)": lambda: W.encode_tiff(SIGNED.astype(np.int8), "lzw", True,
                                                 sample_format=2),
    "int16 gray, predictor (hand)": lambda: W.encode_tiff(
        SIGNED[..., 0].astype(np.int16), "deflate", True, sample_format=2),
    "int16 RGB big-endian (hand)": lambda: W.encode_tiff(
        SIGNED.astype(np.int16), "packbits", big_endian=True, sample_format=2),
    "int32 gray (PIL)": lambda: _pil_image(Image.fromarray(SIGNED[..., 0].astype(np.int32),
                                                           "I")),
    "int32 RGB, predictor (libtiff)": lambda: _lt([SIGNED.astype(np.int32)], 32, 3, 5, 2,
                                                  extra=[(339, 2), (317, 2)]),
    "uint32 gray (libtiff)": lambda: _lt([(SIGNED[..., 0] + 2 ** 31).astype(np.uint32)], 32,
                                         1, 8, 1),
    "int64 gray big-endian (hand)": lambda: W.encode_tiff(SIGNED[..., 0] * 2 ** 30, "deflate",
                                                          big_endian=True, sample_format=2),
    "uint64 RGB tiles, predictor (hand)": lambda: W.encode_tiff(
        (SIGNED + 2 ** 40).astype(np.uint64), "lzw", True, tile=(16, 16), sample_format=1),
    # 16-bit gray + alpha: libtiff's RGBA interface, the high byte
    "16-bit gray + alpha (libtiff)": lambda: _lt(
        [np.dstack([IMG[..., 0], IMG[..., 1]]).astype(np.uint16) * 257 + 3], 16, 2, 1, 1,
        extra=[(338, 1, np.array([2], np.uint16))]),
    "16-bit gray + alpha, min-is-white (hand)": lambda: W.encode_tiff(
        np.dstack([IMG[..., 0], IMG[..., 1]]).astype(np.uint16) * 250, "lzw", True,
        photometric=0, extra_samples=2),
    "int16 gray + alpha (hand)": lambda: W.encode_tiff(
        np.dstack([SIGNED[..., 0], SIGNED[..., 1]]).astype(np.int16), "none",
        extra_samples=1, sample_format=2),
    # the Orientation field (OpenCV mirrors, turns or flips the image)
    **{f"orientation {o}, {kind} (hand)": (lambda o=o, a=a, kw=kw: W.encode_tiff(
        a, "lzw", extra_tags=[(274, 3, [o])], **kw))
       for o in (2, 3, 4) for kind, a, kw in (
           ("RGB strips", IMG, {"rows_per_strip": 8}),
           ("16-bit gray tiles", IMG[..., 0].astype(np.uint16) * 255, {"tile": (16, 16)}),
           ("float32 RGB", FLOAT, {"sample_format": 3}))},
    "orientation 4, RGB tiles (hand)": lambda: W.encode_tiff(
        IMG, "deflate", tile=(16, 16), extra_tags=[(274, 3, [4])]),
    # FillOrder 2 under the other codecs
    "FillOrder 2, LZW RGB (libtiff)": lambda: _lt([IMG], 8, 3, 5, 2, extra=[(266, 2)]),
    "FillOrder 2, Deflate 16-bit gray (hand)": lambda: W.encode_tiff(
        IMG[..., 0].astype(np.uint16) * 251, "deflate", True, fill_order=2),
    "FillOrder 2, PackBits palette (hand)": lambda: W.encode_tiff(
        IMG[..., 0], "packbits", colormap=np.arange(768).reshape(3, 256) * 80, fill_order=2),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_tiff_variant_reads_as_opencv(case, tmp_path):
    """Each variant: the port's decode is cv2.imread's array (dtype, shape,
    bytes; channels in RGB(A) order), and read_image the JAX package's
    float32 array, bit for bit."""
    data = VARIANTS[case]()
    assert data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
    _assert_reads_as_jax(_write(tmp_path, "a.tif", data))


def _run_mask(width: int) -> np.ndarray:
    """Rows that hold every run length from 0 to `width` - 1 of white and
    from `width` to 1 of black (row 2 y: y white pixels, then black), each
    after an all-white row, so that T.6 codes them in horizontal mode."""
    m = np.zeros((2 * width, width), np.uint8)
    for y in range(width):
        m[2 * y, y:] = 1
    return m


@pytest.mark.parametrize("coding", ["tiff_ccitt", "group3", "group3 2D", "group4"])
def test_ccitt_every_run_length_reads_as_opencv(coding, tmp_path):
    """The code tables: a bilevel image with every run length of both
    colours from 0 past 2560 (the extended make-up codes and runs of more
    than one make-up code), written by PIL's libtiff, decodes as OpenCV
    decodes it."""
    m = _run_mask(2700)
    info = {"tiffinfo": {292: 1}} if coding == "group3 2D" else {}
    path = _write(tmp_path, "a.tif", _pil_bilevel(m, coding.split()[0], **info))
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    with open(path, "rb") as f:
        got = tio.decode_image(f.read())
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape == m.shape
    assert np.array_equal(got, ref)
    assert len(np.unique(ref)) == 2 and np.array_equal(ref == ref[0, -1], m == 1)


def test_ccitt_decoder_alone():
    """decode_ccitt on one T.6 strip of libtiff's: the rows packed 8 pixels
    a byte, 1 bits black, and no error.  A T.4 strip of libtiff's with
    T4Options bit 1 (uncompressed mode allowed) decodes as libtiff decodes
    it: the bit alone changes nothing.  A strip cut in half keeps the rows
    before the cut, as libtiff's decoder does: T.6 then reports the error,
    T.4 fills the rows left from the strip's start without EOLs (libtiff's
    retry) and does not."""
    want = np.packbits(MASK, axis=1)
    for comp, t4 in ((4, 0), (3, 2), (3, 3)):
        data = _ccitt_lt(comp, 0, t4=t4, rows=H)
        im = Image.open(io.BytesIO(data))
        off, n = im.tag_v2[273][0], im.tag_v2[279][0]
        strip = data[off:off + n]
        rows, failed = decode_ccitt(strip, Wd, H, comp, t4_options=t4)
        assert np.array_equal(rows, want) and not failed
        rows, failed = decode_ccitt(strip[:len(strip) // 2], Wd, H, comp, t4_options=t4)
        assert np.array_equal(rows[:H // 4], want[:H // 4])
        assert not np.array_equal(rows, want) and failed == (comp == 4)


def _with_short(data: bytes, tag: int, value: int) -> bytes:
    """A classic little-endian TIFF with the SHORT field `tag` set to
    `value` (in place)."""
    (off,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[off:off + 2])
    for i in range(n):
        e = off + 2 + 12 * i
        if struct.unpack("<H", data[e:e + 2])[0] == tag:
            return data[:e + 8] + struct.pack("<HH", value, 0) + data[e + 12:]
    raise KeyError(tag)


REFUSED = {
    # cv2.imread returns no image: the JAX package raises IOError, the port
    # ValueError naming what it met
    "LZMA": (lambda: _lt([IMG], 8, 3, 34925), "LZMA"),
    "ZSTD": (lambda: _lt([IMG], 8, 3, 50000), "ZSTD"),
    "old-style JPEG": (lambda: _with_short(W.encode_tiff(IMG), 259, 6), "old-style JPEG"),
    "16-bit palette": (lambda: W.encode_tiff(IMG[..., 0].astype(np.uint16) * 200, "none",
                                             colormap=np.arange(3 * 65536) % 65536),
                       "palette 16-bit"),
    "16-bit float": (lambda: W.encode_tiff(FLOAT[..., 0].astype(np.float16), "none",
                                           sample_format=3), "16-bit samples of format 3"),
    "float32 gray + alpha": (lambda: W.encode_tiff(FLOAT[..., :2], "none", sample_format=3,
                                                   extra_samples=2), "2 a pixel"),
    "int32 gray + alpha": (lambda: W.encode_tiff(SIGNED[..., :2].astype(np.int32), "none",
                                                 sample_format=2, extra_samples=2),
                           "RGBA interface"),
    "16-bit CMYK": (lambda: W.encode_tiff(CMYK.astype(np.uint16) * 257, "none",
                                          photometric=5), "CMYK 16-bit"),
    "YCbCr 2x4": (lambda: W.encode_tiff(YCC, "none", subsampling=(2, 4)), "subsampling 2x4"),
    "CMYK + alpha": (lambda: W.encode_tiff(np.dstack([CMYK, IMG[..., :1]]), "none",
                                           photometric=5, extra_samples=2), "5 samples"),
    "floating-point predictor on int32": (lambda: W.encode_tiff(
        SIGNED[..., 0].astype(np.int32), "deflate", 3, sample_format=2), "predictor 3"),
    **{f"orientation {o}": ((lambda o=o: W.encode_tiff(IMG, "none", extra_tags=[(274, 3, [o])])),
                            f"orientation {o}") for o in (5, 6, 7, 8)},
    # the corners of 10- to 14-bit samples, the other photometrics, SGILOG
    "10-bit gray, horizontal predictor": (lambda: _lt(
        [W.pack_samples(IMG[..., 0].astype(np.uint16) * 4, 10).tobytes()], 10, 1, 5, 1,
        extra=[(317, 2)], raw=True), "predictor 2"),
    "12-bit float": (lambda: _lt([W.pack_samples(IMG[..., 0], 12).tobytes()], 12, 1, 1, 1,
                                 extra=[(339, 3)]), "12-bit samples of format 3"),
    "12-bit palette": (lambda: _lt(
        [W.pack_samples(IMG[..., 0], 12).tobytes()], 12, 1, 1, 3,
        extra=[(320, *[np.arange(4096, dtype=np.uint16) * 16] * 3)]), "palette 12-bit"),
    "12-bit gray + alpha": (lambda: _lt(
        [W.pack_samples(IMG[..., :2], 12).tobytes()], 12, 2, 1, 1,
        extra=[(338, 1, np.array([2], np.uint16))]), "12-bit samples of format 1, 2 a pixel"),
    "12-bit CMYK": (lambda: _lt([W.pack_samples(CMYK, 12).tobytes()], 12, 4, 1, 5),
                    "CMYK 12-bit"),
    **{f"{b}-bit gray": ((lambda b=b: _lt([W.pack_samples(IMG[..., 0], b).tobytes()], b, 1, 1,
                                          1)), f"{b}-bit samples")
       for b in (9, 24)},
    "photometric 4 (transparency mask)": (lambda: _lt([np.packbits(MASK, axis=1)], 1, 1, 1, 4),
                                          "photometric 4"),
    "photometric 9 (ICC Lab)": (lambda: _lt([IMG], 8, 3, 1, 9), "photometric 9"),
    "photometric 9, 16-bit": (lambda: _lt([IMG.astype(np.uint16) * 257], 16, 3, 1, 9),
                              "photometric 9"),
    "photometric 10 (ITU Lab)": (lambda: _lt([IMG], 8, 3, 1, 10), "photometric 10"),
    "LogL with 24-bit SGILOG": (lambda: _lt([FLOAT[..., 0]], 32, 1, 34677, 32844,
                                            extra=[(65560, 0)]), "LogL with 24-bit"),
    "LogLuv without SGILOG": (lambda: _lt([FLOAT], 32, 3, 1, 32845, extra=[(339, 3)]),
                              "only through SGILOG"),
    "SGILOG RGB": (lambda: _with_short(W.encode_tiff(IMG), 259, 34676),
                   "SGILOG compression of photometric 2"),
    "planar LogLuv": (lambda: _with_short(_lt([np.abs(FLOAT)], 32, 3, 34676, 32845,
                                              extra=[(65560, 0), (284, 1)]), 284, 2),
                      "planar LogLuv"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_tiff_variants_opencv_refuses_raise_in_both(case, tmp_path):
    """TIFF variants cv2.imread gives no image for raise in the JAX package
    (IOError) and in the port (a ValueError naming the variant)."""
    make, what = REFUSED[case]
    path = _write(tmp_path, "a.tif", make())
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(IOError):
        jio.read_image(path)
    with pytest.raises(ValueError, match=what):
        tio.read_image(path)


def test_word_aligned_ccitt_raises_where_opencv_misreads(tmp_path):
    """CCITT 32771 (modified Huffman on 16-bit words): OpenCV's libtiff
    decodes libtiff's own such file into rows that are not the image, so
    the port raises rather than match it."""
    path = _write(tmp_path, "a.tif", _ccitt_lt(32771, 1, rows=H))
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ref is not None and not np.array_equal(ref == 255, MASK == 1)
    with pytest.raises(ValueError, match="32771"):
        tio.read_image(path)


@pytest.mark.parametrize("orientation", [2, 3])
def test_mirrored_8bit_tiles_raise_where_opencv_misreads(orientation, tmp_path):
    """8-bit tiles mirrored or turned by the Orientation field: OpenCV's
    decode is not the image mirrored or turned (libtiff's RGBA interface
    flips each tile, OpenCV the whole image), so the port raises."""
    path = _write(tmp_path, "a.tif", W.encode_tiff(IMG, "none", tile=(16, 16),
                                                   extra_tags=[(274, 3, [orientation])]))
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
    assert not np.array_equal(ref, IMG[::-1 if orientation == 3 else 1, ::-1])
    with pytest.raises(ValueError, match="misreads"):
        tio.read_image(path)


def test_committed_tiff_fixture_matches_the_jax_loader():
    """tests/data_tiff/ (scripts/make_tiff_fixtures.py: a YCbCr JPEG-in-TIFF
    in tiles, a BigTIFF float32 view with the floating-point predictor, a
    CMYK LZW view; Group 4, Group 3 2D FillOrder 2 and float64 masks), which
    chip_smoke.py trains stage 1 on, loads in the port as in the JAX
    package, and each file decodes to the OpenCV hash recorded beside it."""
    import hashlib
    import json
    root = os.path.join(REPO, "tests", "data_tiff")
    _assert_loaders_agree(root, 3)
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        expected = json.load(f)
    assert len(expected) == 6
    for key, want in expected.items():
        with open(os.path.join(root, key), "rb") as f:
            raw = np.ascontiguousarray(tio.decode_image(f.read(), key))
        got = {"shape": list(raw.shape), "dtype": str(raw.dtype),
               "sha256": hashlib.sha256(raw.tobytes()).hexdigest()}
        assert got == want, key


def test_tiff_modules_import_without_opencv_or_pil():
    """tiff.py, ccitt.py, jpeg.py and utils/visualize.py import, and decode
    the fixtures (tests/data_tiff/ and tests/data_tiff_wide/: 10- to
    16-bit samples, gray of three, LogLuv), with cv2, PIL, matplotlib, jax
    and iron_tpu blocked: the card's machine has none of them."""
    code = ("import sys\n"
            "for m in ('cv2', 'PIL', 'matplotlib', 'jax', 'iron_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from iron_tpu_torch.data import io, tiff, ccitt, jpeg\n"
            "from iron_tpu_torch.utils import visualize\n"
            "for name in ('data_tiff/image/view0.jpg', 'data_tiff/image/view1.png',\n"
            "             'data_tiff/mask/view0.tif', 'data_tiff/mask/view1.tif',\n"
            "             'data_tiff_wide/image/view0.jpg', 'data_tiff_wide/image/view2.png',\n"
            "             'data_tiff_wide/mask/view0.tif', 'data_tiff_wide/mask/view2.tif'):\n"
            "    img = io.read_image('tests/' + name)\n"
            "    assert img.shape == (256, 256, 3), (name, img.shape)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
