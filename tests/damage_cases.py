"""Damaged image files for the tests of the port's readers against
cv2.imread (tests/test_torch_damaged.py) and for the wider sweep of
scripts/sweep_damaged.py.

FORMATS: each format's file, written from a seeded image by OpenCV (by
tests/image_format_writers.py where OpenCV writes no such file), its
extension, and the span of its coded data.  DAMAGE, the damage classes:

  cut    the file cut at a seeded point;
  byte   one byte of its coded data set to a seeded value (JPEG: from its
         first scan to EOI; PNG: the IDAT data; WebP: the VP8 / VP8L data
         after the frame header; TIFF: the strips (LZW from OpenCV,
         Deflate with the horizontal predictor); BMP, PPM: the pixels;
         GIF: the LZW sub-blocks; JPEG 2000: from the first SOD to EOC);
  end    the end marker dropped (JPEG's EOI, PNG's IEND chunk, GIF's
         trailer, the codestream's EOC); where the format has none, what
         stands for it: WebP's RIFF size off by a seeded amount, BMP's
         file-size field set to a seeded value, a TIFF whose last strip is
         cut (PIL's, its directory first), a PPM without its last byte;
  trail  seeded bytes after the end of the file.

`outcome` writes the file and reads it with cv2.imread (by its path, as the
JAX package reads it) and with the port's decode_image; `verdict` holds the
port to one of two outcomes: OpenCV's array exactly, or NoImage where
cv2.imread gives None.  (A damage class the port could not reproduce
would raise a ValueError naming it and be listed in ROADMAP.md section 3;
there is none.)
"""
from __future__ import annotations

import io
import struct
from typing import Callable, Dict, Tuple

import cv2
import numpy as np

import image_format_writers as W
from iron_tpu_torch.data import io as tio

DAMAGE = ("cut", "byte", "end", "trail")


def image(seed: int, H: int = 40, W_: int = 56, C: int = 3) -> np.ndarray:
    """A blurred noise image (BGR for OpenCV), sides not multiples of 8."""
    g = np.random.default_rng(seed)
    shape = (H, W_, C) if C > 1 else (H, W_)
    return cv2.GaussianBlur(g.integers(0, 256, shape).astype(np.uint8), (7, 7), 2)


def _cv2(ext: str, img: np.ndarray, *flags) -> bytes:
    ok, buf = cv2.imencode(ext, img, list(flags))
    assert ok, ext
    return buf.tobytes()


def _jpeg_span(d: bytes) -> Tuple[int, int]:
    i = d.find(b"\xff\xda")
    return i + 2 + ((d[i + 2] << 8) | d[i + 3]), len(d) - 2


def _png_span(d: bytes) -> Tuple[int, int]:
    i = d.find(b"IDAT")
    return i + 4, i + 4 + struct.unpack(">I", d[i - 4:i])[0]


def _webp_span(d: bytes) -> Tuple[int, int]:
    for tag, skip in ((b"VP8 ", 10), (b"VP8L", 5)):
        i = d.find(tag)
        if i >= 0:
            return i + 8 + skip, i + 8 + struct.unpack("<I", d[i + 4:i + 8])[0]
    raise ValueError("no VP8 / VP8L chunk")


def _tiff_span(d: bytes) -> Tuple[int, int]:
    from iron_tpu_torch.data.tiff import _header, _ifd
    t = _ifd(d, *_header(d))
    return min(t[273]), max(o + n for o, n in zip(t[273], t[279]))


def _pnm_span(d: bytes) -> Tuple[int, int]:
    return d.index(b"\n255\n") + 5, len(d)


def _gif_span(d: bytes) -> Tuple[int, int]:
    flags = d[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    while d[pos] == 0x21:                       # extensions
        pos += 2
        while d[pos]:
            pos += 1 + d[pos]
        pos += 1
    iflags = d[pos + 9]
    pos += 10 + (3 << ((iflags & 7) + 1) if iflags & 0x80 else 0)
    return pos + 1, len(d) - 1


def _jp2_span(d: bytes) -> Tuple[int, int]:
    return d.find(b"\xff\x93") + 2, len(d) - 2


def _one_scan_a_component(img: np.ndarray) -> bytes:
    """A baseline JPEG, 4:2:0, with a scan for each component (which
    neither OpenCV nor PIL writes), from the port's encoder's pieces."""
    from iron_tpu_torch.data import jpeg as J
    rgb = np.ascontiguousarray(img[..., ::-1])
    H, W_ = rgb.shape[:2]
    qy, qc = J.quant_table(J._LUMA_Q, 90), J.quant_table(J._CHROMA_Q, 90)
    huff = [(J._huff_codes(*J._DC_LUMA), J._huff_codes(*J._AC_LUMA)),
            (J._huff_codes(*J._DC_CHROMA), J._huff_codes(*J._AC_CHROMA))]
    ycc = J._rgb_to_ycc(rgb)
    out = [b"\xff\xd8", J._segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out += [J._segment(0xFFDB, bytes([t]) + bytes(q[J.ZIGZAG].tolist()))
            for t, q in enumerate((qy, qc))]
    comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    out.append(J._segment(0xFFC0, struct.pack(">BHHB", 8, H, W_, 3)
                          + b"".join(struct.pack(">BBB", *c) for c in comps)))
    for cls, tid, (bits, vals) in ((0, 0, J._DC_LUMA), (1, 0, J._AC_LUMA),
                                   (0, 1, J._DC_CHROMA), (1, 1, J._AC_CHROMA)):
        out.append(J._segment(0xFFC4, bytes([cls << 4 | tid]) + bytes(bits) + bytes(vals)))
    for i, (cid, _, t) in enumerate(comps):
        p = ycc[i] if i == 0 else J._h2v2_downsample(J._pad_edges(ycc[i], H + H % 2,
                                                                  W_ + W_ % 2))
        by, bx = -(-p.shape[0] // 8), -(-p.shape[1] // 8)
        blocks = J._fdct_quantize(J._pad_edges(p, 8 * by, 8 * bx), (qy, qc)[t > 0])
        blocks = blocks.reshape(-1, 64)
        out.append(J._segment(0xFFDA, bytes([1, cid, t << 4 | t]) + b"\x00\x3f\x00"))
        out.append(J._entropy_code(blocks, np.full(len(blocks), t), np.zeros(len(blocks), int),
                                   huff))
    return b"".join(out) + b"\xff\xd9"


def _pil_tiff(img: np.ndarray) -> bytes:
    from PIL import Image
    f = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(f, "TIFF")
    return f.getvalue()


# name -> (the file from a seed, extension, the span of its coded data)
FORMATS: Dict[str, Tuple[Callable[[int], bytes], str, Callable]] = {
    "jpeg 4:2:0": (lambda s: _cv2(".jpg", image(s)), ".jpg", _jpeg_span),
    "jpeg 4:4:4": (lambda s: _cv2(".jpg", image(s), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444), ".jpg", _jpeg_span),
    "jpeg gray": (lambda s: _cv2(".jpg", image(s, C=1)), ".jpg", _jpeg_span),
    "jpeg restarts": (lambda s: _cv2(".jpg", image(s), cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
                      ".jpg", _jpeg_span),
    "jpeg 4:2:2": (lambda s: _cv2(".jpg", image(s), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422), ".jpg", _jpeg_span),
    "jpeg 4:1:1": (lambda s: _cv2(".jpg", image(s), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411), ".jpg", _jpeg_span),
    "jpeg one scan a component": (lambda s: _one_scan_a_component(image(s)), ".jpg",
                                  _jpeg_span),
    "jpeg progressive restarts": (lambda s: _cv2(".jpg", image(s), cv2.IMWRITE_JPEG_PROGRESSIVE,
                                                 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 3), ".jpg",
                                  _jpeg_span),
    "jpeg arithmetic progressive": (lambda s: W.libjpeg_encode(
        image(s)[..., ::-1], arith=True, progressive=True, restart=4), ".jpg", _jpeg_span),
    "jpeg cmyk progressive": (lambda s: W.libjpeg_encode(
        np.dstack([image(s), image(s + 1, C=1)]), space="cmyk", progressive=True), ".jpg",
        _jpeg_span),
    "jpeg progressive": (lambda s: _cv2(".jpg", image(s), cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
                         ".jpg", _jpeg_span),
    "jpeg arithmetic": (lambda s: W.libjpeg_encode(image(s)[..., ::-1], arith=True,
                                                   restart=3), ".jpg", _jpeg_span),
    "jpeg lossless": (lambda s: W.encode_lossless_jpeg(image(s)[..., ::-1], predictor=4,
                                                       restart_rows=8), ".jpg", _jpeg_span),
    "jpeg lossless subsampled": (lambda s: W.encode_lossless_jpeg(
        image(s)[..., ::-1], predictor=6, sampling=[(2, 2), (1, 1), (1, 1)]), ".jpg",
        _jpeg_span),
    "png": (lambda s: _cv2(".png", image(s)), ".png", _png_span),
    "webp lossy": (lambda s: _cv2(".webp", image(s), cv2.IMWRITE_WEBP_QUALITY, 80), ".webp",
                   _webp_span),
    "webp lossless": (lambda s: _cv2(".webp", image(s), cv2.IMWRITE_WEBP_QUALITY, 101),
                      ".webp", _webp_span),
    "tiff lzw": (lambda s: _cv2(".tif", image(s)), ".tif", _tiff_span),
    "tiff deflate": (lambda s: W.encode_tiff(image(s)[..., ::-1], "deflate", predictor=True,
                                             rows_per_strip=8), ".tif", _tiff_span),
    "bmp": (lambda s: _cv2(".bmp", image(s)), ".bmp", lambda d: (struct.unpack(
        "<I", d[10:14])[0], len(d))),
    "ppm": (lambda s: _cv2(".ppm", image(s)), ".ppm", _pnm_span),
    "gif": (lambda s: _cv2(".gif", image(s)), ".gif", _gif_span),
    "jp2": (lambda s: _cv2(".jp2", image(s)), ".jp2", _jp2_span),
}


def damaged(name: str, kind: str, seed: int) -> bytes:
    """The format's file from `seed`, with damage of class `kind` drawn
    from the same seed."""
    make, _, span = FORMATS[name]
    g = np.random.default_rng([seed, DAMAGE.index(kind)])
    d = make(seed)
    if kind == "cut":
        return d[:int(g.integers(1, len(d)))]
    if kind == "byte":
        lo, hi = span(d)
        at = int(g.integers(lo, hi))
        return d[:at] + bytes([int(g.integers(0, 256))]) + d[at + 1:]
    if kind == "trail":
        return d + g.integers(0, 256, int(g.integers(1, 64))).astype(np.uint8).tobytes()
    if name.startswith("jpeg") or name == "jp2":
        return d[:-2]                           # EOI / EOC
    if name == "png":
        return d[:-12]                          # the IEND chunk
    if name == "gif":
        return d[:-1]                           # the trailer
    if name.startswith("webp"):
        riff = struct.unpack("<I", d[4:8])[0] + int(g.choice([-1, 1]) * g.integers(1, 17))
        return d[:4] + struct.pack("<I", riff) + d[8:]
    if name == "bmp":
        return d[:2] + struct.pack("<I", int(g.integers(0, 1 << 32))) + d[6:]
    if name.startswith("tiff"):
        d = _pil_tiff(image(seed))
        lo, hi = _tiff_span(d)
        return d[:int(g.integers(lo, hi))]
    return d[:-1]                               # a PNM's last byte


def seeded(name: str, kind: str) -> bool:
    """Whether the damage depends on its seed (an end marker dropped does
    not)."""
    return kind != "end" or name.startswith(("webp", "tiff")) or name == "bmp"


def outcome(path: str, data: bytes):
    """(cv2.imread(path, IMREAD_UNCHANGED) with its channels in RGB(A)
    order, or None; the port's decode_image, or the ValueError it
    raised) for `data` written to `path`."""
    with open(path, "wb") as f:
        f.write(data)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if ref is not None and ref.ndim == 3:
        ref = np.ascontiguousarray(ref[..., [2, 1, 0, 3][:ref.shape[2]]])
    try:
        got = tio.decode_image(data, path)
    except ValueError as e:
        got = e
    return ref, got


def verdict(ref, got) -> str:
    """'equal' (OpenCV's array), 'refused' (None and NoImage), or what went
    wrong."""
    if ref is None:
        return "refused" if isinstance(got, tio.NoImage) else f"OpenCV: None, port: {got!r:.200}"
    if isinstance(got, Exception):
        return f"OpenCV: an image, port: {got!r:.200}"
    if got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref):
        return "equal"
    return "OpenCV: an image, port: a different one"

