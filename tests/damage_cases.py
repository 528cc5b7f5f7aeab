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
  trail  seeded bytes after the end of the file;
  header one byte of its header set to a seeded value: TIFF, in the first
         directory's entries; JPEG 2000, the boxes before `jp2c` and the
         main header up to the first SOT (a raw codestream: from SIZ);
         every other format, the bytes before its coded data.

`outcome` writes the file and reads it with cv2.imread (by its path, as the
JAX package reads it) and with the port's decode_image; `verdict` holds the
port to one of three outcomes: OpenCV's array exactly (a float image by
its bytes, since NaN is not equal to NaN), NoImage where cv2.imread gives
None, or the port's ImageSizeError where cv2.imread raises cv2.error (a
size past OpenCV's limits, which its imread asserts outside its try).
A case the port cannot reproduce, because OpenCV's library reads memory
that no file holds there, raises a ValueError naming it and is listed by
(format, class, seed) in UNREPRODUCIBLE.
"""
from __future__ import annotations

import io
import struct
from typing import Callable, Dict, Tuple

import cv2
import numpy as np

import image_format_writers as W
from iron_tpu_torch.data import io as tio

DAMAGE = ("cut", "byte", "end", "trail", "header")


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
    from iron_tpu_torch.data.tiff import _directory
    t = _directory(d)
    return min(t["offsets"]), max(o + n for o, n in zip(t["offsets"], t["counts"]))


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


def _pil_file(img: np.ndarray, fmt: str, **opts) -> bytes:
    """`img` (BGR, gray or a bool bitmap) written by PIL (its libtiff and
    OpenJPEG)."""
    from PIL import Image
    f = io.BytesIO()
    pil = Image.fromarray(img) if img.ndim == 2 else \
        Image.fromarray(np.ascontiguousarray(img[..., ::-1]))
    pil.save(f, fmt, **opts)
    return f.getvalue()


def _bitmap(seed: int) -> np.ndarray:
    """A bilevel image: the seeded image's blobs."""
    return image(seed, C=1) > 128


def _sgilog(seed: int) -> bytes:
    """LogLuv32 (SGILOG, 34676) from the seeded image's linear RGB as XYZ,
    over decades, written by the system's libtiff without dither."""
    rgb = (image(seed)[..., ::-1].astype(np.float32) / 255) ** 2.2
    m = np.array([[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]], np.float32)
    g = np.random.default_rng(seed)
    xyz = (rgb @ m.T * np.float32(10.0) ** g.uniform(-2, 2, rgb.shape[:2] + (1,))).astype(
        np.float32)
    H, W_ = xyz.shape[:2]
    return W.libtiff_encode([xyz], [(256, W_), (257, H), (277, 3), (262, 32845), (259, 34676),
                                    (65560, 0), (65561, 0), (278, H)])


def _after(token: bytes, count: int = 1):
    """The span from after the `count`-th `token` to the end of the file."""
    def span(d: bytes) -> Tuple[int, int]:
        at = -1
        for _ in range(count):
            at = d.index(token, at + 1)
        return at + len(token), len(d)
    return span


def _hdr_span(d: bytes) -> Tuple[int, int]:
    return d.index(b"\n", d.index(b"-Y ")) + 1, len(d)


def _ras_span(d: bytes) -> Tuple[int, int]:
    return 32 + struct.unpack(">I", d[28:32])[0], len(d)


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
    "bmp gray": (lambda s: _cv2(".bmp", image(s, C=1)), ".bmp", lambda d: (struct.unpack(
        "<I", d[10:14])[0], len(d))),
    "pgm 16-bit": (lambda s: _cv2(".pgm", image(s, C=1).astype(np.uint16) * 257), ".pgm",
                   _after(b"\n", 3)),
    "tiff packbits": (lambda s: _pil_file(image(s), "TIFF", compression="packbits"), ".tif",
                      _tiff_span),
    "tiff jpeg": (lambda s: _pil_file(image(s), "TIFF", compression="jpeg"), ".tif",
                  _tiff_span),
    "tiff g3": (lambda s: _pil_file(_bitmap(s), "TIFF", compression="group3"), ".tif",
                _tiff_span),
    "tiff g4": (lambda s: _pil_file(_bitmap(s), "TIFF", compression="group4"), ".tif",
                _tiff_span),
    "tiff 16-bit": (lambda s: _cv2(".tif", image(s).astype(np.uint16) * 257), ".tif",
                    _tiff_span),
    "tiff float": (lambda s: _cv2(".tif", image(s).astype(np.float32) / 255), ".tif",
                   _tiff_span),
    "tiff sgilog": (_sgilog, ".tif", _tiff_span),
    "pam": (lambda s: _cv2(".pam", image(s)), ".pam", _after(b"ENDHDR\n")),
    "pfm": (lambda s: _cv2(".pfm", image(s).astype(np.float32) / 255), ".pfm",
            _after(b"\n", 3)),
    "hdr": (lambda s: _cv2(".hdr", image(s).astype(np.float32) / 255), ".hdr", _hdr_span),
    "sun raster": (lambda s: _cv2(".ras", image(s)), ".ras", _ras_span),
    "j2k 9/7": (lambda s: _pil_file(image(s), "JPEG2000", no_jp2=True, irreversible=True),
                ".j2k", _jp2_span),
    "jp2 3 layers": (lambda s: _pil_file(image(s), "JPEG2000", quality_mode="rates",
                                         quality_layers=[40, 20, 10]), ".jp2", _jp2_span),
    # the system's OpenJPEG: 5/3 with RCT, every code-block style but HT, one
    # POC (in the tile-part header), two layers
    "jp2 styles": (lambda s: W.openjpeg_encode(image(s)[..., ::-1], mct=1, mode=0x3F,
                                               rates=(8, 1), resolutions=4,
                                               pocs=[(0, 0, 2, 4, 3, "RLCP", 1)]),
                   ".jp2", _jp2_span),
}


def _header_span(name: str, d: bytes) -> Tuple[int, int]:
    """Where the `header` class sets its byte: a TIFF's first directory's
    entries; a JPEG 2000 file's boxes before the codestream and its main
    header up to the first SOT (a raw codestream's from SIZ); the bytes
    before any other format's coded data."""
    if name.startswith("tiff"):
        from iron_tpu_torch.data.tiff import _header
        end, _, off = _header(d)
        return off + 2, off + 2 + 12 * struct.unpack(end + "H", d[off:off + 2])[0]
    if name.startswith(("jp2", "j2k")):
        return (2 if d[:2] == b"\xff\x4f" else 0), d.index(b"\xff\x90")
    return 0, FORMATS[name][2](d)[0]


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
    if kind == "header":
        lo, hi = _header_span(name, d)
        at = int(g.integers(lo, hi))
        return d[:at] + bytes([int(g.integers(0, 256))]) + d[at + 1:]
    if name.startswith(("jpeg", "jp2", "j2k")):
        return d[:-2]                           # EOI / EOC
    if name == "png":
        return d[:-12]                          # the IEND chunk
    if name == "gif":
        return d[:-1]                           # the trailer
    if name.startswith("webp"):
        riff = struct.unpack("<I", d[4:8])[0] + int(g.choice([-1, 1]) * g.integers(1, 17))
        return d[:4] + struct.pack("<I", riff) + d[8:]
    if name.startswith("bmp"):
        return d[:2] + struct.pack("<I", int(g.integers(0, 1 << 32))) + d[6:]
    if name in ("tiff lzw", "tiff deflate"):
        d = _pil_file(image(seed), "TIFF")
        lo, hi = _tiff_span(d)
        return d[:int(g.integers(lo, hi))]
    return d[:-1]                               # the last byte (a TIFF's: of its directory)


def seeded(name: str, kind: str) -> bool:
    """Whether the damage depends on its seed (an end marker dropped does
    not)."""
    return kind != "end" or name.startswith(("webp", "tiff", "bmp"))


def outcome(path: str, data: bytes):
    """(cv2.imread(path, IMREAD_UNCHANGED) with its channels in RGB(A)
    order, or None; the port's decode_image, or the ValueError it
    raised) for `data` written to `path`."""
    with open(path, "wb") as f:
        f.write(data)
    try:
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    except cv2.error as e:                  # imread's size assertion, outside its try
        ref = e
    if isinstance(ref, np.ndarray) and ref.ndim == 3:
        ref = np.ascontiguousarray(ref[..., [2, 1, 0, 3][:ref.shape[2]]])
    try:
        got = tio.decode_image(data, path)
    except ValueError as e:
        got = e
    return ref, got


def verdict(ref, got) -> str:
    """'equal' (OpenCV's array: dtype, shape and bytes), 'refused' (None and
    NoImage), 'too large' (cv2.error and ImageSizeError), or what went
    wrong."""
    if isinstance(ref, cv2.error):
        return "too large" if isinstance(got, tio.ImageSizeError) else \
            f"OpenCV: cv2.error, port: {got!r:.200}"
    if ref is None:
        return "refused" if isinstance(got, tio.NoImage) else f"OpenCV: None, port: {got!r:.200}"
    if isinstance(got, Exception):
        return f"OpenCV: an image, port: {got!r:.200}"
    if got.dtype == ref.dtype and got.shape == ref.shape and got.tobytes() == ref.tobytes():
        return "equal"
    return "OpenCV: an image, port: a different one"


OUTCOMES = ("equal", "refused", "too large")

# (format, class, seed) -> what OpenCV's library reads there from memory no
# file holds; the port raises a ValueError naming it
UNREPRODUCIBLE: Dict[Tuple[str, str, int], str] = {
    # SamplesPerPixel lost: LogLuv of one sample, which libtiff decodes as
    # float XYZ (12 bytes a pixel) into rows sized for 4 bytes a pixel
    ("tiff sgilog", "header", 1): "LogLuv of 1 sample a pixel",
    ("tiff sgilog", "header", 8): "LogLuv of 1 sample a pixel",
    ("tiff sgilog", "header", 199): "LogLuv of 1 sample a pixel",
    # SamplesPerPixel lost from an RGB file of wide samples: libtiff decodes
    # one sample a pixel, OpenCV copies three a pixel from its buffer
    **{(fmt, "header", seed): "without a SamplesPerPixel field"
       for fmt, seeds in (("tiff 16-bit", (64, 103, 151)), ("tiff float", (116, 147)))
       for seed in seeds},
}


def classify(name: str, kind: str, seed: int, ref, got) -> str:
    """The verdict's outcome, 'unreproducible' for a case of UNREPRODUCIBLE
    that the port refuses with a named ValueError, else 'wrong'."""
    v = verdict(ref, got)
    if v in OUTCOMES:
        return v
    if (name, kind, seed) in UNREPRODUCIBLE and type(got) is ValueError:
        return "unreproducible"
    return "wrong"

