"""Image IO without OpenCV (counterpart of iron_tpu/data/io.py).

The JAX package reads every image but EXR through cv2.imread(path,
IMREAD_UNCHANGED), which picks its decoder by the file's first bytes, not
its name.  `read_image` does the same (`decode_image`): PNG (here, on numpy
and zlib: every colour type and bit depth, filters 0-4, Adam7), JPEG
(`jpeg.py`: baseline, progressive, arithmetic-coded, lossless, 1/3/4
components), TIFF (`tiff.py`: classic and BigTIFF; none, PackBits, LZW,
Deflate, JPEG, CCITT (`ccitt.py`) and SGILOG; gray, RGB(A), palette, CMYK,
YCbCr, CIELab, LogLuv; 1- to 64-bit unsigned, signed and float samples,
10 to 14 bits among them), WebP
(`webp.py`: lossy, lossless, alpha, an animation's first frame), BMP,
PBM/PGM/PPM, PAM, PFM, Radiance HDR, Sun raster and GIF (`formats.py`), JPEG 2000 (`jp2.py`: .jp2 boxes and raw
codestreams, EBCOT, the 5/3 and 9/7 wavelets), each bit-equal to OpenCV's
decoder; AVIF, which OpenCV also reads, raises naming the format, as does a
file no OpenCV decoder takes.  EXR is chosen by the name, as in the
JAX package, and goes through the port's own codec (`exr.py`).  Then the
JAX package's float conversion: gray repeated to RGB, a fourth channel
dropped (two channels, PAM's gray + alpha, kept as two, reversed), BGR ->
RGB, and content whose maximum passes 1.5 divided by 255
(or 65535 past 255.5) -- float PFM, HDR and TIFF content and TIFF's 32-
and 64-bit integers too; EXR gets a 1/2.2 gamma.

`write_image` writes what the JAX package's write_image writes through
cv2.imwrite, for every extension OpenCV writes but .jp2 and .avif, an RGBA
array in the JAX package's channel order (all four reversed for OpenCV, so
the file holds G, B, A, R): byte for byte as OpenCV for .jpg / .jpeg /
.jpe (libjpeg's compressor, `jpeg.py`), .bmp / .dib, .pam, .ras / .sr,
.pfm, .hdr / .pic and .pbm / .pgm / .ppm / .pnm (`formats.py`); decoding
to OpenCV's arrays for .png and .tif / .tiff (`tiff.py`), whose
compression OpenCV's encoders choose; the port's own lossless VP8L for
.webp (`webp_enc.py`) and GIF89a for .gif (`formats.py`), held to what
they decode to; .exr through the port's codec.  Where OpenCV writes no
file or one it cannot read, write_image raises and makes no file.
A file OpenCV reads no image from raises `NoImage` (a ValueError) in the
readers, which `cli/preprocess.py` skips as the JAX package skips
cv2.imread's None.

A damaged file reads as cv2.imread reads it from its path.  A JPEG goes
through libjpeg-turbo's recovery as OpenCV's stdio source drives it (a cut
or corrupt scan decodes, the rest of its restart interval from zero
coefficients; `jpeg.py`); every other damage that OpenCV's decoders stop
at -- a cut file, a bad CRC on a critical PNG chunk, a PNG without IEND,
corrupt compressed data, a GIF without its trailer, a truncated JPEG 2000
codestream -- raises NoImage, and what they read past (trailing bytes, a
BMP's file-size field, an 8-bit TIFF strip whose LZW, Deflate or
PackBits data breaks off, which libtiff's RGBA interface reads with zeros
after) gives OpenCV's array (tests/test_torch_damaged.py).  A damaged
header reads as the library under OpenCV reads it: TIFF directories as
libtiff's TIFFReadDirectory, JPEG 2000 boxes and main headers as
OpenJPEG, and BMP, PNM, PAM, PFM, Radiance, Sun raster, GIF and WebP
fields as OpenCV's own readers parse them (tests/test_torch_header.py).
A size past OpenCV's limits raises ImageSizeError (`check_size`, which
each decoder calls before it allocates), where cv2.imread raises and the
JAX package stops.  The few cases where OpenCV's library reads memory no
file holds raise a plain ValueError naming them
(tests/damage_cases.py::UNREPRODUCIBLE); the sweep of
scripts/sweep_damaged.py reads no other case differently.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # colour type -> samples a pixel
_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}            # channels -> colour type written
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


class NoImage(ValueError):
    """A file cv2.imread(IMREAD_UNCHANGED) returns no image for (the JAX
    package then gets None): no format OpenCV reads is recognised in it, it
    is a variant OpenCV refuses, or it is damaged where OpenCV's decoder
    stops, in its data or its header (each class probed against
    cv2.imread).  The port's decoders give one of three outcomes, as
    cv2.imread does: OpenCV's array, NoImage where it gives None, or
    ImageSizeError where it raises cv2.error on a size past its limits.
    Any other ValueError names a variant the port does not read, or a case
    where OpenCV's library reads memory no file holds."""


class ImageSizeError(ValueError):
    """An image whose header gives a size past OpenCV's limits: a side of 0
    or above 2^20 pixels, or more than 2^30 pixels in all
    (CV_IO_MAX_IMAGE_WIDTH / HEIGHT / PIXELS).  cv2.imread asserts them
    after the decoder read the header, outside its try, so it raises
    cv2.error and the JAX package stops on the file; so does the port
    (this is not a NoImage, which `preprocess` would skip)."""


def check_size(width: int, height: int, what: str) -> None:
    """Raise ImageSizeError for a size cv2.imread refuses after the decoder
    read the header (validateInputImageSize): a side not above 0 or above
    2^20, or more than 2^30 pixels.  Decoders call it before they allocate."""
    if width <= 0 or height <= 0:
        raise ImageSizeError(f"{what}: an image of {width} x {height} pixels (OpenCV asserts "
                             f"that both sides are positive: cv2.imread raises)")
    if width > 1 << 20 or height > 1 << 20 or width * height > 1 << 30:
        raise ImageSizeError(f"{what}: an image of {width} x {height} pixels, past OpenCV's "
                             f"limits of 2^20 a side and 2^30 pixels (cv2.imread raises)")


def c_strtol(s: bytes):
    """C's strtol in base 10 on the C string `s` (it ends at a NUL): blanks,
    a sign, the digits -> (value, whether any digit was read, the index
    after the number)."""
    s = s.split(b"\0", 1)[0]
    i = 0
    while i < len(s) and s[i] in b" \t\n\v\f\r":
        i += 1
    sign = 1
    if i < len(s) and s[i] in b"+-":
        sign = -1 if s[i] == ord("-") else 1
        i += 1
    start = i
    while i < len(s) and 48 <= s[i] <= 57:
        i += 1
    return sign * int(s[start:i] or b"0"), i > start, i


def c_int(v: int) -> int:
    """A C long cast to a 32-bit int (two's complement wrap)."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def gamma_correction(image, gamma: float = 2.2):
    return np.power(image + 1e-6, 1.0 / gamma)


def inv_gamma_correction(image, gamma: float = 2.2):
    return np.power(image + 1e-6, gamma)


def _unfilter_sequential(cur: np.ndarray, prior: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Average (3) or Paeth (4) reconstruction of one scanline: each byte
    depends on the reconstructed byte bpp before it, so it runs in order."""
    c, b = cur.tolist(), prior.tolist()
    r = [0] * len(c)
    for i in range(len(c)):
        a = r[i - bpp] if i >= bpp else 0
        if ftype == 3:
            r[i] = (c[i] + ((a + b[i]) >> 1)) & 255
            continue
        up, ul = b[i], (b[i - bpp] if i >= bpp else 0)
        p = a + up - ul
        pa, pb, pc = abs(p - a), abs(p - up), abs(p - ul)
        pred = a if (pa <= pb and pa <= pc) else (up if pb <= pc else ul)
        r[i] = (c[i] + pred) & 255
    return np.asarray(r, np.uint8)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """rows [H, 1 + stride] uint8 (filter byte, filtered scanline) -> the
    reconstructed scanlines [H, stride]."""
    H, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            row = cur
        elif ftype == 1:
            # sub: a running sum per byte of the pixel, modulo 256
            row = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            row = cur + prior
        elif ftype in (3, 4):
            row = _unfilter_sequential(cur, prior, bpp, ftype)
        else:
            raise NoImage(f"PNG: unknown filter type {ftype} on row {y} (libpng stops)")
        out[y] = row
        prior = out[y]
    return out


def _samples(lines: np.ndarray, width: int, C: int, depth: int) -> np.ndarray:
    """Reconstructed scanlines [h, stride] -> samples [h, width, C] (uint8,
    or uint16 at 16 bits; below 8 bits the values as stored)."""
    h = lines.shape[0]
    if depth == 16:
        return lines.reshape(h, -1, 2).copy().view(">u2")[..., 0].astype(
            np.uint16)[:, :width * C].reshape(h, width, C)
    if depth < 8:
        lines = np.unpackbits(lines, axis=1).reshape(h, -1, depth)
        lines = lines.dot(1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return lines[:, :width * C].reshape(h, width, C)


def read_png(path: str) -> np.ndarray:
    """A PNG as [H, W, C] uint8 or uint16 (C = 1 gray, 2 gray + alpha, 3 RGB,
    4 RGBA), channels in the file's order, as cv2.imread(IMREAD_UNCHANGED)
    reads it (gray below 8 bits scaled to 8 bits; a palette expanded to
    RGB, or to RGBA by its tRNS chunk)."""
    with open(path, "rb") as f:
        return read_png_bytes(f.read(), path)


def _png_header_check(header: tuple, path: str) -> None:
    """What png_read_info checks of IHDR before the first IDAT chunk (a
    side of 0 or above libpng's user limit of 1,000,000, a bad depth,
    colour type or interlace: no image), then OpenCV's size limits."""
    W, H, depth, color, _, _, interlace = header
    if not (0 < W <= 1000000 and 0 < H <= 1000000) or color not in _PNG_DEPTHS \
            or depth not in _PNG_DEPTHS[color] or interlace not in (0, 1):
        raise NoImage(f"{path}: a PNG IHDR of {W} x {H} pixels, bit depth {depth}, colour type "
                      f"{color}, interlace {interlace} (libpng stops; OpenCV returns no image)")
    check_size(W, H, path)


def read_png_bytes(data: bytes, path: str = "PNG") -> np.ndarray:
    """`read_png` of the file's bytes (`path` names it in errors).  Damage
    raises NoImage where OpenCV's libpng gives no image: no IEND chunk (a
    cut file), a chunk that runs past the file, a critical chunk that
    fails its CRC or that libpng does not know, a chunk between two IDAT
    chunks, corrupt or short compressed data, an unknown filter type.  An
    ancillary chunk that fails its CRC is dropped (libpng's default), and
    IEND's own CRC is not checked, as OpenCV's reader does not."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, header, idat, palette, trns = 8, None, [], None, None
    after_idat = False
    while True:
        if pos + 8 > len(data):
            raise NoImage(f"{path}: the PNG ends before its IEND chunk (OpenCV returns no image)")
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if n > 0x7FFFFFFF or pos + 12 + n > len(data):
            raise NoImage(f"{path}: a PNG {ctype!r} chunk runs past the end of the file")
        if ctype == b"IEND":
            break
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        critical = not ctype[0] & 0x20
        if zlib.crc32(ctype + body) != struct.unpack(">I", data[pos - 4:pos])[0]:
            if critical:
                raise NoImage(f"{path}: the PNG {ctype!r} chunk fails its CRC (libpng stops)")
            continue                # libpng drops an ancillary chunk with a bad CRC
        if ctype == b"IDAT":
            if not idat and header is not None:
                _png_header_check(header, path)
            if after_idat:
                raise NoImage(f"{path}: a PNG IDAT chunk after another chunk that follows IDAT "
                              f"(libpng stops)")
            idat.append(body)
            continue
        after_idat = bool(idat)
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif critical:
            raise NoImage(f"{path}: an unknown critical PNG chunk {ctype!r} (libpng stops)")
    if header is None:
        raise NoImage(f"{path}: a PNG without IHDR (libpng stops; OpenCV returns no image)")
    W, H, depth, color, _, _, interlace = header
    _png_header_check(header, path)
    if color == 3 and palette is None:
        raise NoImage(f"{path}: a palette PNG without a PLTE chunk (libpng stops; OpenCV "
                      f"returns no image)")
    C = _PNG_CHANNELS[color]
    bpp = max(1, C * depth // 8)                 # the filters' byte distance
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise NoImage(f"{path}: corrupt or cut PNG image data ({e}; libpng stops)") from None
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    dt = np.uint16 if depth == 16 else np.uint8
    out = np.empty((H, W, C), dt)
    o = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue                             # an empty pass has no scanlines
        stride = -(-pw * C * depth // 8)
        if raw.size < o + ph * (stride + 1):
            raise NoImage(f"{path}: not enough PNG image data (libpng stops)")
        lines = _unfilter(raw[o:o + ph * (stride + 1)].reshape(ph, stride + 1), bpp)
        out[y0::dy, x0::dx] = _samples(lines, pw, C, depth)
        o += ph * (stride + 1)
    if color == 3:
        idx = out[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: a palette index beyond the {len(palette)}-entry PLTE")
        rgb = palette[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:min(len(trns), len(palette))] = trns[:len(palette)]
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    if depth < 8:
        out = (out.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return out


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W] or [H, W, C] (C in 1..4) uint8 or uint16 as a PNG (every
    scanline with filter 0)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if img.dtype not in (np.uint8, np.uint16) or C not in _PNG_COLOR_TYPE:
        raise ValueError(f"write_png takes uint8 / uint16 [H, W, 1-4], got {img.dtype} "
                         f"{img.shape}")
    depth = 8 if img.dtype == np.uint8 else 16
    lines = img.astype(">u2").view(np.uint8) if depth == 16 else img
    lines = np.ascontiguousarray(lines).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), lines], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", W, H, depth, _PNG_COLOR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


# leading bytes -> the format, in the order of OpenCV's decoders
# (findDecoder); AVIF, which OpenCV reads and the port does not, is named in
# its error
_BLANK = b" \t\n\v\f\r"


def sniff(data: bytes) -> str:
    """The format OpenCV's findDecoder would pick for a file starting with
    `data`, or "" if none would."""
    if data[:2] == b"BM":
        return "bmp"
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == _PNG_SIGNATURE:
        return "png"
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "tiff"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or data[:4] == b"\xff\x4f\xff\x51":
        return "JPEG 2000"
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis"):
        return "AVIF"
    if len(data) >= 3 and data[:1] == b"P" and data[2] in _BLANK:
        if data[1:2] in b"123456":
            return "pnm"
        if data[1:2] in (b"F", b"f"):
            return "pfm"
        if data[1:2] == b"7":
            return "pam"
    if data.startswith((b"#?RGBE", b"#?RADIANCE")):
        return "hdr"
    if data[:4] == b"\x59\xa6\x6a\x95":
        return "sunras"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    return ""


def decode_image(data: bytes, name: str = "image") -> np.ndarray:
    """Image bytes -> the array cv2.imread(IMREAD_UNCHANGED) gives, with its
    channels in RGB(A) order: uint8 / uint16 / float32, [H, W] or
    [H, W, C]."""
    kind = sniff(data)
    if kind in ("png", "jpeg"):
        if kind == "png":
            img = read_png_bytes(data, name)
        else:
            from iron_tpu_torch.data.jpeg import decode_jpeg
            img = decode_jpeg(data)
        if img.shape[-1] == 2:              # gray + alpha comes out of OpenCV as BGRA
            img = img[..., [0, 0, 0, 1]]
        return img[..., 0] if img.shape[-1] == 1 else img
    if kind == "tiff":
        from iron_tpu_torch.data.tiff import read_tiff
        return read_tiff(data)
    if kind == "webp":
        from iron_tpu_torch.data.webp import decode_webp
        return decode_webp(data)
    if kind == "JPEG 2000":
        from iron_tpu_torch.data.jp2 import decode_jp2
        return decode_jp2(data)
    if kind in ("bmp", "pnm", "pam", "pfm", "hdr", "sunras", "gif"):
        from iron_tpu_torch.data import formats
        return getattr(formats, f"read_{kind}")(data)
    if kind:
        raise ValueError(f"{name}: {kind} content, which the JAX package reads through OpenCV; "
                         f"the port has no {kind} decoder yet")
    raise NoImage(f"{name}: no image format recognised in the first bytes (OpenCV reads no "
                  f"image from it either)")


def read_image(path: str, apply_exr_gamma: bool = True) -> np.ndarray:
    """An image as float32 RGB [H, W, 3] (8/16-bit content in [0, 1]; EXR
    linear, with an optional 1/2.2 gamma), the format told by its content
    (EXR by the name).  A gray + alpha PAM gives [H, W, 2] (alpha, gray),
    as in the JAX package."""
    if path.endswith(".exr"):
        from iron_tpu_torch.data.exr import read_exr
        img = read_exr(path)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        img = img.astype(np.float32)
        if apply_exr_gamma:
            img = np.power(np.clip(img, 0, None) + 1e-6, 1.0 / 2.2)
        return img
    with open(path, "rb") as f:
        img = decode_image(f.read(), path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    elif img.shape[-1] == 2:            # gray + alpha (PAM): reversed, two channels, as in JAX
        img = img[..., ::-1]
    else:
        img = img[..., :3]
    img = img.astype(np.float32)
    if img.max() > 1.5:  # 8/16-bit content
        img = img / (65535.0 if img.max() > 255.5 else 255.0)
    return img


# extension (lower case) -> the writer's format, as cv2.imwrite picks it;
# OpenCV also writes .avif, which the port does not
_WRITERS = {".png": "png", ".jpg": "jpeg", ".jpeg": "jpeg", ".jpe": "jpeg", ".bmp": "bmp",
            ".dib": "bmp", ".tif": "tiff", ".tiff": "tiff", ".pbm": "pbm", ".pgm": "pgm",
            ".ppm": "ppm", ".pnm": "pnm", ".pam": "pam", ".ras": "sunras", ".sr": "sunras",
            ".pfm": "pfm", ".hdr": "hdr", ".pic": "hdr", ".webp": "webp", ".gif": "gif",
            ".jp2": "jp2"}
_NOT_WRITTEN = {".avif": "AVIF"}


def write_image(path: str, img: np.ndarray) -> None:
    """Write float [0, 1] or uint8 RGB(A) (or gray [H, W]) as the JAX
    package's write_image writes it through cv2.imwrite: .exr linear float
    through the port's codec; any other array to 8 bits (to8b), its
    channels reversed for OpenCV, then the format the extension names.
    Since the JAX package reverses all four channels of an RGBA array, the
    file holds (G, B, A, R) as RGBA, or (G, B, A) where the format keeps
    three channels (.jpg).  Extensions: .png, .jpg / .jpeg / .jpe
    (baseline, quality 95), .bmp / .dib, .tif / .tiff (uncompressed), .pbm /
    .pgm (gray) / .ppm (RGB) / .pnm, .pam, .ras / .sr (Sun raster), .pfm,
    .hdr / .pic (Radiance), .webp (lossless), .gif and .jp2 (OpenJPEG's
    bytes at OpenCV's 4:1 rate cut, jp2_enc.py).  .avif and any other
    extension raise, as does an image OpenCV writes no readable file of
    (four channels to .pam, .pfm, .hdr, .ppm; colour to .pgm, .pbm; gray to
    .gif); no file is left behind then.  A .jp2 image with a side under 32
    pixels raises too: OpenCV leaves a 77-byte file it cannot read."""
    if path.endswith(".exr"):
        from iron_tpu_torch.data.exr import write_exr
        write_exr(path, np.asarray(img, np.float32))
        return
    ext = os.path.splitext(path)[1].lower()
    kind = _WRITERS.get(ext)
    if kind is None:
        what = f"{_NOT_WRITTEN[ext]}, which OpenCV writes" if ext in _NOT_WRITTEN else \
            f"'{ext}'"
        raise ValueError(f"{path}: the port writes {', '.join(sorted(_WRITERS))} and .exr images, "
                         f"not {what}")
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to8b(img)
    if img.ndim == 3 and img.shape[2] == 4:
        img = img[..., [1, 2, 3, 0]]        # RGBA reversed, then read by OpenCV as BGRA
    if kind == "png":
        write_png(path, img)
        return
    if kind == "jpeg":
        from iron_tpu_torch.data.jpeg import encode_jpeg as encode
    elif kind == "tiff":
        from iron_tpu_torch.data.tiff import write_tiff as encode
    elif kind == "webp":
        from iron_tpu_torch.data.webp_enc import encode_webp_lossless as encode
    elif kind == "jp2":
        from iron_tpu_torch.data.jp2_enc import encode_jp2 as encode
    elif kind in ("pbm", "pgm", "ppm", "pnm"):
        from iron_tpu_torch.data.formats import write_pnm
        encode = lambda im: write_pnm(im, kind)
    else:
        from iron_tpu_torch.data import formats
        encode = getattr(formats, f"write_{kind}")
    data = encode(img)                      # raises before any file is made
    with open(path, "wb") as f:
        f.write(data)
