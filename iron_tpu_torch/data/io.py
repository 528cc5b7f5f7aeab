"""Image IO without OpenCV (counterpart of iron_tpu/data/io.py).

PNG is read and written here on numpy and zlib.  Read: every colour type
and bit depth of the standard (gray at 1, 2, 4, 8 and 16 bits, palette at
1-8 bits, gray + alpha, RGB and RGBA at 8 and 16), scanline filters 0-4
(none, sub, up, average, Paeth), plain or Adam7-interlaced; the samples
come out as cv2.imread(IMREAD_UNCHANGED) gives them: gray below 8 bits
scaled to 8, a palette expanded to RGB (RGBA when the file has a tRNS
chunk).  Written: 8- and 16-bit gray, gray + alpha, RGB and RGBA.  EXR goes
through the port's own codec (`exr.py`), JPEG through `jpeg.py` (written at
quality 95 as cv2 writes it; baseline and progressive read, arithmetic-coded
files raise).  The float conversion is the JAX package's: alpha dropped,
gray repeated to RGB, 8/16-bit content divided by 255 / 65535, EXR given a
1/2.2 gamma on read.
"""
from __future__ import annotations

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
            raise ValueError(f"PNG: unknown filter type {ftype} on row {y}")
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
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, header, idat, palette, trns = 8, None, [], None, None
    while pos + 8 <= len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"PNG without IHDR: {path}")
    W, H, depth, color, _, _, interlace = header
    if color not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[color] or interlace not in (0, 1):
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type {color}, interlace "
                         f"{interlace} is not a valid PNG")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    C = _PNG_CHANNELS[color]
    bpp = max(1, C * depth // 8)                 # the filters' byte distance
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
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
            raise ValueError(f"{path}: truncated PNG image data")
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


def read_image(path: str, apply_exr_gamma: bool = True) -> np.ndarray:
    """An image as float32 RGB [H, W, 3] in [0, 1] (EXR: linear, with an
    optional 1/2.2 gamma)."""
    if path.endswith(".exr"):
        from iron_tpu_torch.data.exr import read_exr
        img = read_exr(path)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        img = img.astype(np.float32)
        if apply_exr_gamma:
            img = np.power(np.clip(img, 0, None) + 1e-6, 1.0 / 2.2)
        return img
    if path.lower().endswith((".jpg", ".jpeg")):
        from iron_tpu_torch.data.jpeg import read_jpeg
        img = read_jpeg(path)
    elif path.lower().endswith(".png"):
        img = read_png(path)
    else:
        raise ValueError(f"{path}: the port reads PNG, JPEG and EXR images only")
    img = np.repeat(img[..., :1], 3, axis=-1) if img.shape[-1] <= 2 else img[..., :3]
    img = img.astype(np.float32)
    if img.max() > 1.5:  # 8/16-bit content
        img = img / (65535.0 if img.max() > 255.5 else 255.0)
    return img


def write_image(path: str, img: np.ndarray) -> None:
    """Write float [0, 1] or uint8 RGB (.exr: linear float, the port's
    codec; .jpg / .jpeg: baseline JPEG at quality 95; otherwise PNG)."""
    if path.endswith(".exr"):
        from iron_tpu_torch.data.exr import write_exr
        write_exr(path, np.asarray(img, np.float32))
        return
    if img.dtype != np.uint8:
        img = to8b(img)
    if path.lower().endswith((".jpg", ".jpeg")):
        from iron_tpu_torch.data.jpeg import write_jpeg
        write_jpeg(path, img)
        return
    write_png(path, img)
