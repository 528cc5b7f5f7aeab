"""Image IO without OpenCV (counterpart of iron_tpu/data/io.py).

PNG is read and written here on numpy and zlib: 8- and 16-bit gray, gray +
alpha, RGB and RGBA, non-interlaced, scanline filters 0-4 (none, sub, up,
average, Paeth).  EXR goes through the port's own codec (`exr.py`), JPEG
through its baseline codec (`jpeg.py`: written at quality 95 as cv2 writes
it; progressive and arithmetic-coded files raise).  The float conversion is
the JAX package's: alpha dropped, gray repeated to RGB, 8/16-bit content
divided by 255 / 65535, EXR given a 1/2.2 gamma on read.  Palette and
interlaced PNGs raise: the port has no decoder for them.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # colour type -> channels
_PNG_COLOR_TYPE = {v: k for k, v in _PNG_CHANNELS.items()}


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


def read_png(path: str) -> np.ndarray:
    """A PNG as [H, W, C] uint8 or uint16 (C = 1 gray, 2 gray + alpha, 3 RGB,
    4 RGBA), channels in the file's order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"PNG without IHDR: {path}")
    W, H, depth, color, _, _, interlace = header
    if depth not in (8, 16) or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type {color}, interlace "
                         f"{interlace}; supported are 8/16-bit gray, gray + alpha, RGB and "
                         f"RGBA, not interlaced")
    C = _PNG_CHANNELS[color]
    bpp = C * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < H * (W * bpp + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    lines = _unfilter(raw[:H * (W * bpp + 1)].reshape(H, W * bpp + 1), bpp)
    if depth == 8:
        return lines.reshape(H, W, C)
    return lines.reshape(H, W * C, 2).copy().view(">u2").reshape(H, W, C).astype(np.uint16)


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
