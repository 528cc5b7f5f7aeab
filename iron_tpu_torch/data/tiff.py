"""TIFF on numpy and zlib: the reader of what the JAX package reads through
OpenCV's TIFF decoder (libtiff), and an uncompressed writer.

Read: little- or big-endian files, strips or tiles, chunky or planar
samples, no compression, PackBits, LZW or Deflate, the horizontal
predictor (which libtiff applies with LZW and Deflate only); 8- or 16-bit
samples, 1-4 a pixel (bilevel gray and 1-8-bit palette files too); gray
(min-is-black or min-is-white), RGB and palette images.  The
result is cv2.imread(IMREAD_UNCHANGED)'s, bit for bit, channels in RGB(A)
order.  OpenCV reads an 8-bit file through libtiff's RGBA interface
(TIFFReadRGBAStrip / Tile), so the reader does what that does: gray maps
through its bilevel / gray table, a palette's 16-bit entries shift down 8
bits, an unassociated alpha premultiplies the colour ((c a + 127) / 255),
an RGB file without alpha gets none; one channel for gray (any alpha
dropped), three for RGB and palette, four for RGB with alpha.  A 16-bit
file is read as stored.  Other layouts raise: those OpenCV refuses (2- and
4-bit gray) or misreads (16-bit planar), and those the port has no decoder
for (JPEG and the other compressions, float samples, BigTIFF, 16-bit gray
with alpha or palette).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np

_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i"}     # the integer field types
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8}
_COMPRESSION = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}


def _ifd(data: bytes, end: str) -> Dict[int, List[int]]:
    """The first image file directory: tag -> its values (integers)."""
    (off,) = struct.unpack(end + "I", data[4:8])
    (n,) = struct.unpack(end + "H", data[off:off + 2])
    tags: Dict[int, List[int]] = {}
    for i in range(n):
        e = off + 2 + 12 * i
        tag, typ, count = struct.unpack(end + "HHI", data[e:e + 8])
        size = _SIZES.get(typ, 1) * count
        at = e + 8 if size <= 4 else struct.unpack(end + "I", data[e + 8:e + 12])[0]
        if typ in _TYPES:
            tags[tag] = list(struct.unpack(f"{end}{count}{_TYPES[typ]}", data[at:at + size]))
    return tags


def _lzw(data: bytes, expect: int) -> bytes:
    """TIFF's LZW (codes most significant bit first, 9-12 bits, the width
    growing one code early; 256 clears, 257 ends)."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, prev = 9, None
    acc, nacc, pos, n = 0, 0, 0, len(data)
    while len(out) < expect:
        while nacc < width:
            acc = (acc << 8) | (data[pos] if pos < n else 0)
            nacc += 8
            pos += 1
        if pos > n + 2:
            break
        nacc -= width
        code = (acc >> nacc) & ((1 << width) - 1)
        if code == 256:
            table = table[:258]
            width, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            table.append(prev + entry[:1])
            if len(table) + 1 >= 1 << width and width < 12:
                width += 1
        out += entry
        prev = entry
    return bytes(out)


def _packbits(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i:i + c + 1]
            i += c + 1
        elif c > 128:
            out += data[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def read_tiff(data: bytes) -> np.ndarray:
    """A TIFF (the first image) as cv2.imread(IMREAD_UNCHANGED) reads it:
    uint8 or uint16 [H, W] or [H, W, 3 / 4], channels in RGB(A) order."""
    if data[:4] == b"II*\x00":
        end = "<"
    elif data[:4] == b"MM\x00*":
        end = ">"
    elif data[:4] in (b"II+\x00", b"MM\x00+"):
        raise ValueError("TIFF: BigTIFF files are not read by the port")
    else:
        raise ValueError("not a TIFF file")
    t = _ifd(data, end)
    one = lambda tag, default: t.get(tag, [default])[0]
    W, H = one(256, 0), one(257, 0)
    spp = one(277, 1)
    bps = one(258, 1)
    comp = one(259, 1)
    photo = one(262, 1 if spp < 3 else 2)
    planar = one(284, 1)
    pred = one(317, 1)
    fmt = one(339, 1)
    if comp not in _COMPRESSION:
        raise ValueError(f"TIFF: compression {comp} is not read by the port (none, PackBits, LZW "
                         f"and Deflate are)")
    if fmt != 1 or bps not in (1, 2, 4, 8, 16) or not 1 <= spp <= 4 or pred not in (1, 2) \
            or photo not in (0, 1, 2, 3) or one(266, 1) != 1:
        raise ValueError(f"TIFF: {bps}-bit samples of format {fmt}, {spp} a pixel, photometric "
                         f"{photo}, predictor {pred} are not read by the port")
    if bps < 8 and (spp != 1 or photo not in (0, 1, 3) or (photo != 3 and bps != 1)):
        raise ValueError(f"TIFF: {bps}-bit samples, {spp} a pixel, photometric {photo}: below 8 "
                         f"bits OpenCV reads bilevel and palette files only")
    if bps == 16 and (spp == 2 or photo == 3):
        raise ValueError("TIFF: 16-bit gray with alpha or 16-bit palette files are not read by "
                         "the port")
    if bps == 16 and spp > 1 and one(284, 1) == 2:
        raise ValueError("TIFF: 16-bit planar files are refused: OpenCV misreads them (it takes "
                         "the first plane for interleaved samples)")
    tiled = 322 in t
    if tiled:
        cw, ch = one(322, 0), one(323, 0)
        offsets, counts = t[324], t.get(325)
    else:
        cw, ch = W, min(one(278, 2 ** 32 - 1), H)
        offsets, counts = t[273], t.get(279)
    planes = spp if planar == 2 else 1
    per = spp if planar == 1 else 1                  # samples a pixel within a chunk
    row_bytes = (cw * per * bps + 7) // 8
    across, down = -(-W // cw), -(-H // ch)
    dt = np.dtype(end + "u2") if bps == 16 else np.dtype(np.uint8)
    out = np.zeros((H, W, spp), np.uint16 if bps == 16 else np.uint8)
    for k, off in enumerate(offsets):
        plane, k2 = divmod(k, across * down)
        if plane >= planes:
            break
        cy, cx = divmod(k2, across)
        rows = ch if tiled else min(ch, H - cy * ch)
        want = rows * row_bytes
        raw = data[off:off + counts[k]] if counts else data[off:off + want]
        if comp == 5:
            raw = _lzw(raw, want)
        elif comp in (8, 32946):
            raw = zlib.decompress(raw)
        elif comp == 32773:
            raw = _packbits(raw)
        if len(raw) < want:
            raise ValueError("TIFF: a strip or tile holds less data than its rows need")
        chunk = np.frombuffer(raw[:want], np.uint8).reshape(rows, row_bytes)
        if bps >= 8:
            chunk = chunk.view(dt).reshape(rows, cw, per).astype(out.dtype)
            if pred == 2 and comp != 1 and comp != 32773:
                # horizontal differences, per sample (libtiff applies the
                # predictor in its LZW and Deflate codecs only)
                chunk = np.cumsum(chunk, axis=1, dtype=out.dtype)
        else:
            bits = np.unpackbits(chunk, axis=1).reshape(rows, -1, bps)
            chunk = bits.dot(1 << np.arange(bps - 1, -1, -1))[:, :cw, None].astype(np.uint8)
        y0, x0 = cy * ch, cx * cw
        h, w = min(rows, H - y0), min(cw, W - x0)
        out[y0:y0 + h, x0:x0 + w, plane:plane + per] = chunk[:h, :w]
    if bps == 16:
        return out[..., 0] if spp == 1 else out
    if photo in (0, 1):                              # libtiff's bilevel / gray map
        top = (1 << bps) - 1
        g = out[..., 0].astype(np.int64)
        return ((top - g if photo == 0 else g) * 255 // top).astype(np.uint8)
    if photo == 3:
        cmap = np.asarray(t[320], np.int64).reshape(3, -1)
        if cmap.max() >= 256:                        # 16-bit entries (libtiff's cvtcmap)
            cmap = cmap >> 8
        return cmap.T[out[..., 0]].astype(np.uint8)
    rgb = out[..., :3]
    if spp < 4:
        return np.ascontiguousarray(rgb)
    alpha = out[..., 3:4].astype(np.int64)
    if t.get(338, [0])[0] == 2:                      # unassociated: premultiplied
        rgb = ((rgb.astype(np.int64) * alpha + 127) // 255).astype(np.uint8)
    return np.concatenate([rgb, out[..., 3:4]], -1)


def write_tiff(img: np.ndarray) -> bytes:
    """uint8 or uint16 [H, W] or [H, W, 3] (RGB) as an uncompressed
    little-endian TIFF of one strip: what cv2.imwrite's TIFF decodes to."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    C = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype not in (np.uint8, np.uint16) or C not in (1, 3):
        raise ValueError(f"write_tiff takes uint8 / uint16 [H, W] or [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    H, W = img.shape[:2]
    bps = 8 * img.dtype.itemsize
    pixels = np.ascontiguousarray(img.astype("<u2") if bps == 16 else img).tobytes()
    entries = [(256, 4, [W]), (257, 4, [H]), (258, 3, [bps] * C), (259, 3, [1]),
               (262, 3, [1 if C == 1 else 2]), (273, 4, [0]), (277, 3, [C]), (278, 4, [H]),
               (279, 4, [len(pixels)]), (284, 3, [1])]
    ifd_at = 8
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    extra = b""
    fields = []
    for tag, typ, vals in entries:
        body = struct.pack(f"<{len(vals)}{'H' if typ == 3 else 'I'}", *vals)
        if len(body) <= 4:
            fields.append(struct.pack("<HHI", tag, typ, len(vals)) + body.ljust(4, b"\x00"))
        else:
            fields.append(struct.pack("<HHII", tag, typ, len(vals), extra_at + len(extra)))
            extra += body
    data_at = extra_at + len(extra)
    fields[5] = struct.pack("<HHII", 273, 4, 1, data_at)
    return (b"II*\x00" + struct.pack("<I", ifd_at) + struct.pack("<H", len(entries))
            + b"".join(fields) + b"\x00\x00\x00\x00" + extra + pixels)
