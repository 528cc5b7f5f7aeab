"""Minimal self-contained OpenEXR scanline codec, read and write (a copy of
iron_tpu/data/exr.py, pure numpy), from the OpenEXR 2.0 file layout:

  magic 0x762f3101 | version 2 | attribute list | scanline offset table |
  scanline chunks of (y:int32, size:int32, channel-planar pixel data)

Supported: single-part scanline images, HALF/FLOAT channels, compression
NONE (written) and NONE/ZIPS/ZIP (read: the predictor + interleave
reconstruction of the EXR spec).  That covers the files written here, by
pyexr/OpenEXR defaults (ZIP) and by Mitsuba.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_MAGIC = 20000630
_PIXELTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_HALF, _FLOAT = 1, 2
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_NO_COMPRESSION: 1, _ZIPS: 1, _ZIP: 16}


def _write_attr(f, name: bytes, typ: bytes, data: bytes):
    f.write(name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(data)) + data)


def _zip_block(data: bytes) -> bytes:
    """EXR ZIP pre-filter: two-half de-interleave -> delta predictor ->
    deflate (the exact inverse of `_unzip_block`)."""
    n = len(data)
    half = (n + 1) // 2
    t = bytearray(n)
    t[:half] = data[0::2]
    t[half:] = data[1::2]
    d = np.frombuffer(bytes(t), np.uint8).astype(np.int16)
    d[1:] = (d[1:] - d[:-1] + 128) & 0xFF
    return zlib.compress(d.astype(np.uint8).tobytes())


def write_exr(path: str, img: np.ndarray, half: bool = True,
              compression: str = "zips") -> None:
    """Write [H, W, 3(RGB)|1] float image as a scanline EXR
    (compression: 'none' | 'zips')."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    names = [b"Y"] if C == 1 else [b"B", b"G", b"R"]  # alphabetical order
    planes = [img[..., 0]] if C == 1 else [img[..., 2], img[..., 1], img[..., 0]]
    ptype = _HALF if half else _FLOAT
    dt = np.float16 if half else np.float32
    psize = 2 if half else 4
    comp = {"none": _NO_COMPRESSION, "zips": _ZIPS}[compression]

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        chan = b""
        for n in names:
            chan += n + b"\x00" + struct.pack("<iiii", ptype, 0, 1, 1)
        chan += b"\x00"
        _write_attr(f, b"channels", b"chlist", chan)
        _write_attr(f, b"compression", b"compression", struct.pack("B", comp))
        box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
        _write_attr(f, b"dataWindow", b"box2i", box)
        _write_attr(f, b"displayWindow", b"box2i", box)
        _write_attr(f, b"lineOrder", b"lineOrder", struct.pack("B", 0))
        _write_attr(f, b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        _write_attr(f, b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        _write_attr(f, b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        f.write(b"\x00")                       # end of header

        table_pos = f.tell()
        f.write(b"\x00" * 8 * H)               # offset table placeholder
        offsets = []
        for y in range(H):
            offsets.append(f.tell())
            raw = b"".join(np.ascontiguousarray(p[y].astype(dt)).tobytes()
                           for p in planes)
            if comp == _ZIPS:
                z = _zip_block(raw)
                payload = z if len(z) < len(raw) else raw  # spec: smaller wins
            else:
                payload = raw
            f.write(struct.pack("<ii", y, len(payload)))
            f.write(payload)
        end = f.tell()
        f.seek(table_pos)
        f.write(struct.pack(f"<{H}Q", *offsets))
        f.seek(end)


def _read_attrs(f) -> Dict[str, Tuple[bytes, bytes]]:
    attrs = {}
    while True:
        name = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            name += c
        if name == b"":
            return attrs
        typ = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            typ += c
        size, = struct.unpack("<i", f.read(4))
        attrs[name.decode()] = (typ, f.read(size))


def _parse_channels(data: bytes):
    chans = []
    i = 0
    while data[i] != 0:
        j = data.index(b"\x00", i)
        name = data[i:j].decode()
        ptype, _, xs, ys = struct.unpack_from("<iiii", data, j + 1)
        chans.append((name, ptype, xs, ys))
        i = j + 1 + 16
    return chans


def _unzip_block(raw: bytes) -> bytes:
    """EXR ZIP reconstruction: inflate -> undo delta predictor -> undo the
    two-half interleave."""
    d = bytearray(zlib.decompress(raw))
    for i in range(1, len(d)):
        d[i] = (d[i] + d[i - 1] - 128) & 0xFF
    n = len(d)
    half = (n + 1) // 2
    out = bytearray(n)
    out[0::2] = d[:half]
    out[1::2] = d[half:half + n // 2]
    return bytes(out)


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR as float32 [H, W, C] (RGB order when R/G/B
    channels are present; alpha dropped)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"not an EXR file: {path}")
        if version & 0x200:
            raise ValueError("multi-part/deep EXR not supported")
        attrs = _read_attrs(f)
        chans = _parse_channels(attrs["channels"][1])
        comp = attrs["compression"][1][0]
        if comp not in (_NO_COMPRESSION, _ZIPS, _ZIP):
            raise ValueError(f"unsupported EXR compression {comp}")
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
        W, H = x1 - x0 + 1, y1 - y0 + 1
        block_lines = _LINES_PER_BLOCK[comp]
        n_blocks = (H + block_lines - 1) // block_lines
        f.read(8 * n_blocks)                    # offset table (sequential read)

        planes = {name: np.empty((H, W), np.float32) for name, *_ in chans}
        bytes_per_px = {name: (2 if pt == _HALF else 4) for name, pt, *_ in chans}
        line_bytes = sum(W * b for b in bytes_per_px.values())
        for _ in range(n_blocks):
            y, size = struct.unpack("<ii", f.read(8))
            raw = f.read(size)
            lines = min(block_lines, y1 - y + 1)
            expect = line_bytes * lines
            data = raw if (comp == _NO_COMPRESSION or size >= expect) \
                else _unzip_block(raw)
            off = 0
            for ly in range(lines):
                for name, ptype, _, _ in chans:   # channels alphabetical per line
                    nb = W * bytes_per_px[name]
                    arr = np.frombuffer(data[off:off + nb],
                                        _PIXELTYPE[ptype]).astype(np.float32)
                    planes[name][y - y0 + ly] = arr
                    off += nb

    names = [c[0] for c in chans]
    if all(k in names for k in ("R", "G", "B")):
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    if len(names) == 1:
        return planes[names[0]][..., None]
    return np.stack([planes[n] for n in sorted(names)], axis=-1)
