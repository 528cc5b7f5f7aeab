"""Recover libtiff's LogLuv24 chroma table (uvcode.h's uv_row: for each of
its 163 rows of v, the first u as a float and the count of codes before the
row) from the system's libtiff, and write it where the port's TIFF reader
reads it.

    python scripts/probe_logluv_uv_table.py [--out PATH]

A 24-bit LogLuv pixel holds a 10-bit log luminance and a 14-bit chroma
index into a grid of (u', v') squares 0.0035 wide, row by row of v'.  The
probe writes one raw strip (compression 34677, no coding of its own) that
holds every 14-bit index at one luminance, reads it back as float XYZ
through the system's libtiff (ctypes, TIFFReadEncodedStrip with
SGILOGDATAFMT_FLOAT), and from each pixel's XYZ recovers its (u', v'):
v' names the row, the first index of a row its count, and u' less the
square's offset the row's first u.  Each row's first u is then taken as the
float32 that reproduces every XYZ of that row bit for bit through
LogLuv24toXYZ's double arithmetic, and the whole table is checked against
all 16,384 indices before it is written (JSON: `ustart` as float32 decimal
strings, `ncum`).  Needs the system's libtiff with its SGILog codec.
"""
from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from iron_tpu_torch.data.tiff import UV_SQSIZ, UV_VSTART, logluv24_to_xyz  # noqa: E402

SIDE = 128                       # 128 x 128 = every 14-bit chroma index
LUMA = 768                       # the 10-bit log luminance of every pixel (Y ~ 1)


def _lib():
    lib = ctypes.CDLL(ctypes.util.find_library("tiff"))
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFSetField.restype = ctypes.c_int
    lib.TIFFWriteRawStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p,
                                      ctypes.c_ssize_t]
    lib.TIFFWriteRawStrip.restype = ctypes.c_ssize_t
    lib.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                         ctypes.c_ssize_t]
    lib.TIFFReadEncodedStrip.restype = ctypes.c_ssize_t
    return lib


def libtiff_xyz(codes: np.ndarray) -> np.ndarray:
    """float32 [n, 3]: the system's libtiff's XYZ of 24-bit LogLuv pixels
    `codes` (uint32 [SIDE * SIDE])."""
    lib = _lib()
    fd, path = tempfile.mkstemp(suffix=".tif")
    os.close(fd)
    try:
        t = lib.TIFFOpen(path.encode(), b"w")
        for tag, v in ((256, SIDE), (257, SIDE), (277, 3), (262, 32845), (259, 34677),
                       (284, 1), (278, SIDE)):
            assert lib.TIFFSetField(ctypes.c_void_p(t), ctypes.c_uint32(tag), ctypes.c_int(v))
        assert lib.TIFFSetField(ctypes.c_void_p(t), ctypes.c_uint32(65560), ctypes.c_int(0))
        raw = np.stack([codes >> 16, codes >> 8, codes], -1).astype(np.uint8).tobytes()
        assert lib.TIFFWriteRawStrip(t, 0, raw, len(raw)) == len(raw)
        lib.TIFFClose(t)
        t = lib.TIFFOpen(path.encode(), b"r")
        assert lib.TIFFSetField(ctypes.c_void_p(t), ctypes.c_uint32(65560), ctypes.c_int(0))
        out = np.zeros((SIDE * SIDE, 3), np.float32)
        n = lib.TIFFReadEncodedStrip(t, 0, out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
        lib.TIFFClose(t)
        assert n == out.nbytes, n
        return out
    finally:
        os.remove(path)


def recover(xyz: np.ndarray) -> dict:
    """The table from the XYZ of every chroma index at one luminance."""
    X, Y, Z = (xyz[:, i].astype(np.float64) for i in range(3))
    s = X + Y + Z
    x, y = X / s, Y / s
    den = -2 * x + 12 * y + 3
    u, v = 4 * x / den, 9 * y / den
    row = np.rint((v - UV_VSTART) / UV_SQSIZ - 0.5).astype(np.int64)
    neutral = row[-1]                       # the last indices lie past the grid
    last = int(np.nonzero(row != neutral)[0][-1]) + 1
    starts = [0] + [c for c in range(1, last) if row[c] != row[c - 1]]
    assert [row[c] for c in starts] == list(range(len(starts))), "rows out of order"
    ncum, ustart = [], []
    codes = (LUMA << 14) | np.arange(SIDE * SIDE, dtype=np.uint32)
    for vi, c0 in enumerate(starts):
        c1 = starts[vi + 1] if vi + 1 < len(starts) else last
        ui = np.arange(c1 - c0)
        mean = float(np.mean(u[c0:c1] - (ui + 0.5) * UV_SQSIZ))
        # the float32 nearest the estimate that gives the row's XYZ bit for
        # bit, tried first at the estimate rounded to 6 decimals (the table's
        # printed precision), then out from the estimate
        guess = np.float32(mean)
        below, above, cands = guess, guess, [np.float32(round(mean, 6)), guess]
        for _ in range(4096):
            below = np.nextafter(below, np.float32(-np.inf))
            above = np.nextafter(above, np.float32(np.inf))
            cands += [above, below]
        found = None
        for f in cands:
            table = {"ustart": [np.float32(0)] * vi + [f], "ncum": [0] * vi + [c0]}
            got = logluv24_to_xyz(codes[c0:c1], table)
            if np.array_equal(got.view(np.uint32), xyz[c0:c1].view(np.uint32)):
                found = f
                break
        assert found is not None, f"row {vi}: no float32 first u reproduces libtiff's XYZ"
        ncum.append(int(c0))
        ustart.append(found)
    return {"ustart": ustart, "ncum": ncum, "ndivs": last}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "iron_tpu_torch", "data",
                                                  "logluv24_uv.json"))
    args = ap.parse_args(argv)
    codes = (LUMA << 14) | np.arange(SIDE * SIDE, dtype=np.uint32)
    xyz = libtiff_xyz(codes)
    table = recover(xyz)
    got = logluv24_to_xyz(codes, table)
    assert np.array_equal(got.view(np.uint32), xyz.view(np.uint32)), "the table misses"
    rec = {"source": "libtiff uvcode.h uv_row, recovered by scripts/probe_logluv_uv_table.py",
           "ndivs": table["ndivs"], "ncum": table["ncum"],
           "ustart": [str(f) for f in table["ustart"]]}
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=0)
        f.write("\n")
    print(f"{len(table['ncum'])} rows, {table['ndivs']} chroma indices, every one of the "
          f"{SIDE * SIDE} XYZ bit-equal to libtiff's; wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
