"""ThunderScan (TIFF compression 32809) as libtiff 4.7's tif_thunder.c
decodes it for OpenCV: 4-bit samples, coded a byte at a time.

The top two bits of a byte are its kind, the low six its data:
  0x00  a run: the last pixel repeated `data` times;
  0x40  three 2-bit deltas on the last pixel, {0, +1, skip, -1};
  0x80  two 3-bit deltas, {0, +1, +2, +3, skip, -3, -2, -1};
  0xC0  one raw pixel, the low four bits.
Pixels are packed two a byte, the first in the high nibble, and wrap
modulo 16.  libtiff decodes a strip one scanline at a time with the image's
width as the row's pixel budget: the last pixel starts at 0 on every row,
and a code left over when a row is full starts the next row (a delta code
that overflows drops its extra pixels without error).  A run that ends past
the row's budget writes nothing, and a strip that runs out of bytes ends
its row there; either way the rest of that row is zeroed from the byte the
decoder stood at (a lone high nibble included), the error ends the strip,
and its later rows keep the zeros of the buffer libtiff's RGBA interface
allocated for it.  libtiff has no tile decoder for ThunderScan.
"""
from __future__ import annotations

from typing import Tuple

_TWO = (0, 1, 0, -1)                            # 2-bit deltas; 2 is the skip
_THREE = (0, 1, 2, 3, 0, -3, -2, -1)            # 3-bit deltas; 4 is the skip


def decode_thunderscan(data: bytes, width: int, rows: int) -> Tuple[bytes, bool]:
    """A strip's `rows` scanlines of `width` 4-bit pixels (rows of
    ceil(width / 2) bytes) decoded from `data` as ThunderDecodeRow does, and
    whether libtiff reported an error (too much or not enough data in a
    row), after which the strip's remaining rows are zeros."""
    row_bytes = (width + 1) // 2
    out = bytearray(rows * row_bytes)
    pos, end = 0, len(data)
    for r in range(rows):
        op = r * row_bytes
        op_end = op + row_bytes
        last = npix = 0

        def put(v):
            """SETPIXEL: the pixel kept as the last one, written while the
            row has room."""
            nonlocal last, npix, op
            last = v & 0xF
            if npix < width:
                if npix & 1:
                    out[op] |= last
                    op += 1
                else:
                    out[op] = last << 4
                npix += 1

        while pos < end and npix < width:
            n = data[pos]
            pos += 1
            kind = n & 0xC0
            if kind == 0x00:                     # a run of n
                if npix & 1:                     # finish the half-filled byte
                    out[op] |= last
                    last = out[op]
                    op += 1
                    npix += 1
                    n -= 1
                else:
                    last |= last << 4
                npix += n
                if npix <= width:
                    while n > 0:
                        out[op] = last
                        op += 1
                        n -= 2
                if n == -1:                      # an odd run: its last byte half
                    op -= 1
                    out[op] &= 0xF0
                last &= 0xF
            elif kind == 0x40:
                for shift in (4, 2, 0):
                    d = (n >> shift) & 3
                    if d != 2:
                        put(last + _TWO[d])
            elif kind == 0x80:
                for shift in (3, 0):
                    d = (n >> shift) & 7
                    if d != 4:
                        put(last + _THREE[d])
            else:
                put(n)
        if npix != width:                        # "Not enough" / "Too much data"
            out[op:op_end] = bytes(max(op_end - op, 0))
            return bytes(out), True
    return bytes(out), False
