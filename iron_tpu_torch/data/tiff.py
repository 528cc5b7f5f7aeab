"""TIFF on numpy and zlib: the reader of what the JAX package reads through
OpenCV's TIFF decoder (libtiff 4.7), and an uncompressed writer.

The container: little- or big-endian, classic or BigTIFF (8-byte offsets,
20-byte entries, LONG8 / SLONG8 / IFD8 fields), the first image; strips or
tiles, chunky or planar samples, FillOrder 2 (every byte's bits reversed
before the codec, as libtiff reverses them; JPEG ignores it).  Codecs: none,
PackBits, LZW, Deflate, JPEG (`jpeg.py`, each strip or tile its own stream,
JPEGTables spliced in front of an abbreviated one), CCITT modified Huffman,
T.4 (1D and 2D) and T.6 (`ccitt.py`), SGILOG (LogLuv32 runs, 34676, and
LogLuv24, 34677); the horizontal predictor (which libtiff applies with LZW
and Deflate only, to 8- to 64-bit integers) and the floating-point one
(bytes shuffled by significance, differenced).

The result is cv2.imread(IMREAD_UNCHANGED)'s, bit for bit, channels in
RGB(A) order.  OpenCV keeps 16-, 32- and 64-bit gray and RGB(A) samples as
they are stored (uint16 / int16, uint32 / int32 / float32, uint64 / int64 /
float64; min-is-white not inverted), and 10-, 12- and 14-bit ones as
uint16 shifted up to 16 bits (a signed file saturated to int16).  Gray of
3 or 4 samples at 10 to 16 bits is weighed to one channel in OpenCV's
14-bit fixed point (0.299, 0.587, 0.114 of the first three samples, on
their unsigned bits, before the shift); at 32 and 64 bits it is kept.
LogLuv is libtiff's float XYZ (LogLuv32toXYZ / LogLuv24toXYZ in double,
the 24-bit chroma index through uvcode.h's table, recovered from libtiff
into logluv24_uv.json by scripts/probe_logluv_uv_table.py), turned by the
Orientation field, then OpenCV's float32 XYZ -> BGR (`_xyz_to_rgb`).
Everything else -- 8 bits and below, and any file with another
photometric or a sample count other than 1, 3, 4 -- goes through
libtiff's RGBA interface (TIFFReadRGBAStrip / Tile) to 8 bits, and the
reader does what that does:
- gray (min-is-black / -white, bilevel, 16-bit through its high byte) maps
  through the gray table, any alpha dropped: one channel;
- palette: 16-bit entries shifted down 8 bits, three channels;
- RGB: an unassociated alpha premultiplies the colour ((c a + 127) / 255),
  no alpha gives three channels;
- CMYK (8-bit, InkSet CMYK): R = (255 - K)(255 - C) / 255, and so G, B,
  with alpha 255, four channels;
- YCbCr: JPEG-coded, libjpeg's own conversion and upsampling (libtiff sets
  JPEGCOLORMODE_RGB); otherwise the blocks of YCbCrSubsampling (1x1, 1x2,
  2x1, 2x2, 4x1, 4x2, 4x4), each pixel with its block's Cb and Cr, through
  libtiff's fixed-point tables from YCbCrCoefficients and
  ReferenceBlackWhite (TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB);
- CIELab (8 or 16 bits): TIFFCIELab16ToXYZ and TIFFXYZToRGB with libtiff's
  sRGB display and its 1501-entry gamma table, in float32 in libtiff's
  order (the white point D50 unless the file names one).
An 8-bit signed file comes out as int8, the same bytes.  The Orientation
field mirrors (2), turns (3) or flips (4) the image, as OpenCV does.

Raised, naming what was met: what OpenCV refuses (NoImage: 2- and 4-bit
gray, depths other than 1, 8, 10, 12, 14, 16, 32 and 64, 10- to 14-bit
files outside gray and RGB(A) or with the horizontal predictor, 16-bit
palette, CMYK, YCbCr or RGB with two samples, float below 32 bits,
two-sample files above 16 bits, more than 4 samples, photometrics libtiff's
RGBA interface does not know (4, 9, 10, ...), LogL or LogLuv without
SGILOG, SGILOG of other photometrics, LogL in 24 bits, planar LogLuv,
old-style JPEG, LZMA and ZSTD, for which its libtiff is not built, the
floating-point predictor on integers, the orientations that swap the
axes, a broken SGILOG strip), what it misreads (planar files above 8
bits, taken as chunky; the word-aligned CCITT variant, 32771; 8-bit tiles
mirrored or turned; LogL, whose 8-bit gray it types int8), and what the
port has no decoder for (NeXT, ThunderScan and PixarLog, 12-bit JPEG,
LogLuv of other than 3 samples).

A damaged file reads as cv2.imread reads it.  The directory is read as
libtiff 4.7's TIFFReadDirectory reads it (`_directory`): each field
through TIFFReadDirEntry's type, count and range rules, a repeated tag
ignored; an error in a field it needs (SamplesPerPixel, Compression, the
dimensions, RowsPerStrip 0, PlanarConfiguration, ExtraSamples, the
per-sample fields, the strip arrays) fails it, any other field is dropped;
the strips counted from ImageLength and RowsPerStrip, their offsets and
byte counts padded with zeros to that count, StripByteCounts estimated
where it is missing or, for a single strip, looks bad (an uncompressed one
short of its rows among them), a single uncompressed strip chopped into
strips of about 8 KB; a zero scanline or strip fails it.  Then OpenCV's
checks (a Photometric field, the depths it reads, its size limits through
io.check_size, strips or tiles of at most 2^24 a side and under 1 GB),
then each strip as libtiff's TIFFFillStrip takes it (no bytes, or bytes
past the end of the file, give no image) and decodes it: a strip whose
LZW, Deflate or PackBits data breaks off decodes as libtiff decodes it
(its bytes up to the error, zeros after, the predictor not applied),
which OpenCV keeps through the RGBA interface and refuses for the samples
it reads itself; a compression libtiff does not know decodes to zeros
there.  A cut header or directory gives no image.  One case reads memory
no file holds and raises naming it: wide RGB samples without a
SamplesPerPixel field, or LogLuv of one sample (OpenCV copies more
samples a pixel than libtiff decoded).
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from iron_tpu_torch.data.ccitt import BIT_REVERSED, decode_ccitt
from iron_tpu_torch.data.io import NoImage, check_size

# field type -> struct code (integers and floats); 5 / 10 (rationals) are
# read as libtiff reads them into float fields, 2 / 7 (ASCII, UNDEFINED) as
# bytes
_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d", 13: "I", 16: "Q",
          17: "q", 18: "Q"}
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
          16: 8, 17: 8, 18: 8}
_COMPRESSION = {1: "none", 2: "CCITT modified Huffman", 3: "CCITT T.4", 4: "CCITT T.6",
                5: "LZW", 7: "JPEG", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_REFUSED = {6: "old-style JPEG (compression 6), which OpenCV returns no image for",
            32771: "the word-aligned CCITT coding (32771), which OpenCV's libtiff misreads",
            34925: "LZMA compression, which OpenCV's libtiff is built without",
            50000: "ZSTD compression, which OpenCV's libtiff is built without"}
# YCbCrSubsampling (horizontal, vertical) libtiff's RGBA interface reads
_SUBSAMPLING = {(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)}
_F = np.float32


def _header(data: bytes):
    """(byte order, BigTIFF?, offset of the first IFD)."""
    if len(data) < (16 if data[2:4] in (b"+\x00", b"\x00+") else 8):
        raise NoImage("TIFF: the file ends in its header (OpenCV returns no image)")
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        end = "<" if data[:1] == b"I" else ">"
        return end, False, struct.unpack(end + "I", data[4:8])[0]
    if data[:4] in (b"II+\x00", b"MM\x00+"):
        end = "<" if data[:1] == b"I" else ">"
        size, _, off = struct.unpack(end + "HHQ", data[4:16])
        if size != 8:
            raise ValueError(f"TIFF: BigTIFF with {size}-byte offsets")
        return end, True, off
    raise ValueError("not a TIFF file")


class _Bad(Exception):
    """A TIFFReadDirEntry error: the field is not read."""


# field types libtiff's integer readers take, with struct codes
_INTS = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I", 16: "Q", 17: "q", 18: "Q"}
# the tags TIFFReadDirectory reads with no recovery: an error in one of them
# fails the directory (its first and second passes)
_FIRST_PASS = (256, 257, 32997, 322, 323, 32998, 284, 278, 338)
_PER_SAMPLE = (280, 281, 258, 32996, 339)
# codec-specific tags (_TIFFCheckFieldIsValidForCodec) -> the codecs they
# are read with
_CODEC_TAGS = {317: (5, 8, 32946, 32909), 347: (7,), 292: (3,), 293: (4,)}
# the codecs OpenCV's libtiff is built with; any other known one is
# NotConfigured (no image), an unknown one decodes nothing
_CONFIGURED = (1, 2, 3, 4, 5, 6, 7, 8, 32766, 32771, 32773, 32809, 32909, 32946, 34676, 34677)
_NOT_CONFIGURED = (34661, 34712, 34887, 34925, 50000, 50001, 50002)


class _Dir:
    """The raw entries of a directory and TIFFReadDirEntry's readers."""

    def __init__(self, data: bytes, end: str, big: bool, entries):
        self.data, self.end, self.big, self.entries = data, end, big, entries

    def values(self, e, kinds=_INTS, limit=None) -> list:
        """The entry's values as numbers (TIFFReadDirEntryArray): an
        unknown type, a count past 2 GB of data or data past the end of
        the file is an error."""
        tag, typ, count, raw = e
        size = _SIZES.get(typ, 0)
        if typ not in kinds or not size:
            raise _Bad
        n = count if limit is None else min(count, limit)
        if not n:
            return []
        if n * size > 2 ** 31 - 1:
            raise _Bad
        inline = 8 if self.big else 4
        if count * size <= inline:
            body = raw[:n * size]
        else:
            at = struct.unpack(self.end + ("Q" if self.big else "I"), raw)[0]
            if at + n * size > len(self.data):
                raise _Bad
            body = self.data[at:at + n * size]
        if typ in (5, 10):
            v = struct.unpack(f"{self.end}{2 * n}{'I' if typ == 5 else 'i'}", body)
            return [float(_F(v[k]) / _F(v[k + 1])) if v[k + 1] else 0.0
                    for k in range(0, 2 * n, 2)]
        if typ in (2, 7):
            return list(body)
        return list(struct.unpack(f"{self.end}{n}{_TYPES[typ]}", body))

    def ints(self, e, top: int, one: bool = False, limit=None) -> list:
        """TIFFReadDirEntryShort / Long (`one`: a count of 1) or their
        arrays: integer types, every value in [0, top]."""
        if one and e[2] != 1:
            raise _Bad
        v = self.values(e, limit=limit)
        if any(not 0 <= x <= top for x in v):
            raise _Bad
        return v

    def per_sample(self, e, spp: int) -> int:
        """TIFFReadDirEntryShort, else TIFFReadDirEntryPersampleShort: one
        value, or at least `spp` of which the first `spp` agree."""
        if e[2] == 1:
            return self.ints(e, 0xFFFF, True)[0]
        if e[2] < spp:
            raise _Bad
        v = self.ints(e, 0xFFFF)
        if len(set(v[:spp])) > 1:
            raise _Bad
        return v[0]


def _entries(data: bytes, end: str, big: bool, off: int):
    """TIFFFetchDirectory on a mapped file: the entries (tag, type, count,
    the raw value or offset bytes) of the directory at `off`; more than
    4096 entries, or a count or entries past the end of the file, fail it."""
    count_fmt, entry, inline = ("Q", 20, 8) if big else ("H", 12, 4)
    first = off + struct.calcsize(count_fmt)
    if off == 0 or first > len(data):
        raise NoImage("TIFF: the first directory lies past the end of the file (libtiff stops; "
                      "OpenCV returns no image)")
    (n,) = struct.unpack(end + count_fmt, data[off:first])
    if n > 4096:
        raise NoImage(f"TIFF: a directory of {n} entries (libtiff's sanity check fails; OpenCV "
                      f"returns no image)")
    if first + entry * n > len(data):
        raise NoImage("TIFF: the directory runs past the end of the file (libtiff stops; "
                      "OpenCV returns no image)")
    fmt = end + ("HHQ" if big else "HHI")
    out = []
    for i in range(n):
        e = first + entry * i
        tag, typ, count = struct.unpack(fmt, data[e:e + entry - inline])
        out.append((tag, typ, count, data[e + entry - inline:e + entry]))
    return out


def _howmany(x: int, y: int) -> int:
    """TIFFhowmany_32: ceil(x / y), 0 where x + y - 1 overflows 32 bits."""
    return (x + y - 1) // y if x < 0xFFFFFFFF - (y - 1) else 0


def _directory(data: bytes) -> Dict[object, object]:
    """TIFFReadDirectory on the first directory, as libtiff 4.7 reads it
    for OpenCV (a mapped file): tag -> its values as libtiff keeps them
    (the fields it set; a field it could not read or that failed its check
    is left out, a codec-specific one under another codec too), and
    "offsets", "counts" (the strips or tiles, padded with zeros to their
    number, StripByteCounts estimated where libtiff estimates it, a single
    uncompressed strip chopped), "rps" (rows a strip), "tiled".  Where
    libtiff fails the directory, NoImage."""
    end, big, off = _header(data)
    d = _Dir(data, end, big, _entries(data, end, big, off))
    first = {}
    for e in d.entries:                              # a repeated tag is ignored
        first.setdefault(e[0], e)
    t: Dict[object, object] = {}

    def bad(what: str):
        return NoImage(f"TIFF: {what} (libtiff fails the directory; OpenCV returns no image)")

    spp = 1
    if 277 in first:
        try:
            spp = d.ints(first[277], 0xFFFF, True)[0]
        except _Bad:
            raise bad("SamplesPerPixel is not readable") from None
        if spp == 0:
            raise bad("SamplesPerPixel 0")
        t[277] = [spp]
    comp = 1
    if 259 in first:
        try:
            comp = d.per_sample(first[259], spp)
        except _Bad:
            raise bad("Compression is not readable") from None
    t[259] = [comp]
    for e in d.entries:
        tag = e[0]
        if first[tag] is not e or tag not in _FIRST_PASS:
            continue
        try:
            if tag == 284:
                v = d.ints(e, 0xFFFF, True)
                if v[0] not in (1, 2):
                    raise _Bad
            elif tag == 338:
                v = d.ints(e, 0xFFFF)
                if len(v) > spp or any(x > 2 and x != 999 for x in v):
                    raise _Bad
                v = [1 if x == 999 else x for x in v]
            else:
                v = d.ints(e, 0xFFFFFFFF, True)
                if tag == 278 and v[0] == 0:
                    raise _Bad
        except _Bad:
            raise bad(f"field {tag} is not readable or not valid") from None
        t[tag] = v
    if 256 not in t and 257 not in t:
        raise bad("no ImageWidth or ImageLength")
    W, H = t.get(256, [0])[0], t.get(257, [0])[0]
    planar = t.get(284, [1])[0]
    tiled = 322 in t or 323 in t
    rps = t.get(278, [0xFFFFFFFF])[0]
    if not tiled:
        nstrips = 1 if rps == 0xFFFFFFFF else _howmany(H, rps)
        cw, ch = W, rps
    else:
        cw, ch = t.get(322, [0])[0], t.get(323, [0])[0]
        depth = t.get(32997, [1])[0]
        nstrips = 0 if not (cw and ch) else \
            (_howmany(W, cw) if W else 0) * (_howmany(H, ch) if H else 0) * \
            (_howmany(depth, t.get(32998, [1])[0]) if depth else 0)
    if planar == 2:
        nstrips *= spp
    if not 0 < nstrips < 1 << 32:
        raise bad(f"no {'tiles' if tiled else 'strips'}")
    offsets_e = counts_e = None
    for e in d.entries:                              # the last of strips' and tiles' wins
        if first[e[0]] is e and e[0] in (273, 324):
            offsets_e = e
        if first[e[0]] is e and e[0] in (279, 325):
            counts_e = e
    if offsets_e is None:
        raise bad("no StripOffsets or TileOffsets")
    bps_read = False
    for e in d.entries:
        tag = e[0]
        if first[tag] is not e or tag in _FIRST_PASS or tag in (259, 277, 273, 279, 324, 325):
            continue
        if tag in _PER_SAMPLE:
            try:
                v = d.per_sample(e, spp)
            except _Bad:
                raise bad(f"field {tag} is not readable") from None
            if tag == 339 and not 1 <= v <= 6:
                raise bad(f"SampleFormat {v}")
            if tag == 32996:                         # DataType, as a SampleFormat
                if v not in (0, 1, 2, 3):
                    raise bad(f"DataType {v}")
                tag, v = 339, {0: 4, 1: 2, 2: 1, 3: 3}[v]
            t[tag] = [v]
            bps_read |= tag == 258
            continue
        if tag in (340, 341):
            try:
                if e[2] != spp:
                    raise _Bad
                d.values(e, kinds=tuple(_SIZES))
            except _Bad:
                raise bad(f"field {tag} is not readable") from None
            continue
        if tag in _CODEC_TAGS and comp not in _CODEC_TAGS[tag]:
            continue
        try:
            if tag == 320:                           # ColorMap, once BitsPerSample is read
                b = t.get(258, [1])[0]
                if not bps_read or b > 24 or e[2] != 3 << b:
                    continue
                t[tag] = d.ints(e, 0xFFFF)
            elif tag in (262, 266, 274, 317, 332):
                v = d.ints(e, 0xFFFF, True)
                if (tag == 266 and v[0] not in (1, 2)) or (tag == 274 and not 1 <= v[0] <= 8):
                    continue
                t[tag] = v
            elif tag == 292:
                t[tag] = d.ints(e, 0xFFFFFFFF, True)
            elif tag in (530, 529, 532, 318):        # counts 2, 3, 6, 2
                if e[2] != {530: 2, 529: 3, 532: 6, 318: 2}[tag]:
                    continue
                t[tag] = d.ints(e, 0xFFFF) if tag == 530 else \
                    d.values(e, kinds=(1, 3, 4, 5, 6, 8, 9, 10, 11, 12, 16, 17))
            elif tag == 347:
                t[tag] = bytes(d.values(e, kinds=(2, 7)) if e[1] in (2, 7) else d.ints(e, 255))
        except _Bad:
            continue
    photo = t.get(262, [0])[0]
    bps = t.get(258, [1])[0]
    # non-colour channels become extra samples
    colour = {0: 1, 1: 1, 3: 1, 4: 1, 32844: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3,
              32845: 3, 5: 4}.get(photo, 0)
    extra = list(t.get(338, []))
    if colour and spp - len(extra) > colour:
        extra = extra + [0] * (spp - colour - len(extra))
    if extra:
        t[338] = extra
    if photo == 3 and 320 not in t:                  # a palette without its map
        if bps >= 8:
            t[262] = [2 if spp == 3 else 1]
        else:
            raise bad("a palette image without a ColorMap")
    try:
        offsets = d.ints(offsets_e, 2 ** 63 - 1, limit=nstrips)
        counts = d.ints(counts_e, 2 ** 63 - 1, limit=nstrips) if counts_e else None
    except _Bad:
        raise bad("the strip or tile offsets or byte counts are not readable") from None
    if nstrips > len(offsets) and nstrips > 1000000:
        raise bad("too many strips")
    offsets += [0] * (nstrips - len(offsets))
    if counts is not None:
        counts += [0] * (nstrips - len(counts))
    scan = _scanline_size(W, spp if planar == 1 else 1, bps, photo, comp, t)
    def estimate():
        """EstimateStripByteCounts."""
        if comp != 1:
            space = (16 + 8 + 20 * len(d.entries) + 8) if big else (8 + 2 + 12 * len(d.entries) + 4)
            for e in d.entries:
                w = _SIZES.get(e[1], 0)
                if not w:
                    raise bad(f"an entry of unknown type {e[1]}")
                size = w * e[2]
                space += size if size > (8 if big else 4) else 0
            space = len(data) if len(data) < space else len(data) - space
            if planar == 2:
                space //= spp
            est = [space] * nstrips
            if offsets[-1] + est[-1] > len(data):
                est[-1] = 0 if offsets[-1] >= len(data) else len(data) - offsets[-1]
            return est
        if tiled:
            return [_tile_size(cw, ch, spp if planar == 1 else 1, bps, photo, comp, t)] * nstrips
        per_plane = nstrips // spp if planar == 2 else nstrips
        return [scan * (H // per_plane)] * nstrips
    if counts is None:
        if (planar == 1 and nstrips > 1) or (planar == 2 and nstrips != spp):
            raise bad("no StripByteCounts")
        counts = estimate()
        if 278 not in t:
            rps = H
    elif nstrips == 1 and not tiled and (
            (counts[0] == 0 and offsets[0] != 0) or
            (comp == 1 and (offsets[0] > (len(data) - counts[0]) % 2 ** 64 or
                            counts[0] > (len(data) - offsets[0]) % 2 ** 64)) or
            (comp == 1 and counts[0] < scan * H)):
        counts = estimate()                          # BYTECOUNTLOOKSBAD
        if 278 not in t:
            rps = H
    elif planar == 1 and nstrips > 2 and comp == 1 and counts[0] != counts[1] and \
            counts[0] and counts[1]:
        counts = estimate()
        if 278 not in t:
            rps = H
    if planar == 1 and nstrips == 1 and comp == 1 and not tiled:
        # ChopUpSingleUncompressedStrip: strips of about 8 KB
        block = 1 if photo != 6 else t.get(530, [2, 2])[1]
        block_bytes = _strip_size(block, W, spp, bps, photo, comp, t)
        if block_bytes > 8192:
            chop_rows, chop_bytes = block, block_bytes
        elif block_bytes > 0:
            chop_rows, chop_bytes = 8192 // block_bytes * block, 8192 // block_bytes * block_bytes
        else:
            chop_rows = 0
        if 0 < chop_rows < rps:
            n = _howmany(H, chop_rows)
            if n and not (n > 1000000 and (offsets[0] >= len(data) or
                                           chop_bytes > (len(data) - offsets[0]) // (n - 1))):
                left, at = counts[0], offsets[0]
                offsets, counts = [], []
                for _ in range(n):
                    take = min(chop_bytes, left)
                    counts.append(take)
                    offsets.append(at if take else 0)
                    at, left = at + take, left - take
                rps, nstrips = chop_rows, n
                t[278] = [rps]
    if not scan:
        raise bad("a scanline of 0 bytes")
    if (_tile_size(cw, ch, spp if planar == 1 else 1, bps, photo, comp, t) if tiled else
            _strip_size(min(rps, H), W, spp if planar == 1 else 1, bps, photo, comp, t)) == 0:
        raise bad(f"a {'tile' if tiled else 'strip'} of 0 bytes")
    t.update(offsets=offsets, counts=counts, rps=rps, tiled=tiled, nstrips=nstrips)
    return t


def _ycbcr_block(photo: int, comp: int, spp: int, t) -> Optional[Tuple[int, int]]:
    """The YCbCr sampling block of a chunky file libtiff sizes by blocks
    (not JPEG, which libtiff up-samples), or None."""
    if photo != 6 or spp != 3 or comp == 7:
        return None
    return tuple(t.get(530, [2, 2])[:2])


def _scanline_size(W: int, per: int, bps: int, photo: int, comp: int, t) -> int:
    """TIFFScanlineSize64 (0 where libtiff refuses the subsampling)."""
    blk = _ycbcr_block(photo, comp, per, t)
    if blk:
        if blk[0] not in (1, 2, 4) or blk[1] not in (1, 2, 4):
            return 0
        return ((-(-W // blk[0]) * (blk[0] * blk[1] + 2) * bps + 7) // 8) // blk[1]
    return (W * per * bps + 7) // 8


def _strip_size(rows: int, W: int, per: int, bps: int, photo: int, comp: int, t) -> int:
    """TIFFVStripSize64 of `rows` rows."""
    blk = _ycbcr_block(photo, comp, per, t)
    if blk:
        if blk[0] not in (1, 2, 4) or blk[1] not in (1, 2, 4):
            return 0
        return ((-(-W // blk[0]) * -(-rows // blk[1]) * (blk[0] * blk[1] + 2) * bps + 7) // 8)
    return rows * _scanline_size(W, per, bps, photo, comp, t)


def _tile_size(cw: int, ch: int, per: int, bps: int, photo: int, comp: int, t) -> int:
    """TIFFTileSize64."""
    return _strip_size(ch, cw, per, bps, photo, comp, t)


def _lzw(data: bytes, expect: int) -> Tuple[bytes, bool]:
    """TIFF's LZW as libtiff 4.7 decodes a strip or tile (tif_lzw.c
    LZWDecode): codes most significant bit first, 9-12 bits, the width
    growing one code early, 256 clears, 257 ends, a chunk opening with a
    clear; past 5119 entries (its table's size) any code but a clear or the
    end is an error.  -> (`expect` bytes, whether libtiff reports an
    error): a code not yet in the table or data that ends before the end
    code stop it, and an end code before `expect` bytes is an error too;
    the bytes not decoded are zeros, as libtiff leaves them."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise ValueError("TIFF: old-style LZW (libtiff's LZWDecodeCompat) is not read by the "
                         "port")
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    free, width, old, cleared = -1, 9, 0, False   # no free entry until a clear
    acc, nacc, pos, n = 0, 0, 0, len(data)
    failed = True
    while len(out) < expect:
        while nacc < width and pos < n:
            acc = ((acc << 8) | data[pos]) & 0xFFFFFF
            nacc += 8
            pos += 1
        if nacc < width:
            break                           # the data ends with no end code
        nacc -= width
        code = (acc >> nacc) & ((1 << width) - 1)
        if code == 257:
            failed = len(out) < expect
            break
        if code == 256:
            del table[258:]
            free, width, cleared = 258, 9, True
            continue
        if cleared:                         # the first code after a clear adds no entry
            if code > 257:
                break
            out.append(code)
            old, cleared = code, False
            continue
        if free < 0 or code > free:
            break                           # a code not yet in the table
        s = table[code] if code < free else table[old] + table[old][:1]
        table.append(table[old] + s[:1])
        free += 1
        if free > (1 << width) - 2:
            width = min(width + 1, 12)
            if free >= 5119:
                free = -1
        old = code
        out += s
    else:
        failed = False
    if len(out) >= expect:
        return bytes(out[:expect]), False
    return bytes(out) + bytes(expect - len(out)), failed


def _inflate(data: bytes, expect: int, rgba: bool) -> Tuple[bytes, bool]:
    """Deflate as libtiff's ZIPDecode inflates a strip or tile: it stops
    once `expect` bytes are out (a bad checksum after them goes unseen).
    -> (`expect` bytes, whether zlib stopped with an error or the data
    ended first: the bytes inflated before, then zeros).  Corrupt data
    gives no image where OpenCV reads the samples themselves."""
    try:
        out = zlib.decompressobj().decompress(data, expect)
    except zlib.error:
        if not rgba:
            raise NoImage("TIFF: corrupt Deflate data (libtiff stops; OpenCV returns no "
                          "image)") from None
        # a capped zlib call that meets the error drops its output: the
        # bytes inflate wrote before it stopped come from `_inflate_to_error`
        out = _inflate_to_error(data)[:expect]
        return out + bytes(expect - len(out)), True
    return out + bytes(expect - len(out)), len(out) < expect


def _code_bases(first: int, count: int, pair_from: int, per: int):
    """RFC 1951's (base, extra bits) of `count` length or distance codes:
    the extra bits grow by one every `per` codes from code `pair_from`."""
    out, base = [], first
    for i in range(count):
        extra = max(0, (i - pair_from) // per)
        out.append((base, extra))
        base += 1 << extra
    return out


_LENGTHS = _code_bases(3, 28, 4, 4) + [(258, 0)]     # codes 257-285
_DISTANCES = _code_bases(1, 30, 2, 2)                  # codes 0-29
_CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


class _InflateStop(Exception):
    """Where zlib's inflate stops: corrupt data, or no more input."""


def _huffman(lengths, kind: str) -> Dict[Tuple[int, int], int]:
    """(length, code) -> symbol of a canonical code, checked as zlib's
    inflate_table checks it: an over-subscribed code stops it, so does an
    incomplete one but a single 1-bit length or distance code; no code at
    all is a table in which every code is invalid."""
    count = [0] * 16
    for n in lengths:
        count[n] += 1
    count[0] = 0
    longest = max((n for n in range(1, 16) if count[n]), default=0)
    if not longest:
        return {}
    left = 1
    for n in range(1, 16):
        left = 2 * left - count[n]
        if left < 0:
            raise _InflateStop
    if left > 0 and (kind == "codes" or longest != 1):
        raise _InflateStop
    codes, code = {}, 0
    for n in range(1, 16):
        for sym, ln in enumerate(lengths):
            if ln == n:
                codes[(n, code)] = sym
                code += 1
        code <<= 1
    return codes


def _inflate_to_error(data: bytes) -> bytes:
    """The bytes zlib's inflate writes from a zlib stream before it stops
    at corrupt data (RFC 1950 / 1951 with zlib's checks: the header, block
    type 3, stored lengths, too many length or distance codes, bad code
    sets, a bad repeat, no end-of-block code, codes 286-287 and 30-31, a
    distance past the output) or at the end of the data."""
    out = bytearray()
    pos, n = 0, 8 * len(data)

    def bits(k: int) -> int:
        nonlocal pos
        if pos + k > n:
            raise _InflateStop
        v = 0
        for i in range(k):
            v |= ((data[(pos + i) >> 3] >> ((pos + i) & 7)) & 1) << i
        pos += k
        return v

    def symbol(codes) -> int:
        code = 0
        for length in range(1, 16):
            code = (code << 1) | bits(1)
            if (length, code) in codes:
                return codes[(length, code)]
        raise _InflateStop                  # (only a table with no codes gets here)

    try:
        cmf, flg = bits(8), bits(8)
        if ((cmf << 8) | flg) % 31 or cmf & 15 != 8 or cmf >> 4 > 7 or flg & 0x20:
            return b""
        final = 0
        while not final:
            final, kind = bits(1), bits(2)
            if kind == 3:
                break
            if kind == 0:
                pos = (pos + 7) & ~7
                size, check = bits(16), bits(16)
                if size != check ^ 0xFFFF:
                    break
                for _ in range(size):
                    out.append(bits(8))
                continue
            if kind == 1:
                lit = _huffman([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, "lens")
                dist = _huffman([5] * 30, "dists")
            else:
                nlen, ndist, ncode = bits(5) + 257, bits(5) + 1, bits(4) + 4
                if nlen > 286 or ndist > 30:
                    break
                cl = [0] * 19
                for i in range(ncode):
                    cl[_CL_ORDER[i]] = bits(3)
                clc = _huffman(cl, "codes")
                lens = []
                while len(lens) < nlen + ndist:
                    sym = symbol(clc)
                    if sym < 16:
                        lens.append(sym)
                        continue
                    if sym == 16 and not lens:
                        raise _InflateStop
                    value, count = (lens[-1], 3 + bits(2)) if sym == 16 else \
                        (0, 3 + bits(3)) if sym == 17 else (0, 11 + bits(7))
                    if len(lens) + count > nlen + ndist:
                        raise _InflateStop
                    lens += [value] * count
                if not lens[256]:
                    break
                lit = _huffman(lens[:nlen], "lens")
                dist = _huffman(lens[nlen:], "dists")
            while True:
                sym = symbol(lit)
                if sym < 256:
                    out.append(sym)
                    continue
                if sym == 256:
                    break
                if sym > 285:
                    raise _InflateStop
                base, extra = _LENGTHS[sym - 257]
                length = base + bits(extra)
                d = symbol(dist)
                if d > 29:
                    raise _InflateStop
                base, extra = _DISTANCES[d]
                d = base + bits(extra)
                if d > len(out):
                    raise _InflateStop
                for _ in range(length):
                    out.append(out[-d])
    except _InflateStop:
        pass
    return bytes(out)


def _packbits(data: bytes, expect: int) -> Tuple[bytes, bool]:
    """PackBits as libtiff decodes a strip or tile (PackBitsDecode): runs
    and literals cut at `expect` bytes, 128 a no-op.  -> (`expect` bytes,
    whether the data ended first: the rest zeros, as libtiff leaves it)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n and len(out) < expect:
        c = data[i]
        i += 1
        if c > 128:
            if i >= n:
                break
            out += data[i:i + 1] * min(257 - c, expect - len(out))
            i += 1
        elif c < 128:
            take = min(c + 1, expect - len(out))
            if n - i < take:
                break
            out += data[i:i + take]
            i += take
    return bytes(out) + bytes(expect - len(out)), len(out) < expect


def _sgilog(data: bytes, rows: int, cw: int, comp: int) -> np.ndarray:
    """An SGILOG strip or tile -> its LogLuv pixels, uint32 [rows, cw]
    (tif_luv.c LogLuvDecode32 / LogLuvDecode24, a row at a time).  32-bit:
    each row its four byte planes, most significant first, each a string of
    runs (a byte b >= 128: b - 126 copies of the next byte) and literals (a
    byte n < 128: the n bytes after it).  24-bit (34677): three bytes a
    pixel, most significant first, no coding.  A row whose data runs out
    gives no image: libtiff's decode fails, and OpenCV's read of the strip."""
    out = np.zeros((rows, cw), np.uint32)
    if comp == 34677:
        n = rows * cw * 3
        if len(data) < n:
            raise NoImage("TIFF: an SGILOG24 strip or tile holds less data than its rows need "
                          "(libtiff's decode fails; OpenCV returns no image)")
        b = np.frombuffer(data[:n], np.uint8).reshape(rows, cw, 3).astype(np.uint32)
        return (b[..., 0] << 16) | (b[..., 1] << 8) | b[..., 2]
    pos, n = 0, len(data)
    for y in range(rows):
        for shift in (24, 16, 8, 0):
            plane = bytearray()
            while len(plane) < cw and pos < n:
                c = data[pos]
                if c >= 128:
                    if pos + 1 >= n:
                        break
                    plane += data[pos + 1:pos + 2] * (c - 126)
                    pos += 2
                else:                               # a literal stops where the row does
                    take = min(c, cw - len(plane), n - pos - 1)
                    plane += data[pos + 1:pos + 1 + take]
                    pos += 1 + take
            if len(plane) < cw:
                raise NoImage(f"TIFF: an SGILOG strip or tile ends in row {y} (libtiff's decode "
                              f"fails; OpenCV returns no image)")
            out[y] |= np.frombuffer(bytes(plane[:cw]), np.uint8).astype(np.uint32) << shift
    return out


def _xyz_to_rgb(xyz: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(COLOR_XYZ2BGR) on float32 [H, W, 3], channels then
    reversed: OpenCV's sRGB D65 matrix in float32, a row's pixels in
    vectors of 4 summed (Y + Z) + X, the last W % 4 one by one, (X + Y) + Z."""
    x, y, z = (xyz[..., i] for i in range(3))
    lanes = xyz.shape[1] - xyz.shape[1] % 4
    out = []
    for c in _XYZ2SRGB:
        k0, k1, k2 = (_F(v) for v in c)
        ch = (y * k1 + z * k2) + x * k0
        ch[:, lanes:] = (x[:, lanes:] * k0 + y[:, lanes:] * k1) + z[:, lanes:] * k2
        out.append(ch)
    return np.stack(out, -1)


def _samples(raw: bytes, rows: int, cw: int, per: int, bps: int, end: str,
             pred: int) -> np.ndarray:
    """A decoded strip or tile -> its samples [rows, cw, per] (unsigned, in
    the machine's byte order; below 8 bits the values as stored), with the
    predictor undone."""
    row_bytes = (cw * per * bps + 7) // 8
    if len(raw) < rows * row_bytes:
        raise ValueError("TIFF: a strip or tile holds less data than its rows need")
    chunk = np.frombuffer(raw[:rows * row_bytes], np.uint8).reshape(rows, row_bytes)
    if bps % 8:                                      # a row's bits, most significant first
        bits = np.unpackbits(chunk, axis=1)[:, :cw * per * bps].reshape(rows, cw, per, bps)
        return bits.dot(1 << np.arange(bps - 1, -1, -1)).astype(np.uint8 if bps < 8 else
                                                                 np.uint16)
    size = bps // 8
    if pred == 3:
        # the floating-point predictor: the row's bytes differenced a pixel's
        # samples apart, after the samples' bytes were laid out in planes of
        # significance, most significant first (whatever the byte order)
        d = np.cumsum(chunk.reshape(rows, -1, per), axis=1, dtype=np.uint8)
        d = np.ascontiguousarray(d.reshape(rows, size, cw * per).transpose(0, 2, 1))
        return d.view(f">u{size}").reshape(rows, cw, per).astype(f"u{size}")
    v = chunk.view(f"{end}u{size}").reshape(rows, cw, per).astype(f"u{size}")
    if pred == 2:                                    # horizontal differences, per sample
        v = np.cumsum(v, axis=1, dtype=v.dtype)
    return v


def _subsampled(raw: bytes, rows: int, cw: int, h: int, v: int) -> np.ndarray:
    """YCbCr in blocks of h x v pixels (their h v Y samples row by row, then
    Cb and Cr) -> [rows, cw, 3], each pixel with its block's Cb and Cr."""
    bw, bh, n = -(-cw // h), -(-rows // v), h * v + 2
    if len(raw) < bw * bh * n:
        raise ValueError("TIFF: a strip or tile holds less data than its rows need")
    blk = np.frombuffer(raw[:bw * bh * n], np.uint8).reshape(bh, bw, n)
    y = blk[..., :h * v].reshape(bh, bw, v, h).transpose(0, 2, 1, 3).reshape(bh * v, bw * h)
    c = np.repeat(np.repeat(blk[..., h * v:], v, axis=0), h, axis=1)
    return np.concatenate([y[..., None], c], -1)[:rows, :cw]


def _jpeg(raw: bytes, tables: Optional[bytes], space: str, rows: int, cw: int) -> np.ndarray:
    """A JPEG-coded strip or tile (its abbreviated stream after the
    JPEGTables field's tables) -> [rows, cw, components]."""
    from iron_tpu_torch.data.jpeg import decode_jpeg
    if raw[:2] != b"\xff\xd8":
        raise NoImage("TIFF: a JPEG strip or tile without an SOI marker (libjpeg stops in "
                      "libtiff's JPEGPreDecode; OpenCV returns no image)")
    if tables is not None and tables[:2] != b"\xff\xd8":
        raise NoImage("TIFF: a JPEGTables field that is not a JPEG stream (libtiff's "
                      "JPEGSetupDecode stops; OpenCV returns no image)")
    if tables:
        raw = (tables[:-2] if tables[-2:] == b"\xff\xd9" else tables) + raw[2:]
    img = decode_jpeg(raw, space)
    if img.shape[1] > cw or img.shape[0] > rows:
        raise NoImage(f"TIFF: a JPEG strip or tile of {img.shape[1]}x{img.shape[0]} where "
                      f"{cw}x{rows} was expected (libtiff's JPEGPreDecode stops; no image)")
    # a smaller one fills the start of each row it has, the rest as zeroed
    out = np.zeros((rows, cw, img.shape[2]), img.dtype)
    out[:img.shape[0], :img.shape[1]] = img
    return out


def _fix(x) -> int:
    """libtiff's FIX: (int32)(x * 65536 + 0.5), the product in float."""
    return int(np.float64(_F(x) * _F(65536)) + 0.5)


def _code2v(c: np.ndarray, rb, rw, cr: int) -> np.ndarray:
    """libtiff's Code2V in float32: (c - (int)RB) * CR / (RW - RB), then
    CLAMPw to +-4096 and truncated."""
    den = rw - rb
    f = (c - int(rb)).astype(_F) * _F(cr) / (den if den != 0 else _F(1))
    f = np.where(f >= _F(-4096), np.minimum(f, _F(4096)), _F(-4096))
    return np.trunc(f).astype(np.int64)


def _ycbcr_to_rgb(ycc: np.ndarray, luma, refbw) -> np.ndarray:
    """TIFFYCbCrToRGBInit's tables and TIFFYCbCrtoRGB: uint8 [..., 3] YCbCr
    -> RGB."""
    lr, lg, lb = (_F(v) for v in luma)
    clamp = lambda f: min(max(f, _F(0)), _F(2))
    f1, f3 = _F(2) - _F(2) * lr, _F(2) - _F(2) * lb
    d1, d2 = _fix(clamp(f1)), -_fix(clamp(lr * f1 / lg))
    d3, d4 = _fix(clamp(f3)), -_fix(clamp(lb * f3 / lg))
    x = np.arange(-128, 128)
    rb = [_F(v) for v in refbw]
    cr = _code2v(x, rb[4] - _F(128), rb[5] - _F(128), 127)
    cb = _code2v(x, rb[2] - _F(128), rb[3] - _F(128), 127)
    y_tab = _code2v(x + 128, rb[0], rb[1], 255)
    cr_r, cb_b = (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + 32768
    Y, Cb, Cr = (ycc[..., i].astype(np.intp) for i in range(3))
    rgb = np.stack([y_tab[Y] + cr_r[Cr], y_tab[Y] + ((cb_g[Cb] + cr_g[Cr]) >> 16),
                    y_tab[Y] + cb_b[Cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# libtiff's display_sRGB: the XYZ -> RGB matrix; the luminance of white 100
# and of black 1, 255 at white, gamma 2.4 (tif_getimage.c)
_SRGB = ((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416), (0.0556, -0.2040, 1.0570))
_D50 = (96.4250, 100.0, 82.4680)
# OpenCV's XYZ -> sRGB (D65) matrix, rows R, G, B (color_lab.cpp)
_XYZ2SRGB = ((3.240479, -1.53715, -0.498535), (-0.969256, 1.875991, 0.041556),
             (0.055648, -0.204043, 1.057311))
# OpenCV's gray weights in 14-bit fixed point (R, G, B; icvCvt_BGR2Gray_16u)
_GRAY_R, _GRAY_G = int(0.299 * (1 << 14) + 0.5), int(0.587 * (1 << 14) + 0.5)
_GRAY_B = (1 << 14) - _GRAY_R - _GRAY_G


def _cielab_to_rgb(lab: np.ndarray, bps: int, white) -> np.ndarray:
    """TIFFCIELab16ToXYZ then TIFFXYZToRGB, in float32 in libtiff's order:
    uint8 / uint16 [..., 3] CIELab (L unsigned, a and b signed) -> RGB."""
    if white is None:                                # D50, as TIFFGetFieldDefaulted gives it
        x0, y0, z0 = (_F(v) for v in _D50)
        white = (x0 / (x0 + y0 + z0), y0 / (x0 + y0 + z0))
    wx, wy = _F(white[0]), _F(white[1])
    X0, Y0, Z0 = wx / wy * _F(100), _F(100), (_F(1) - wx - wy) / wy * _F(100)
    step = _F(99) / _F(1500)
    gamma = (np.power(np.arange(1501) / 1500, 1.0 / float(_F(2.4))).astype(_F) * _F(255))
    if bps == 8:
        l = lab[..., 0].astype(np.int64) * 257
        a, b = (np.ascontiguousarray(lab[..., i]).view(np.int8).astype(np.int64) * 256
                for i in (1, 2))
    else:
        l = lab[..., 0].astype(np.int64)
        a, b = (np.ascontiguousarray(lab[..., i]).view(np.int16).astype(np.int64) for i in (1, 2))
    L = l.astype(_F) * _F(100) / _F(65535)
    dark = L < _F(8.856)
    y_dark = L * Y0 / _F(903.292)
    cby_light = (L + _F(16)) / _F(116)
    cby = np.where(dark, _F(7.787) * (y_dark / Y0) + _F(16) / _F(116), cby_light)
    Y = np.where(dark, y_dark, Y0 * cby_light * cby_light * cby_light)

    def xz(tmp, ref):
        return np.where(tmp < _F(0.2069), ref * (tmp - _F(0.13793)) / _F(7.787),
                        ref * tmp * tmp * tmp)

    X = xz(a.astype(_F) / _F(256) / _F(500) + cby, X0)
    Z = xz(cby - b.astype(_F) / _F(256) / _F(200), Z0)
    out = []
    for m in _SRGB:
        lum = _F(m[0]) * X + _F(m[1]) * Y + _F(m[2]) * Z
        lum = np.minimum(np.maximum(lum, _F(1)), _F(100))
        i = np.minimum(np.trunc((lum - _F(1)) / step).astype(np.int64), 1500)
        out.append(np.minimum((gamma[i].astype(np.float64) + 0.5).astype(np.int64), 255))
    return np.stack(out, -1).astype(np.uint8)


def _to_rgba8(out: np.ndarray, photo: int, bps: int, t: Dict[int, object]) -> np.ndarray:
    """The samples -> what libtiff's RGBA interface and OpenCV's conversion
    of its raster give (uint8, RGB(A) order)."""
    if photo in (0, 1):                              # libtiff's bilevel / gray map
        g = out[..., 0].astype(np.int64)
        if bps == 16:                                # 16-bit gray through its high byte
            g, bps = g >> 8, 8
        top = (1 << bps) - 1
        return ((top - g if photo == 0 else g) * 255 // top).astype(np.uint8)
    if photo == 3:
        cmap = np.asarray(t[320], np.int64).reshape(3, -1)
        if cmap.max() >= 256:                        # 16-bit entries (libtiff's cvtcmap)
            cmap = cmap >> 8
        return cmap.T[out[..., 0]].astype(np.uint8)
    if photo == 5:                                   # putRGBcontig8bitCMYKtile
        k = 255 - out[..., 3:4].astype(np.int64)
        rgb = k * (255 - out[..., :3].astype(np.int64)) // 255
        return np.concatenate([rgb, np.full_like(k, 255)], -1).astype(np.uint8)
    if photo == 6:
        return _ycbcr_to_rgb(out, t.get(529, [0.299, 0.587, 0.114]),
                             t.get(532, [0.0, 255.0, 128.0, 255.0, 128.0, 255.0]))
    if photo == 8:
        return _cielab_to_rgb(out, bps, t.get(318))
    rgb = out[..., :3]
    if out.shape[-1] < 4:
        return np.ascontiguousarray(rgb)
    alpha = out[..., 3:4].astype(np.int64)
    if t.get(338, [0])[0] == 2:                      # unassociated: premultiplied
        rgb = ((rgb.astype(np.int64) * alpha + 127) // 255).astype(np.uint8)
    return np.concatenate([rgb, out[..., 3:4]], -1)


# LogLuv (SGILOG, tif_luv.c): 32-bit pixels (a sign and 15 bits of log
# luminance, 8-bit u' and v'), 24-bit ones (10 bits of log luminance, a
# 14-bit index into uvcode.h's grid of (u', v') squares, rows of v')
UV_SQSIZ = float(np.float32(0.0035))
UV_VSTART = float(np.float32(0.01694))
_U_NEU, _V_NEU = 0.210526316, 0.473684211
_UV_TABLE: Optional[dict] = None
_LN2 = 0.69314718055994530942


def _uv_table() -> dict:
    """uvcode.h's uv_row (the first u of each row as a float32, the count of
    indices before it), recovered from libtiff by
    scripts/probe_logluv_uv_table.py."""
    global _UV_TABLE
    if _UV_TABLE is None:
        import json
        import os
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "logluv24_uv.json")) as f:
            rec = json.load(f)
        _UV_TABLE = {"ustart": [np.float32(v) for v in rec["ustart"]], "ncum": rec["ncum"],
                     "ndivs": rec["ndivs"]}
    return _UV_TABLE


def _log_y(le: np.ndarray, bits: int) -> np.ndarray:
    """LogL16toY (`bits` 15: exp(ln2 / 256 (Le + .5) - 64 ln2)) or LogL10toY
    (10: exp(ln2 / 64 (Le + .5) - 12 ln2)) in double, 0 for Le 0; each
    distinct value through libm's exp, as libtiff computes it."""
    import math
    scale, bias = (256.0, 64.0) if bits == 15 else (64.0, 12.0)
    vals, inv = np.unique(le, return_inverse=True)
    y = np.array([math.exp(_LN2 / scale * (int(e) + .5) - _LN2 * bias) if e else 0.0
                  for e in vals])
    return y[inv].reshape(le.shape)


def _uvl_to_xyz(L: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The tail of LogLuv32toXYZ / LogLuv24toXYZ: (u', v') and Y in double
    -> float32 XYZ [..., 3], all zero where Y <= 0."""
    s = 1. / (6. * u - 16. * v + 12.)
    x, y = 9. * u * s, 4. * v * s
    xyz = np.stack([x / y * L, L, (1. - x - y) / y * L], -1).astype(_F)
    xyz[L <= 0.] = 0
    return xyz


def logluv32_to_xyz(p: np.ndarray) -> np.ndarray:
    """uint32 LogLuv32 pixels -> float32 XYZ [..., 3] (LogLuv32toXYZ)."""
    p = p.astype(np.int64)
    l16 = p >> 16
    L = _log_y(l16 & 0x7FFF, 15)
    L = np.where(l16 & 0x8000, -L, L)
    u = 1. / 410. * (((p >> 8) & 0xFF) + .5)
    v = 1. / 410. * ((p & 0xFF) + .5)
    return _uvl_to_xyz(L, u, v)


def logluv24_to_xyz(p: np.ndarray, table: Optional[dict] = None) -> np.ndarray:
    """24-bit LogLuv pixels (in uint32) -> float32 XYZ [..., 3]
    (LogLuv24toXYZ, uv_decode over `table`, libtiff's by default); an
    index past the grid is the neutral (u', v')."""
    table = table or _uv_table()
    p = p.astype(np.int64)
    L = _log_y((p >> 14) & 0x3FF, 10)
    c = p & 0x3FFF
    ncum = np.asarray(table["ncum"], np.int64)
    vi = np.searchsorted(ncum, c, side="right") - 1
    ustart = np.asarray(table["ustart"], _F).astype(np.float64)
    u = ustart[vi] + (c - ncum[vi] + .5) * UV_SQSIZ
    v = UV_VSTART + (vi + .5) * UV_SQSIZ
    past = c >= table.get("ndivs", 1 << 14)
    u, v = np.where(past, _U_NEU, u), np.where(past, _V_NEU, v)
    return _uvl_to_xyz(L, u, v)


def _refusal(bps: int, spp: int, photo: int, fmt: int, pred: int, comp: int, planar: int,
             rgba: bool, sub, inkset: int) -> Optional[ValueError]:
    """The error that says why OpenCV gives no image for such a file (a
    NoImage), or misreads it, or why the port has no decoder for it; None
    when it is read."""
    what = f"{bps}-bit samples of format {fmt}, {spp} a pixel, photometric {photo}"
    if spp > 4:
        return NoImage(f"{spp} samples a pixel (OpenCV reads at most 4)")
    if fmt not in (1, 2, 3) or (fmt == 3 and (rgba or bps < 32)):
        return NoImage(f"{what} (OpenCV reads floats of 32 or 64 bits, 1, 3 or 4 a pixel)")
    if pred not in (1, 2, 3) or (pred == 3 and fmt != 3) or (pred == 2 and bps % 8):
        return NoImage(f"predictor {pred} on {what} (libtiff refuses it)")
    if comp in (2, 3, 4) and (bps != 1 or spp != 1):
        return ValueError(f"CCITT coding of {what} (it codes 1-bit gray)")
    if comp == 7 and bps == 12:
        return ValueError(f"JPEG coding of {what}")
    if comp == 7 and bps != 8:
        return NoImage(f"JPEG coding of {what} (libtiff's JPEG codec takes 8 bits)")
    if not rgba:
        if bps not in (10, 12, 14, 16, 32, 64):
            return NoImage(f"{what} (OpenCV reads 1, 8, 10, 12, 14, 16, 32 and 64 bits)")
        if spp > 1 and planar == 2:
            return ValueError(f"planar {what} (OpenCV misreads them: it takes the first plane "
                              f"for interleaved samples)")
        return None
    if bps > 16:
        return NoImage(f"{what} (libtiff's RGBA interface, which OpenCV reads them through, "
                       f"takes 16)")
    if photo in (0, 1) and bps not in (1, 8, 16):
        return NoImage(f"{what} (libtiff's RGBA interface, which OpenCV reads them through, "
                       f"takes gray of 1, 8 or 16 bits; below 8 bits OpenCV reads bilevel and "
                       f"palette files only)")
    if photo == 2 and (bps != 8 or spp < 3):
        return NoImage(f"RGB {what} (libtiff's RGBA interface refuses them)")
    if photo == 3 and (bps > 8 or spp != 1):
        return NoImage(f"palette {what} (libtiff's RGBA interface refuses them)")
    if photo == 5 and (bps != 8 or spp != 4 or inkset != 1):
        return NoImage(f"CMYK {what}, InkSet {inkset} (libtiff's RGBA interface refuses them)")
    if photo == 6 and (bps != 8 or spp != 3 or (comp == 7 and planar != 1) or
                       sub not in _SUBSAMPLING or (planar == 2 and sub != (1, 1))):
        return NoImage(f"YCbCr {what}, subsampling {sub[0]}x{sub[1]}, planar configuration "
                       f"{planar} (libtiff's RGBA interface refuses them)")
    if photo == 8 and (bps not in (8, 16) or spp != 3 or planar != 1):
        return NoImage(f"CIELab {what}, planar configuration {planar} (libtiff's RGBA "
                       f"interface refuses them)")
    if photo not in (0, 1, 2, 3, 5, 6, 8):
        return NoImage(f"photometric {photo} (libtiff's RGBA interface, which OpenCV reads it "
                       f"through, refuses it)")
    return None


def _luv_refusal(comp: int, photo: int, spp: int, planar: int) -> Optional[ValueError]:
    """The error for an SGILOG file or a LogL / LogLuv one that OpenCV
    gives no image for, or misreads; None for LogLuv it reads (as float32
    XYZ through libtiff, then to RGB)."""
    if comp not in (34676, 34677):
        return NoImage(f"photometric {photo} with compression {comp} (libtiff reads LogL and "
                       f"LogLuv only through SGILOG compression)")
    if photo == 32844:
        if comp == 34677:
            return NoImage("LogL with 24-bit SGILOG compression (libtiff refuses it)")
        return ValueError("LogL (photometric 32844; OpenCV misreads it: libtiff's 8-bit gray, "
                          "sqrt(Y) of 256, comes back as int8)")
    if photo != 32845:
        return NoImage(f"SGILOG compression of photometric {photo} (libtiff decodes LogL and "
                       f"LogLuv only)")
    if planar != 1:
        return NoImage("planar LogLuv (libtiff's SGILOG codec refuses it)")
    if spp == 1:
        return ValueError("LogLuv of 1 sample a pixel (OpenCV asks libtiff for float XYZ, 12 "
                          "bytes a pixel, in rows of 4 bytes a pixel, and reads the rest of each "
                          "row from memory no file holds; not read by the port)")
    if spp != 3:
        return ValueError(f"LogLuv of {spp} samples a pixel (not read by the port: libtiff "
                          f"writes 3)")
    return None


def read_tiff(data: bytes) -> np.ndarray:
    """A TIFF (the first image) as cv2.imread(IMREAD_UNCHANGED) reads it:
    [H, W] or [H, W, 3 / 4], channels in RGB(A) order; uint8 (int8) through
    libtiff's RGBA interface, 16- to 64-bit gray and RGB(A) as stored."""
    t = _directory(data)
    end = "<" if data[:1] == b"I" else ">"
    one = lambda tag, default: t.get(tag, [default])[0]
    W, H = one(256, 0), one(257, 0)
    spp, bps, comp = one(277, 1), one(258, 1), one(259, 1)
    if 262 not in t:
        raise NoImage("TIFF: no Photometric field (OpenCV asserts one; no image)")
    photo = t[262][0]
    planar, fmt, fill = one(284, 1), one(339, 1), one(266, 1)
    pred = one(317, 1)
    # OpenCV's readHeader: the depths it takes, integer samples at 1 and 8
    # bits; then imread's size limits
    if bps not in (1, 2, 4, 8, 10, 12, 14, 16, 32, 64) or (bps in (1, 8) and fmt not in (1, 2)):
        raise NoImage(f"TIFF: {bps}-bit samples of format {fmt} (OpenCV reads 1, 2, 4, 8, 10, "
                      f"12, 14, 16, 32 and 64 bits, integers at 1 and 8; no image)")
    check_size(W, H, "TIFF")
    if comp in _REFUSED:
        raise (ValueError if comp == 32771 else NoImage)(f"TIFF: {_REFUSED[comp]}")
    if comp in _NOT_CONFIGURED:
        raise NoImage(f"TIFF: compression {comp}, which OpenCV's libtiff is built without (no "
                      f"image)")
    luv = comp in (34676, 34677)
    known = comp in _COMPRESSION or luv
    if not known and comp in _CONFIGURED:
        raise ValueError(f"TIFF: compression {comp} is not read by the port (none, PackBits, "
                         f"LZW, Deflate, JPEG, CCITT 2-4 and SGILOG are)")
    # OpenCV keeps wide gray and RGB(A) samples and LogLuv's XYZ; the rest
    # goes to 8 bits through libtiff's RGBA interface
    rgba = not luv and (bps <= 8 or photo not in (0, 1, 2) or spp not in (1, 3, 4))
    sub = tuple(t.get(530, [2, 2])[:2]) if photo == 6 and comp != 7 else (1, 1)
    if luv or photo in (32844, 32845):
        why = _luv_refusal(comp, photo, spp, planar)
    else:
        why = _refusal(bps, spp, photo, fmt, pred, comp, planar, rgba, sub, one(332, 1))
    tiled = t["tiled"]
    orientation = one(274, 1)
    if orientation not in (1, 2, 3, 4):
        why = NoImage(f"orientation {orientation} (OpenCV gives no image: its imread check "
                      f"fails)")
    elif rgba and tiled and orientation in (2, 3):
        why = ValueError(f"orientation {orientation} in tiles read through libtiff's RGBA "
                         f"interface (OpenCV misreads them: the tiles flipped twice, the image "
                         f"once)")
    if why:
        raise type(why)(f"TIFF: {why}")
    # OpenCV's readData: a tile or strip of at most 2^24 rows and columns
    # and under 1 GB
    ncn = one(277, 1 if photo in (0, 1) else 3)
    if not rgba and not luv and ncn != spp:
        raise ValueError(f"TIFF: {bps}-bit samples, photometric {photo}, without a "
                         f"SamplesPerPixel field (libtiff decodes one sample a pixel, OpenCV "
                         f"copies {ncn} a pixel from its buffer and reads the rest from memory "
                         f"no file holds; not read by the port)")
    tw, th = (one(322, 0), one(323, 0)) if tiled else (W, one(278, 0))
    tw = tw or W
    th = H if th == 0 or (not tiled and th == 0xFFFFFFFF) else th
    if not (0 < tw <= 1 << 24 and 0 < th <= 1 << 24) or \
            tw * th * ncn * max(1, bps // 8) >= 1 << 30:
        raise NoImage(f"TIFF: {'tiles' if tiled else 'strips'} of {tw} x {th} pixels (OpenCV "
                      f"asserts at most 2^24 a side and under 1 GB; no image)")
    if tiled:
        cw, ch = one(322, 0), one(323, 0)
    else:
        cw, ch = W, min(t["rps"], H)
    offsets, counts = t["offsets"], t["counts"]
    planes = spp if planar == 2 else 1
    per = spp // planes                              # samples a pixel within a chunk
    across, down = -(-W // cw), -(-H // ch)
    space = "ycc" if photo == 6 else "raw"           # JPEGCOLORMODE_RGB for YCbCr
    out = np.zeros((H, W, spp), _F if luv else np.uint8 if bps <= 8 else
                   np.uint16 if bps <= 16 else f"u{bps // 8}")
    fax: dict = {}                                   # libtiff's fax3 state the strips share
    for k, off in enumerate(offsets):
        plane, k2 = divmod(k, across * down)
        if plane >= planes:
            break
        cy, cx = divmod(k2, across)
        rows = ch if tiled else min(ch, H - cy * ch)
        if sub != (1, 1):
            want = -(-cw // sub[0]) * -(-rows // sub[1]) * (sub[0] * sub[1] + 2)
        else:
            want = rows * ((cw * per * bps + 7) // 8)
        size = counts[k]
        if size > 1 << 20 and (size - 4096) // 10 > _strip_size(ch, cw, per, bps, photo, comp, t):
            size = _strip_size(ch, cw, per, bps, photo, comp, t) * 10 + 4096
        if size == 0 or off + size > len(data):
            raise NoImage("TIFF: a strip or tile of no bytes or past the end of the file "
                          "(libtiff's TIFFFillStrip stops; OpenCV returns no image)")
        if not known:
            # a codec libtiff does not know: the strip decodes to nothing, and
            # the RGBA interface goes on with zeros
            if not rgba:
                raise NoImage(f"TIFF: compression {comp}, which libtiff does not know (OpenCV "
                              f"returns no image)")
            continue
        raw = data[off:off + size]
        if fill == 2 and comp != 7:                  # least significant bit first
            raw = raw.translate(BIT_REVERSED)
        if comp == 7:
            chunk = _jpeg(raw, t.get(347), space, rows, cw)
        elif luv:
            p = _sgilog(raw, rows, cw, comp)
            chunk = logluv32_to_xyz(p) if comp == 34676 else logluv24_to_xyz(p)
        else:
            failed = False
            if comp in (2, 3, 4):
                raw, failed = decode_ccitt(raw, cw, rows, comp, one(292, 0), state=fax)
                raw = raw.tobytes()
            elif comp == 5:
                raw, failed = _lzw(raw, want)
            elif comp in (8, 32946):
                raw, failed = _inflate(raw, want, rgba)
            elif comp == 32773:
                raw, failed = _packbits(raw, want)
            elif len(raw) < want:
                # libtiff copies none of uncompressed data short of its rows
                raw, failed = bytes(want), True
            if failed and not rgba:
                raise NoImage("TIFF: corrupt or short strip or tile data (libtiff stops; OpenCV "
                              "returns no image)")
            # a chunk libtiff failed to decode: the read goes on through the
            # RGBA interface (OpenCV asks it not to stop on errors) with the
            # chunk as decoded and zeros after, the predictor not applied
            if sub != (1, 1):
                chunk = _subsampled(raw, rows, cw, *sub)
            else:
                chunk = _samples(raw, rows, cw, per, bps, end, 1 if failed else pred)
        y0, x0 = cy * ch, cx * cw
        h, w = min(rows, H - y0), min(cw, W - x0)
        out[y0:y0 + h, x0:x0 + w, plane:plane + per] = chunk[:h, :w]
    flip = {1: (1, 1), 2: (1, -1), 3: (-1, -1), 4: (-1, 1)}[orientation]
    if luv:                                          # OpenCV turns XYZ, then converts it
        return _xyz_to_rgb(np.ascontiguousarray(out[::flip[0], ::flip[1]]))
    if not rgba:
        if bps <= 16 and spp > 1 and photo in (0, 1):
            # 3 or 4 gray samples: OpenCV weighs the first three to one in
            # 14-bit fixed point (as R, G, B), on the unsigned bits
            g = out[..., :3].astype(np.int64)
            out = ((g[..., 0] * _GRAY_R + g[..., 1] * _GRAY_G + g[..., 2] * _GRAY_B
                    + (1 << 13)) >> 14).astype(np.uint16)[..., None]
        if bps < 16:
            # 10, 12 or 14 bits: shifted up to 16, a signed file saturated
            out = out << (16 - bps)
            if fmt == 2:
                out = np.minimum(out, 32767)
        img = out.view(f"{'uif'[fmt - 1]}{out.dtype.itemsize}")
        img = img[..., 0] if img.shape[-1] == 1 else img
    else:
        img = _to_rgba8(out, 2 if comp == 7 and photo == 6 else photo, bps, t)
        img = img.view(np.int8) if fmt == 2 else img
    # the Orientation field: OpenCV mirrors, turns or flips the image
    return np.ascontiguousarray(img[::flip[0], ::flip[1]]) if orientation != 1 else img


def write_tiff(img: np.ndarray) -> bytes:
    """uint8 or uint16 [H, W], [H, W, 3] (RGB) or [H, W, 4] (RGBA) as an
    uncompressed little-endian TIFF of one strip: what cv2.imwrite's TIFF
    decodes to (four samples without an ExtraSamples field, as OpenCV
    writes them)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    C = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype not in (np.uint8, np.uint16) or C not in (1, 3, 4):
        raise ValueError(f"write_tiff takes uint8 / uint16 [H, W] or [H, W, 3 / 4], got "
                         f"{img.dtype} {img.shape}")
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
