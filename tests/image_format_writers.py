"""Writers of image files that neither OpenCV nor PIL writes, for the tests
of the port's image readers (tests/test_torch_image_formats.py) and for
scripts/make_format_fixtures.py: lossless JPEG (SOF3), arithmetic-coded and
YCCK JPEG through the system's libjpeg (ctypes), TIFF layouts by hand
(tiles, planar, any compression, BigTIFF, signed and float samples, both
predictors, YCbCr blocks, JPEG with JPEGTables, FillOrder 2) and through
the system's libtiff (ctypes: its JPEG, CCITT, LZMA and ZSTD codecs), RLE
BMP, old-style RLE Radiance HDR, Sun raster layouts and GIF frames.  OpenCV
stays the reference decoder of every file written here."""
from __future__ import annotations

import ctypes
import ctypes.util
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# JPEG through libjpeg (jpeglib.h, JPEG_LIB_VERSION 62)
# ---------------------------------------------------------------------------

_J_COLOR = {"gray": 1, "rgb": 2, "ycc": 3, "cmyk": 4, "ycck": 5}


def _libjpeg():
    """The system's libjpeg of the version-62 ABI (libjpeg-turbo's
    libjpeg.so.62), which jpeglib.h's layout below assumes."""
    lib = ctypes.CDLL(ctypes.util.find_library("jpeg") or "libjpeg.so.62")
    lib.jpeg_std_error.restype = ctypes.c_void_p
    return lib


def libjpeg_aritab() -> List[int]:
    """libjpeg's own QM-coder table (jaricom.c's jpeg_aritab)."""
    return list((ctypes.c_long * 114).in_dll(_libjpeg(), "jpeg_aritab"))


def libjpeg_encode(img: np.ndarray, space: str = "ycc", arith: bool = False,
                   progressive: bool = False, restart: int = 0, quality: int = 90) -> bytes:
    """uint8 [H, W] (gray) or [H, W, 3] (RGB) or [H, W, 4] (CMYK) written by
    the system's libjpeg into the JPEG colour space `space` (gray, ycc,
    rgb: 3 components with an Adobe segment; cmyk, ycck: 4 components),
    arithmetic-coded (SOF9 / SOF10) or Huffman, sequential or progressive
    (jpeg_simple_progression), with a restart interval of `restart` MCUs.

    The fields of jpeg_compress_struct that jpeglib.h sets no function for
    are found by layout: the common fields and the destination pointer
    (48 bytes), then image_width, image_height, input_components and
    in_color_space; arith_code and restart_interval after the conditioning
    tables, which jpeg_set_defaults fills with 16 x 0, 16 x 1, 16 x 5."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[2]
    lib = _libjpeg()
    err = ctypes.create_string_buffer(1024)
    cinfo = ctypes.create_string_buffer(4096)
    ctypes.memmove(cinfo, ctypes.byref(ctypes.c_void_p(lib.jpeg_std_error(err))), 8)
    lib.jpeg_CreateCompress(cinfo, 62, ctypes.c_size_t(520))     # sizeof(jpeg_compress_struct)
    out = ctypes.POINTER(ctypes.c_ubyte)()
    n = ctypes.c_ulong(0)
    lib.jpeg_mem_dest(cinfo, ctypes.byref(out), ctypes.byref(n))
    in_space = {1: "gray", 3: "rgb", 4: "cmyk"}[C]
    struct.pack_into("<IIii", cinfo, 48, W, H, C, _J_COLOR[in_space])
    lib.jpeg_set_defaults(cinfo)
    lib.jpeg_set_colorspace(cinfo, _J_COLOR[space])
    lib.jpeg_set_quality(cinfo, quality, 1)
    if progressive:
        lib.jpeg_simple_progression(cinfo)
    end = cinfo.raw.find(b"\x00" * 16 + b"\x01" * 16 + b"\x05" * 16) + 48
    struct.pack_into("<i", cinfo, end + 20, int(arith))
    struct.pack_into("<I", cinfo, end + 40, restart)
    lib.jpeg_start_compress(cinfo, 1)
    row = (ctypes.POINTER(ctypes.c_ubyte) * 1)()
    flat = img.reshape(H, W * C)
    for y in range(H):
        row[0] = flat[y].ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        lib.jpeg_write_scanlines(cinfo, row, 1)
    lib.jpeg_finish_compress(cinfo)
    data = ctypes.string_at(out, n.value)
    lib.jpeg_destroy_compress(cinfo)
    return data


# ---------------------------------------------------------------------------
# lossless JPEG (T.81 Annex H, Huffman)
# ---------------------------------------------------------------------------

# one fixed table for the difference categories 0-16 (shorter codes for
# the small ones), canonical codes of lengths 3 x 5, 4, 5, ... 15
_LL_LENGTHS = [3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def _predict(x: np.ndarray, predictor: int, first: int, restart_rows: int) -> np.ndarray:
    """The prediction of every sample of one component (int64 [h, w]),
    the rules of T.81 H.1.2.1: the first row (and the first row after a
    restart) from the left, its first sample `first`; the first column
    from above; the rest by the predictor."""
    h, w = x.shape
    pred = np.zeros_like(x)
    for y in range(h):
        if y == 0 or (restart_rows and y % restart_rows == 0):
            pred[y, 0] = first
            pred[y, 1:] = x[y, :-1]
            continue
        a, b = x[y, :-1], x[y - 1, 1:]
        c = x[y - 1, :-1]
        pred[y, 0] = x[y - 1, 0]
        pred[y, 1:] = {1: a, 2: b, 3: c, 4: a + b - c, 5: a + ((b - c) >> 1),
                       6: b + ((a - c) >> 1), 7: (a + b) >> 1}[predictor]
    return pred


def _huffman_bits(cats: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Code each difference (its category's code, then its extra bits)
    -> the bits in order."""
    code, lens, c = {}, {}, 0
    for L in range(1, 17):
        for s in range(17):
            if _LL_LENGTHS[s] == L:
                code[s], lens[s] = c, L
                c += 1
        c <<= 1
    out = []
    for s, v in zip(cats.tolist(), vals.tolist()):
        out.append(format(code[s], f"0{lens[s]}b"))
        if 0 < s < 16:
            out.append(format(v if v >= 0 else v + (1 << s) - 1, f"0{s}b"))
    return "".join(out)


def _stuffed(bits: str) -> bytes:
    bits += "1" * (-len(bits) % 8)
    data = int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""
    return data.replace(b"\xff", b"\xff\x00")


def encode_lossless_jpeg(img: np.ndarray, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
                         precision: int = 8, ids: Sequence[int] = (1, 2, 3, 4),
                         jfif: bool = False, interleaved: bool = True,
                         sampling: Sequence[tuple] = ()) -> bytes:
    """uint8 [H, W], [H, W, 3] or [H, W, 4] as lossless JPEG (SOF3, Huffman):
    `predictor` 1-7, point transform `pt`, a restart marker every
    `restart_rows` rows, one interleaved scan or a scan per component, each
    component sampled 1x1 or at its (h, v) of `sampling` (taken every
    hmax / h columns and vmax / v rows; an interleaved scan's MCUs padded
    with zero differences; no restarts then).  The samples are coded as
    they are (RGB unless a JFIF segment says YCbCr)."""
    img = np.asarray(img)
    planes = [img] if img.ndim == 2 else [img[..., i] for i in range(img.shape[2])]
    H, W = planes[0].shape
    nc = len(planes)
    sampling = list(sampling) or [(1, 1)] * nc
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    if (hmax, vmax) != (1, 1) and restart_rows:
        raise ValueError("encode_lossless_jpeg: restarts with subsampled components")
    planes = [p[::vmax // v, ::hmax // h] for p, (h, v) in zip(planes, sampling)]
    cid = list(ids[:nc]) if nc > 1 else [1]
    x = [p.astype(np.int64) >> pt for p in planes]
    first = 1 << (precision - pt - 1)
    diff = [((xi - _predict(xi, predictor, first, restart_rows)) + 32768) % 65536 - 32768
            for xi in x]
    bits_table = [0] * 16
    for L in _LL_LENGTHS:
        bits_table[L - 1] += 1
    vals = sorted(range(17), key=lambda s: (_LL_LENGTHS[s], s))
    out = [b"\xff\xd8"]
    if jfif:
        out.append(b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                   b"\x00\x00")
    out.append(b"\xff\xc3" + struct.pack(">HBHHB", 8 + 3 * nc, precision, H, W, nc)
               + b"".join(bytes([c, 16 * h + v, 0]) for c, (h, v) in zip(cid, sampling)))
    out.append(b"\xff\xc4" + struct.pack(">H", 2 + 17 + 17) + b"\x00" + bytes(bits_table)
               + bytes(vals))
    if restart_rows:
        out.append(b"\xff\xdd" + struct.pack(">HH", 4, restart_rows * W))

    def scan(comp_idx):
        head = bytes([len(comp_idx)]) + b"".join(bytes([cid[i], 0]) for i in comp_idx)
        out.append(b"\xff\xda" + struct.pack(">H", 6 + 2 * len(comp_idx)) + head
                   + bytes([predictor, 0, pt]))
        rows = restart_rows or H
        if len(comp_idx) > 1 and (hmax, vmax) != (1, 1):
            # MCUs of v x h samples a component, row by row
            mr, mc = -(-H // vmax), -(-W // hmax)
            parts = []
            for i in comp_idx:
                h, v = sampling[i]
                pad = np.zeros((mr * v, mc * h), np.int64)
                pad[:diff[i].shape[0], :diff[i].shape[1]] = diff[i]
                parts.append(pad.reshape(mr, v, mc, h).transpose(0, 2, 1, 3).reshape(mr, mc, -1))
            d = np.concatenate(parts, -1).reshape(-1)
            s = np.zeros(d.shape, np.int64)
            nz = d != 0
            s[nz] = np.floor(np.log2(np.abs(d[nz]))).astype(np.int64) + 1
            out.append(_stuffed(_huffman_bits(s, d)))
            return
        for k, y0 in enumerate(range(0, H, rows)):
            d = np.stack([diff[i][y0:y0 + rows] for i in comp_idx], -1).reshape(-1)
            s = np.zeros(d.shape, np.int64)
            nz = d != 0
            s[nz] = np.floor(np.log2(np.abs(d[nz]))).astype(np.int64) + 1
            s[d == -32768] = 16
            out.append(_stuffed(_huffman_bits(s, d)))
            if y0 + rows < H:
                out.append(bytes([0xFF, 0xD0 + k % 8]))
    if interleaved or nc == 1:
        scan(list(range(nc)))
    else:
        for i in range(nc):
            scan([i])
    out.append(b"\xff\xd9")
    return b"".join(out)


# ---------------------------------------------------------------------------
# BMP: palettes, RLE8 / RLE4, 16 bits, OS/2
# ---------------------------------------------------------------------------

def _rle8_rows(idx: np.ndarray) -> bytes:
    """RLE8 of palette indices [H, W] (bottom row first): runs of 3 or more
    as runs, the rest in absolute mode (or as runs of one or two), an
    end-of-line after each row and an end-of-bitmap at the end."""
    out = bytearray()
    for row in idx[::-1]:
        row = row.tolist()
        i, W = 0, len(row)
        while i < W:
            j = i
            while j < W and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 3:
                out += bytes([j - i, row[i]])
                i = j
                continue
            j = i
            while j < W and j - i < 255 and not (j + 2 < W and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            lit = row[i:j]
            if len(lit) >= 3:
                out += bytes([0, len(lit)]) + bytes(lit) + b"\x00" * (len(lit) & 1)
            else:
                for v in lit:
                    out += bytes([1, v])
            i = j
        out += b"\x00\x00"
    out[-2:] = b"\x00\x01"
    return bytes(out)


def _rle4_rows(idx: np.ndarray) -> bytes:
    """RLE4 of 4-bit indices [H, W] (bottom row first): runs of one value
    as runs, pairs of differing values in absolute mode."""
    out = bytearray()
    for row in idx[::-1]:
        row = row.tolist()
        i, W = 0, len(row)
        while i < W:
            j = i
            while j < W and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= 4 or j == W:
                out += bytes([j - i, row[i] << 4 | row[i]])
                i = j
                continue
            j = min(W, i + 8)
            lit = row[i:j] + [0] * ((j - i) & 1)
            packed = bytes(lit[k] << 4 | lit[k + 1] for k in range(0, len(lit), 2))
            if j - i >= 3:
                out += bytes([0, j - i]) + packed + b"\x00" * (len(packed) & 1)
            else:
                out += bytes([j - i, packed[0]])
            i = j
        out += b"\x00\x00"
    out[-2:] = b"\x00\x01"
    return bytes(out)


def encode_bmp(pixels: np.ndarray, bpp: int, palette: Optional[np.ndarray] = None,
               rle: bool = False, top_down: bool = False, os2: bool = False) -> bytes:
    """A BMP of palette indices [H, W] (bpp 1, 4, 8; `palette` RGB [n, 3];
    RLE8 / RLE4 with `rle`), of 16-bit 5-5-5 words [H, W] (bpp 16) or of
    RGB [H, W, 3] / RGBA [H, W, 4] (bpp 24 / 32, BI_RGB)."""
    H, W = pixels.shape[:2]
    pal = b""
    if bpp <= 8:
        p = np.zeros((len(palette), 4 if not os2 else 3), np.uint8)
        p[:, :3] = palette[:, ::-1]
        pal = p.tobytes()
    if rle:
        body = _rle8_rows(pixels) if bpp == 8 else _rle4_rows(pixels)
        comp = 1 if bpp == 8 else 2
    else:
        if bpp <= 8:
            rows = np.packbits(np.unpackbits(pixels.astype(np.uint8)[..., None], axis=-1)
                               [..., 8 - bpp:].reshape(H, -1), axis=1)
        elif bpp == 16:
            rows = pixels.astype("<u2").view(np.uint8).reshape(H, -1)
        else:
            px = pixels[..., [2, 1, 0, 3][:pixels.shape[2]]]
            rows = px.reshape(H, -1)
        pitch = (rows.shape[1] + 3) & ~3
        full = np.zeros((H, pitch), np.uint8)
        full[:, :rows.shape[1]] = rows
        body = (full if top_down else full[::-1]).tobytes()
        comp = 0
    if os2:
        info = struct.pack("<IHHHH", 12, W, H, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, W, -H if top_down else H, 1, bpp, comp,
                           len(body), 2835, 2835, len(palette) if bpp <= 8 else 0, 0)
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + pal + body


# ---------------------------------------------------------------------------
# Radiance HDR, Sun raster
# ---------------------------------------------------------------------------

def encode_hdr_flat(rgbe: np.ndarray, old_runs: Sequence[tuple] = ()) -> bytes:
    """RGBE pixels uint8 [H, W, 4] as a flat Radiance file; `old_runs`
    (row, column, count) puts an old-style run pixel (1, 1, 1, count) in
    place of a pixel."""
    H, W = rgbe.shape[:2]
    px = rgbe.copy()
    for y, x, n in old_runs:
        px[y, x] = (1, 1, 1, n)
    return b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (H, W) + px.tobytes()


def encode_sunras(pixels: np.ndarray, bpp: int, colormap: Optional[np.ndarray] = None,
                  kind: int = 1) -> bytes:
    """A Sun raster file of type `kind` (0 old, 1 standard; 2 and 3 carry
    the header of the byte-encoded and RGB types over standard data) of
    indices [H, W] (bpp 1 or 8, `colormap` RGB [n, 3] or none) or of RGB
    [H, W, 3] (bpp 24, BGR on disk; bpp 32 with a pad byte first)."""
    H, W = pixels.shape[:2]
    if bpp <= 8:
        rows = np.packbits(np.unpackbits(pixels.astype(np.uint8)[..., None], axis=-1)
                           [..., 8 - bpp:].reshape(H, -1), axis=1)
    else:
        px = pixels[..., ::-1]
        if bpp == 32:
            px = np.concatenate([np.zeros((H, W, 1), np.uint8), px], -1)
        rows = px.reshape(H, -1)
    pitch = (rows.shape[1] + 1) & ~1
    full = np.zeros((H, pitch), np.uint8)
    full[:, :rows.shape[1]] = rows
    body = full.tobytes()
    cmap = b"" if colormap is None else colormap.T.astype(np.uint8).tobytes()
    head = b"\x59\xa6\x6a\x95" + struct.pack(">7I", W, H, bpp, len(body), kind,
                                             0 if colormap is None else 1, len(cmap))
    return head + cmap + body


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def _gif_lzw(idx: np.ndarray, min_size: int) -> bytes:
    """GIF LZW data of the indices, each coded as its own literal code; a
    clear code before the table would widen the codes."""
    clear = 1 << min_size
    size = min_size + 1
    per = (1 << size) - clear - 4
    codes: List[int] = []
    flat = idx.reshape(-1).tolist()
    for i in range(0, len(flat), per):
        codes += [clear] + flat[i:i + per]
    codes.append(clear + 1)
    bits = "".join(format(c, f"0{size}b")[::-1] for c in codes)
    bits += "0" * (-len(bits) % 8)
    data = bytes(int(bits[i:i + 8][::-1], 2) for i in range(0, len(bits), 8))
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def encode_gif(frames: Sequence[np.ndarray], palette: np.ndarray, screen: tuple,
               offsets: Sequence[tuple] = ((0, 0),), transparent: Sequence = (None,),
               background: int = 0, local: bool = False, interlace: bool = False) -> bytes:
    """A GIF89a of frames of indices [h, w] on a `screen` (W, H), frame i
    at offsets[i] (x, y) with transparent index transparent[i] (None: no
    graphic control extension), the palette RGB [2^k, 3] global or local."""
    n = len(palette)
    k = max(1, int(np.ceil(np.log2(n)))) - 1
    pal = np.zeros((2 << k, 3), np.uint8)
    pal[:n] = palette
    head = b"GIF89a" + struct.pack("<HHBBB", screen[0], screen[1],
                                   0 if local else 0x80 | 0x70 | k, background, 0)
    if not local:
        head += pal.tobytes()
    body = b""
    for i, fr in enumerate(frames):
        t = transparent[i] if i < len(transparent) else None
        if t is not None:
            body += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, t) + b"\x00"
        x, y = offsets[i] if i < len(offsets) else (0, 0)
        h, w = fr.shape
        rows = fr
        if interlace:
            order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                    np.arange(2, h, 4), np.arange(1, h, 2)])
            rows = fr[order]
        flags = (0x80 | k if local else 0) | (0x40 if interlace else 0)
        body += b"\x2c" + struct.pack("<HHHHB", x, y, w, h, flags)
        if local:
            body += pal.tobytes()
        min_size = max(2, k + 1)
        body += bytes([min_size]) + _gif_lzw(rows, min_size)
    return head + body + b"\x3b"


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

def pack_samples(a: np.ndarray, bps: int) -> np.ndarray:
    """Integer samples [rows, ...] -> each row's samples `bps` bits each,
    most significant bit first, the row padded to a byte (TIFF's packing
    of 1- to 16-bit samples): uint8 [rows, bytes]."""
    a = np.asarray(a).reshape(len(a), -1).astype(np.uint32)
    bits = (a[..., None] >> np.arange(bps - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(len(a), -1), axis=1)


def _fax_run(n: int, colour: int) -> str:
    """A T.4 run of `colour` (0 white, 1 black): make-up codes, then the
    terminating code."""
    from iron_tpu_torch.data import ccitt
    term, makeup = ((ccitt._WHITE_TERM, ccitt._WHITE_MAKEUP) if colour == 0 else
                    (ccitt._BLACK_TERM, ccitt._BLACK_MAKEUP))
    out = ""
    while n >= 2560:
        out, n = out + ccitt._EXTENDED_MAKEUP[-1], n - 2560
    if n >= 1792:
        k = (n - 1792) // 64
        out, n = out + ccitt._EXTENDED_MAKEUP[k], n - 1792 - 64 * k
    elif n >= 64:
        out, n = out + makeup[n // 64 - 1], n % 64
    return out + term[n]


# a stretch of T.4 uncompressed-mode data: WWWB, B, WWWWW, then the exit
# code with its tag bit (next run white)
FAX_UNCOMPRESSED = "0001" + "1" + "000001" + "00000001" + "0"


def encode_fax(mask: np.ndarray, compression: int, two_d: Optional[bool] = None,
               extension: Optional[tuple] = None) -> bytes:
    """A bilevel image (1 black) as one CCITT strip, by hand: `compression`
    3 (T.4, each row after an EOL, then a tag bit unless `two_d` is None:
    0 for a 2D row if `two_d`, else 1) or 4 (T.6, then EOFB).  A 2D row is
    coded in horizontal mode alone.  `extension` (row, k) puts an
    uncompressed-mode extension code and FAX_UNCOMPRESSED before the k-th
    run of that row (2D: 0000001111, where a mode is due when k is even;
    1D: 000000001111), which libtiff does not decode; the rest of the row
    is coded on."""
    bits = []
    d2 = bool(two_d) or compression == 4
    for y, row in enumerate(np.asarray(mask)):
        if compression == 3:
            bits.append("000000000001" + ("" if two_d is None else "0" if two_d else "1"))
        runs, colour, x = [], 0, 0
        while x < len(row):
            e = x
            while e < len(row) and row[e] == colour:
                e += 1
            runs.append(e - x)
            x, colour = e, colour ^ 1
        if len(runs) % 2:
            runs.append(0)
        for i, n in enumerate(runs):
            if extension is not None and tuple(extension) == (y, i):
                bits.append(("0000001111" if d2 else "000000001111") + FAX_UNCOMPRESSED)
            if d2 and i % 2 == 0:
                bits.append("001")
            bits.append(_fax_run(n, i & 1))
    bits.append("000000000001" * (6 if compression == 3 else 2))
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: codes most significant bit first, 9
    to 12 bits (wider once the next entry passes the width), a clear code
    first and whenever the table fills."""
    out_bits, nbits = 0, 0
    buf = bytearray()

    def put(code, width):
        nonlocal out_bits, nbits
        out_bits = (out_bits << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            buf.append((out_bits >> nbits) & 255)
        out_bits &= (1 << nbits) - 1

    table = {bytes([i]): i for i in range(256)}
    nxt, width = 258, 9
    put(256, width)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
        if nxt >= 4093:
            put(256, width)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        w = bytes([b])
    if w:
        put(table[w], width)
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    put(257, width)
    if nbits:
        buf.append((out_bits << (8 - nbits)) & 255)
    return bytes(buf)


def _packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i)]) + data[i:i + 1]
            i = j
            continue
        j = i
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


_REVERSED_BITS = bytes(int(format(b, "08b")[::-1], 2) for b in range(256))


def _jpeg_tables(streams: List[bytes]):
    """JFIF streams of the port's encode_jpeg -> (a JPEGTables stream with
    their quantisation and Huffman tables, each stream abbreviated: SOI,
    then its frame and scan without those tables)."""
    tables, out = b"", []
    for data in streams:
        pos, keep = 2, b"\xff\xd8"
        while data[pos + 1] != 0xDA:
            n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
            seg = data[pos:pos + 2 + n]
            if data[pos + 1] in (0xDB, 0xC4):
                if not out:
                    tables += seg
            else:
                keep += seg
            pos += 2 + n
        out.append(keep + data[pos:])
    return b"\xff\xd8" + tables + b"\xff\xd9", out


def _ycbcr_blocks(block: np.ndarray, h: int, v: int) -> bytes:
    """YCbCr [rows, cols, 3] -> TIFF's subsampled layout: blocks of h x v
    pixels (edge pixels repeated to whole blocks), each its Y samples row by
    row, then its rounded mean Cb and Cr."""
    bh, bw = -(-block.shape[0] // v), -(-block.shape[1] // h)
    p = np.pad(block, ((0, bh * v - block.shape[0]), (0, bw * h - block.shape[1]), (0, 0)),
               mode="edge").astype(np.int64)
    p = p.reshape(bh, v, bw, h, 3).transpose(0, 2, 1, 3, 4)
    y = p[..., 0].reshape(bh, bw, v * h)
    c = (p[..., 1:].sum(axis=(2, 3)) + v * h // 2) // (v * h)
    return np.concatenate([y, c], -1).astype(np.uint8).tobytes()


def _float_predicted(raw: bytes, rows: int, per: int, size: int) -> bytes:
    """libtiff's floating-point predictor (fpDiff) on each row: the samples'
    bytes in planes of significance, most significant first, then each byte
    less the byte a pixel's samples before it."""
    a = np.frombuffer(raw, np.uint8).reshape(rows, -1)
    n = a.shape[1] // size
    planes = a.reshape(rows, n, size).transpose(0, 2, 1).reshape(rows, -1).astype(np.int64)
    d = planes.copy()
    d[:, per:] -= planes[:, :-per]
    return (d % 256).astype(np.uint8).tobytes()


_FIELD_CODES = {1: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}


def encode_tiff(img: np.ndarray, compression: str = "none", predictor=False,
                tile: Optional[tuple] = None, rows_per_strip: Optional[int] = None,
                planar: bool = False, big_endian: bool = False, photometric: Optional[int] = None,
                extra_samples: Optional[int] = None, colormap: Optional[np.ndarray] = None,
                bits: Optional[int] = None, bigtiff: bool = False,
                sample_format: Optional[int] = None, subsampling: Optional[tuple] = None,
                fill_order: int = 1, jpeg_tables: bool = True,
                extra_tags: Sequence[tuple] = ()) -> bytes:
    """[H, W] or [H, W, C] samples as a TIFF laid out by hand:
    `compression` none / packbits / lzw / deflate / jpeg, the horizontal
    predictor (`predictor` True or 2) or the floating-point one (3), tiles
    of `tile` (width, height) or strips of `rows_per_strip` rows, planar or
    chunky samples, either byte order, classic or BigTIFF; `bits` below 8
    packs one gray sample; `colormap` (uint16 [3, 2^bits]) makes a palette
    file; any integer or float dtype, with `sample_format` (2 signed, 3
    IEEE float) written; `subsampling` (h, v) lays YCbCr samples out in
    TIFF's blocks (photometric 6); "jpeg" codes each strip or tile with the
    port's encode_jpeg at quality 75 (RGB in, YCbCr 4:2:0 inside,
    photometric 6 with 2x2 subsampling), its tables moved to JPEGTables (or
    each stream whole); `fill_order` 2 reverses each coded byte's bits;
    `extra_tags` adds (tag, type, values) fields (type 5, RATIONAL, takes
    (numerator, denominator) pairs)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    bps = bits or 8 * img.dtype.itemsize
    e = ">" if big_endian else "<"
    predictor = {False: 1, True: 2}.get(predictor, predictor)
    if compression == "jpeg":
        photometric, subsampling = 6, (2, 2)
    elif subsampling and photometric is None:
        photometric = 6
    if photometric is None:
        photometric = 3 if colormap is not None else (1 if C < 3 else 2)
    cw, ch = tile if tile else (W, rows_per_strip or H)
    planes = [img[..., c:c + 1] for c in range(C)] if planar else [img]
    chunks = []
    for p in planes:
        for y0 in range(0, H, ch):
            for x0 in range(0, W, cw):
                block = p[y0:y0 + ch, x0:x0 + cw]
                if tile:                             # tiles are padded to full size
                    full = np.zeros((ch, cw, p.shape[2]), img.dtype)
                    full[:block.shape[0], :block.shape[1]] = block
                    block = full
                if compression == "jpeg":
                    from iron_tpu_torch.data.jpeg import encode_jpeg
                    chunks.append(encode_jpeg(block, 75))
                    continue
                if subsampling:
                    raw = _ycbcr_blocks(block, *subsampling)
                elif bps < 8:
                    raw = np.packbits(np.unpackbits(block[..., 0].astype(np.uint8)[..., None],
                                                    axis=-1)[..., 8 - bps:].reshape(
                        block.shape[0], -1), axis=1).tobytes()
                elif predictor == 3:
                    raw = _float_predicted(block.astype(block.dtype.newbyteorder(">")).tobytes(),
                                           block.shape[0], block.shape[2], bps // 8)
                else:
                    if predictor == 2:
                        u = block.view(f"u{bps // 8}")
                        d = u.copy()
                        d[:, 1:] -= u[:, :-1]
                        block = d.view(block.dtype)
                    raw = block.astype(block.dtype.newbyteorder(e)).tobytes()
                raw = {"none": lambda r: r, "packbits": _packbits, "lzw": tiff_lzw,
                       "deflate": zlib.compress}[compression](raw)
                chunks.append(raw)
    tables = None
    if compression == "jpeg" and jpeg_tables:
        tables, chunks = _jpeg_tables(chunks)
    if fill_order == 2:
        chunks = [c.translate(_REVERSED_BITS) for c in chunks]
    comp_code = {"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773, "jpeg": 7}[compression]
    spp_per = C
    offset_type = 16 if bigtiff else 4
    entries = [(256, 4, [W]), (257, 4, [H]), (258, 3, [bps] * spp_per), (259, 3, [comp_code]),
               (262, 3, [photometric]), (277, 3, [C]), (284, 3, [2 if planar else 1])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if extra_samples is not None:
        entries.append((338, 3, [extra_samples]))
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap, np.int64).reshape(-1))))
    if sample_format is not None:
        entries.append((339, 3, [sample_format] * C))
    if subsampling:
        entries.append((530, 3, list(subsampling)))
    if fill_order != 1:
        entries.append((266, 3, [fill_order]))
    if tables is not None:
        entries.append((347, 7, list(tables)))
    entries += list(extra_tags)
    if tile:
        entries += [(322, 4, [cw]), (323, 4, [ch]), (324, offset_type, [0] * len(chunks)),
                    (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(273, offset_type, [0] * len(chunks)), (278, 4, [ch]),
                    (279, 4, [len(c) for c in chunks])]
    entries.sort()
    data_at = 16 if bigtiff else 8
    blob = b"".join(chunks)
    offsets, o = [], data_at
    for c in chunks:
        offsets.append(o)
        o += len(c)
    ifd_at = o + (o & 1)
    entries = [(t, ty, offsets if t in (273, 324) else v) for t, ty, v in entries]
    count_fmt, entry_fmt, inline = ("Q", "HHQ", 8) if bigtiff else ("H", "HHI", 4)
    entry_size = struct.calcsize(e + entry_fmt) + inline
    extra_at = ifd_at + struct.calcsize(e + count_fmt) + entry_size * len(entries) + inline
    extra, fields = b"", []
    for tag, typ, vals in entries:
        if typ == 5:
            body = struct.pack(f"{e}{2 * len(vals)}I", *[x for nd in vals for x in nd])
        else:
            body = struct.pack(f"{e}{len(vals)}{_FIELD_CODES[typ]}", *vals)
        if len(body) <= inline:
            fields.append(struct.pack(e + entry_fmt, tag, typ, len(vals))
                          + body.ljust(inline, b"\x00"))
        else:
            fields.append(struct.pack(e + entry_fmt + count_fmt.replace("H", "I"), tag, typ,
                                      len(vals), extra_at + len(extra)))
            extra += body + b"\x00" * (len(body) & 1)
    magic = (b"MM" if big_endian else b"II") + struct.pack(e + "H", 43 if bigtiff else 42)
    head = magic + (struct.pack(e + "HHQ", 8, 0, ifd_at) if bigtiff
                    else struct.pack(e + "I", ifd_at))
    return (head + blob + b"\x00" * (ifd_at - o) + struct.pack(e + count_fmt, len(entries))
            + b"".join(fields) + b"\x00" * inline + extra)


def _libtiff():
    lib = ctypes.CDLL(ctypes.util.find_library("tiff"))
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    for name in ("TIFFWriteEncodedStrip", "TIFFWriteEncodedTile", "TIFFWriteRawStrip",
                 "TIFFWriteRawTile"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_ssize_t]
        fn.restype = ctypes.c_ssize_t
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFSetField.restype = ctypes.c_int
    return lib


def libtiff_encode(chunks: Sequence, fields: Sequence[tuple], mode: str = "w",
                   tiled: bool = False, raw: bool = False) -> bytes:
    """A TIFF written by the system's libtiff (ctypes): `fields` are
    TIFFSetField calls, (tag, value, ...) with int, float (passed as double)
    or numpy array (passed by pointer) values; `chunks` the strips or tiles
    in order, arrays or bytes, through libtiff's codec (JPEG with
    JPEGCOLORMODE_RGB takes RGB) or as they are (`raw`); `mode` TIFFOpen's
    ("w8" BigTIFF, "wb" / "wl" the byte order)."""
    import os
    import tempfile
    lib = _libtiff()
    fd, path = tempfile.mkstemp(suffix=".tif")
    os.close(fd)
    keep = []
    try:
        t = lib.TIFFOpen(path.encode(), mode.encode())
        if not t:
            raise OSError(f"TIFFOpen({path}, {mode}) failed")
        for tag, *vals in fields:
            args = []
            for v in vals:
                if isinstance(v, float):
                    args.append(ctypes.c_double(v))
                elif isinstance(v, np.ndarray):
                    keep.append(np.ascontiguousarray(v))
                    args.append(keep[-1].ctypes.data_as(ctypes.c_void_p))
                else:
                    args.append(ctypes.c_int(v))
            if lib.TIFFSetField(ctypes.c_void_p(t), ctypes.c_uint32(tag), *args) != 1:
                raise ValueError(f"TIFFSetField({tag}, {vals}) failed")
        write = ((lib.TIFFWriteRawTile if tiled else lib.TIFFWriteRawStrip) if raw else
                 lib.TIFFWriteEncodedTile if tiled else lib.TIFFWriteEncodedStrip)
        for i, c in enumerate(chunks):
            buf = c if isinstance(c, bytes) else np.ascontiguousarray(c).tobytes()
            if write(t, i, buf, len(buf)) < 0:
                raise ValueError(f"libtiff refused chunk {i}")
        lib.TIFFClose(t)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.remove(path)


def thunderscan_encode(idx: np.ndarray) -> bytes:
    """The ThunderScan (TIFF compression 32809) codes of a strip: `idx`
    [rows, W] of 4-bit values, each row coded from a last pixel of 0 (the
    decoder's start), with every code kind: a run (0x00) where the last
    pixel repeats twice or more; three 2-bit deltas (0x40) where the next
    pixels step by -1, 0 or +1 modulo 16, with skip codes (2) for a pair
    of such steps (in the middle or the last place, by turns) and at a
    row's end; two 3-bit deltas (0x80) for steps of -3 to +3, a skip code
    (4) where only the first fits; a raw pixel (0xC0) otherwise."""
    two = {0: 0, 1: 1, 15: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}
    out, turn = bytearray(), 0
    for row in np.asarray(idx, np.int64):
        last, x, width = 0, 0, len(row)
        while x < width:
            run = 0
            while x + run < width and row[x + run] == last and run < 63:
                run += 1
            if run >= 2:
                out.append(run)
                x += run
                continue
            steps, prev = [], last
            for v in row[x:x + 3]:
                steps.append((int(v) - prev) % 16)
                prev = int(v)
            m = 0
            while m < len(steps) and steps[m] in two:
                m += 1
            if m == 3 or (m and x + m == width) or m == 2:
                codes = [two[d] for d in steps[:m]]
                if m == 2 and x + m < width:
                    turn ^= 1
                    codes.insert(1 + turn, 2)
                codes += [2] * (3 - len(codes))
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                x += m
                last = int(row[x - 1])
                continue
            if steps[0] in three:
                k = 2 if len(steps) > 1 and steps[1] in three else 1
                codes = [three[d] for d in steps[:k]] + [4] * (2 - k)
                out.append(0x80 | codes[0] << 3 | codes[1])
                x += k
                last = int(row[x - 1])
                continue
            last = int(row[x])
            out.append(0xC0 | last)
            x += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# WebP through the system's libwebp (encode.h, encoder ABI 0x020f)
# ---------------------------------------------------------------------------

_WEBP_CONFIG_FIELDS = (
    "lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
    "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
    "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
    "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
    "low_memory", "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin",
    "qmax")


class _WebPConfig(ctypes.Structure):
    _fields_ = [(f, ctypes.c_float if f in ("quality", "target_PSNR") else ctypes.c_int)
                for f in _WEBP_CONFIG_FIELDS]


class _WebPPicture(ctypes.Structure):
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
                ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int),
                ("pad1", ctypes.c_uint32 * 2), ("argb", ctypes.c_void_p),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
                ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
                ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
                ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p), ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2)]


class _WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]


def encode_webp(img: np.ndarray, **config) -> bytes:
    """uint8 RGB [H, W, 3] or RGBA [H, W, 4] encoded by the system's
    libwebp (libwebp.so.7) with WebPConfig's fields set from `config`
    (quality, method, segments, sns_strength, filter_strength,
    filter_sharpness, filter_type (0 simple, 1 normal), autofilter,
    partitions (log2), alpha_compression, alpha_filtering, alpha_quality,
    preprocessing, lossless, exact, ...), the rest at WebPConfigInit's
    defaults."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W, C = img.shape
    lib = ctypes.CDLL(ctypes.util.find_library("webp") or "libwebp.so.7")
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, args, res in (("WebPConfigInitInternal", [P, I, ctypes.c_float, I], I),
                            ("WebPValidateConfig", [P], I), ("WebPPictureInitInternal", [P, I], I),
                            ("WebPPictureImportRGB", [P, P, I], I),
                            ("WebPPictureImportRGBA", [P, P, I], I),
                            ("WebPMemoryWriterInit", [P], None), ("WebPEncode", [P, P], I),
                            ("WebPPictureFree", [P], None), ("WebPMemoryWriterClear", [P], None)):
        getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
    cfg = _WebPConfig()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, 75.0, 0x020F):
        raise RuntimeError("WebPConfigInit failed")
    for k, v in config.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses the config {config}")
    pic = _WebPPicture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), 0x020F):
        raise RuntimeError("WebPPictureInit failed")
    pic.width, pic.height, pic.use_argb = W, H, int(bool(cfg.lossless))
    importer = lib.WebPPictureImportRGBA if C == 4 else lib.WebPPictureImportRGB
    if not importer(ctypes.byref(pic), img.ctypes.data_as(ctypes.c_void_p), W * C):
        raise RuntimeError("WebPPictureImport failed")
    writer = _WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
    pic.custom_ptr = ctypes.cast(ctypes.pointer(writer), ctypes.c_void_p)
    try:
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed, error {pic.error_code}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


# ---------------------------------------------------------------------------
# VP8 frames re-coded with what libwebp's encoder never writes
# ---------------------------------------------------------------------------

class _BoolEncoder:
    """VP8's boolean entropy encoder (RFC 6386, 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self) -> None:
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _riff_webp(chunks: Sequence[bytes]) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def webp_chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def vp8_recode(webp_file: bytes, partitions_log2: Optional[int] = None,
               lf_deltas: Optional[Sequence[int]] = None) -> bytes:
    """A lossy WebP file (one "VP8 " chunk) re-coded with the same boolean
    decisions but 2^partitions_log2 token partitions (libwebp's encoder
    writes one) and/or the loop-filter deltas `lf_deltas` (4 reference
    deltas, then 4 mode deltas, each in [-63, 63]; libwebp writes none).
    The decisions are recorded while iron_tpu_torch.data.webp decodes the
    frame; OpenCV stays the reference decoder of the result."""
    from iron_tpu_torch.data import webp as P
    assert webp_file[12:16] == b"VP8 "
    frame = webp_file[20:20 + struct.unpack("<I", webp_file[16:20])[0]]
    logs = []

    class Recorder(P._BoolDecoder):
        def __init__(self, data):
            super().__init__(data)
            self.log = []
            logs.append(self.log)

        def bit(self, prob):
            b = super().bit(prob)
            self.log.append((prob, b))
            return b

        def literal(self, n):
            self.log.append(("literal", n))
            return super().literal(n)

    reconstruct = P._reconstruct

    def marking(Y, U, V, mb_x, mb_y, mb_w, *rest):
        reconstruct(Y, U, V, mb_x, mb_y, mb_w, *rest)
        if mb_x == mb_w - 1:
            logs[1 + (mb_y & (len(logs) - 2))].append(("row", mb_y))

    P._BoolDecoder, P._reconstruct = Recorder, marking
    try:
        P.decode_vp8(frame)
    finally:
        P._BoolDecoder, P._reconstruct = Recorder.__bases__[0], reconstruct
    head = logs[0]
    sharp = head.index(("literal", 3))
    parts = head.index(("literal", 2), sharp)
    if partitions_log2 is not None:
        head[parts + 1:parts + 3] = [(128, (partitions_log2 >> 1) & 1), (128, partitions_log2 & 1)]
    if lf_deltas is not None:
        bits = [(128, 1), (128, 1)]
        for d in lf_deltas:
            bits.append((128, int(d != 0)))
            if d:
                bits += [(128, (abs(d) >> k) & 1) for k in range(5, -1, -1)] + [(128, int(d < 0))]
        head[sharp + 4:parts] = bits
    rows = {}
    for log in logs[1:]:
        cur = []
        for item in log:
            if item[0] == "row":
                rows[item[1]] = cur
                cur = []
            else:
                cur.append(item)
    n = 1 << (partitions_log2 if partitions_log2 is not None else
              (len(logs) - 2).bit_length())
    streams = []
    for k in [0] + list(range(1, n)):
        enc = _BoolEncoder()
        for y in sorted(rows):
            if y & (n - 1) == k:
                for prob, b in rows[y]:
                    enc.put(prob, b)
        streams.append(enc.flush())
    enc = _BoolEncoder()
    for item in head:
        if item[0] != "literal":
            enc.put(*item)
    part0 = enc.flush()
    tag = (len(part0) << 5) | (frame[0] & 0x1F)
    body = (struct.pack("<I", tag)[:3] + frame[3:10] + part0
            + b"".join(struct.pack("<I", len(s))[:3] for s in streams[:-1]) + b"".join(streams))
    return _riff_webp([webp_chunk(b"VP8 ", body)])


# ---------------------------------------------------------------------------
# JPEG 2000 through the system's OpenJPEG (openjpeg.h, libopenjp2.so.7, 2.5)
# ---------------------------------------------------------------------------

# byte offsets in opj_cparameters_t (sizeof 18720), found by filling the
# struct with a sentinel around opj_set_default_encoder_parameters;
# tests/test_torch_jp2_corners.py holds the defaults at these places
OPJ_CPARAMETERS_SIZE = 18720
OPJ_CP = {"tile_size_on": 0, "cp_tx0": 4, "cp_ty0": 8, "cp_tdx": 12, "cp_tdy": 16,
          "cp_disto_alloc": 20, "csty": 48, "prog_order": 52, "POC": 56, "numpocs": 4792,
          "tcp_numlayers": 4796, "tcp_rates": 4800, "numresolution": 5600,
          "cblockw_init": 5604, "cblockh_init": 5608, "mode": 5612, "irreversible": 5616,
          "roi_compno": 5620, "roi_shift": 5624, "res_spec": 5628, "prcw_init": 5632,
          "prch_init": 5764, "subsampling_dx": 18196, "subsampling_dy": 18200,
          "tp_on": 18696, "tp_flag": 18697, "tcp_mct": 18698}
_OPJ_POC_SIZE = 148             # opj_poc_t: resno0 +0, compno0 +4, layno1 +8, resno1 +12,
_OPJ_POC = {"resno0": 0, "compno0": 4, "layno1": 8, "resno1": 12, "compno1": 16, "prg1": 32,
            "tile": 48}         # compno1 +16, prg1 +32, tile (1-based) +48
_OPJ_PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
_OPJ_SPACE = {"unknown": -1, "unspecified": 0, "srgb": 1, "gray": 2, "sycc": 3, "eycc": 4,
              "cmyk": 5}


def libopenjp2():
    """The system's OpenJPEG 2.5 (libopenjp2.so.7), its encoder's entry points
    typed."""
    lib = ctypes.CDLL(ctypes.util.find_library("openjp2") or "libopenjp2.so.7")
    vp = ctypes.c_void_p
    for name, res, args in (
            ("opj_set_default_encoder_parameters", None, [vp]),
            ("opj_image_create", vp, [ctypes.c_uint32, vp, ctypes.c_int]),
            ("opj_create_compress", vp, [ctypes.c_int]),
            ("opj_setup_encoder", ctypes.c_int, [vp, vp, vp]),
            ("opj_stream_create_default_file_stream", vp, [ctypes.c_char_p, ctypes.c_int]),
            ("opj_start_compress", ctypes.c_int, [vp, vp, vp]),
            ("opj_encode", ctypes.c_int, [vp, vp]),
            ("opj_end_compress", ctypes.c_int, [vp, vp]),
            ("opj_stream_destroy", None, [vp]), ("opj_destroy_codec", None, [vp]),
            ("opj_image_destroy", None, [vp]),
            ("opj_set_MCT", ctypes.c_int, [vp, vp, vp, ctypes.c_uint32])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def openjpeg_encode(comps, *, j2k: bool = False, prec: int = 8, sub=None,
                    space: str = "srgb", irreversible: bool = False, mct: int = 0,
                    mode: int = 0, resolutions: int = 6, cblk=(64, 64), rates=(0,),
                    order: str = "LRCP", pocs=(), tile=None, tile_parts: str = "",
                    roi=None, precincts=None, sop: bool = False, eph: bool = False,
                    mct_matrix=None) -> bytes:
    """A JPEG 2000 file (.jp2, or a raw codestream with `j2k`) written by the
    system's OpenJPEG through ctypes, as its opj_compress sets it up.

    comps: an [H, W] or [H, W, C] array of unsigned samples, or a list of
    2-D arrays (components sub-sampled by `sub`, [(dx, dy)] each);
    `space` the image's colour space (JP2's 'colr' box: srgb 16, gray 17,
    sycc 18; OpenJPEG writes 0 for cmyk and eycc); `mode` the code-block
    style bits (1 BYPASS, 2 RESET, 4 TERMALL, 8 VSC, 16 PTERM, 32 SEGSYM);
    `rates` the layers' compression ratios (0 lossless); `pocs` the
    progression order changes, (resno0, compno0, layno1, resno1, compno1,
    order, tile) each with the tile 1-based; `tile` (width, height);
    `tile_parts` "R", "L" or "C" splits each tile's parts by resolution,
    layer or component; `roi` (component, shift) writes an RGN;
    `precincts` [(log2 width, log2 height)] from the top resolution down;
    `mct_matrix` a C x C float matrix for opj_set_MCT (Part 2)."""
    import os
    import tempfile
    if isinstance(comps, np.ndarray):
        comps = [comps] if comps.ndim == 2 else [comps[..., c] for c in range(comps.shape[2])]
    comps = [np.ascontiguousarray(c, np.int32) for c in comps]
    sub = sub or [(1, 1)] * len(comps)
    H, W = comps[0].shape[0] * sub[0][1], comps[0].shape[1] * sub[0][0]
    lib = libopenjp2()
    params = ctypes.create_string_buffer(OPJ_CPARAMETERS_SIZE)
    lib.opj_set_default_encoder_parameters(params)

    def put(field, fmt, value, at=0):
        struct.pack_into("<" + fmt, params, OPJ_CP[field] + at, value)

    put("tcp_numlayers", "i", len(rates))
    for i, r in enumerate(rates):
        put("tcp_rates", "f", float(r), 4 * i)
    put("cp_disto_alloc", "i", 1)
    put("numresolution", "i", resolutions)
    put("cblockw_init", "i", cblk[0])
    put("cblockh_init", "i", cblk[1])
    put("mode", "i", mode)
    put("irreversible", "i", int(irreversible))
    put("prog_order", "i", _OPJ_PROG[order])
    put("tcp_mct", "b", mct)
    put("csty", "i", (2 if sop else 0) | (4 if eph else 0) | (1 if precincts else 0))
    if precincts:
        put("res_spec", "i", len(precincts))
        for i, (pw, ph) in enumerate(precincts):
            put("prcw_init", "i", 1 << pw, 4 * i)
            put("prch_init", "i", 1 << ph, 4 * i)
    if tile:
        put("tile_size_on", "i", 1)
        put("cp_tdx", "i", tile[0])
        put("cp_tdy", "i", tile[1])
    if tile_parts:
        put("tp_on", "b", 1)
        put("tp_flag", "b", ord(tile_parts))
    if roi:
        put("roi_compno", "i", roi[0])
        put("roi_shift", "i", roi[1])
    put("numpocs", "I", len(pocs))
    for i, (r0, c0, l1, r1, c1, prg, t) in enumerate(pocs):
        base = _OPJ_POC_SIZE * i
        for k, v in zip(("resno0", "compno0", "layno1", "resno1", "compno1", "prg1", "tile"),
                        (r0, c0, l1, r1, c1, _OPJ_PROG[prg], t)):
            put("POC", "I", v, base + _OPJ_POC[k])
    keep = []
    if mct_matrix is not None:
        m = np.ascontiguousarray(mct_matrix, np.float32)
        shift = np.zeros(len(comps), np.int32)
        keep += [m, shift]
        if not lib.opj_set_MCT(params, m.ctypes.data, shift.ctypes.data, len(comps)):
            raise ValueError("opj_set_MCT failed")
    cparms = (ctypes.c_uint32 * (9 * len(comps)))()
    for i, (c, (dx, dy)) in enumerate(zip(comps, sub)):
        cparms[9 * i:9 * i + 9] = [dx, dy, c.shape[1], c.shape[0], 0, 0, prec, prec, 0]
    image = lib.opj_image_create(len(comps), cparms, _OPJ_SPACE[space])
    if not image:
        raise ValueError("opj_image_create failed")
    fd, path = tempfile.mkstemp(suffix=".j2k" if j2k else ".jp2")
    os.close(fd)
    codec = stream = None
    try:
        ctypes.memmove(image, struct.pack("<IIII", 0, 0, W, H), 16)
        comp_at = ctypes.c_void_p.from_address(image + 24).value
        for i, c in enumerate(comps):
            data = ctypes.c_void_p.from_address(comp_at + 64 * i + 48).value
            ctypes.memmove(data, c.ctypes.data, c.nbytes)
        codec = lib.opj_create_compress(0 if j2k else 2)
        if not lib.opj_setup_encoder(codec, params, image):
            raise ValueError("opj_setup_encoder failed")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        if not (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
                and lib.opj_end_compress(codec, stream)):
            raise ValueError("OpenJPEG failed to encode")
        lib.opj_stream_destroy(stream)
        stream = None
        with open(path, "rb") as f:
            return f.read()
    finally:
        if stream:
            lib.opj_stream_destroy(stream)
        if codec:
            lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
        os.remove(path)


# ---------------------------------------------------------------------------
# JPEG 2000 packet headers moved into PPM / PPT markers
# ---------------------------------------------------------------------------

def _packet_spans(cs: bytes):
    """{tile: (its data, [(start, header end, end)])} of the packets in each
    tile's data (the tile-parts' bytes joined), read with the port's tier-2
    parser (the files built from them are judged by OpenCV)."""
    from iron_tpu_torch.data import jp2 as J
    info = J.parse_codestream(cs)
    out = {}
    align, read = J._Bits.align, J._read_packet
    for t in sorted(info["tiles"]):
        heads, spans = [], []

        def recording_align(bits):
            heads.append(align(bits))
            return heads[-1]

        def recording_read(buf, pos, *a):
            spans.append((pos, read(buf, pos, *a)))
            return spans[-1][1]

        J._Bits.align, J._read_packet = recording_align, recording_read
        try:
            J._decode_tile(info, t)
        finally:
            J._Bits.align, J._read_packet = align, read
        out[t] = (info["tiles"][t][1], [(a, h, b) for (a, b), h in zip(spans, heads)])
    return info, out


def _one_part_tiles(cs: bytes):
    """(main header, [(tile, its tile-part header markers, data)]) of a
    codestream of one tile-part a tile, in tile order."""
    pos = cs.index(b"\xff\x90")
    main, parts = cs[:pos], []
    while cs[pos:pos + 2] == b"\xff\x90":
        isot, psot = struct.unpack_from(">HI", cs, pos + 4)
        sod = cs.index(b"\xff\x93", pos)
        parts.append((isot, cs[pos + 12:sod], cs[sod + 2:pos + psot]))
        pos += psot
    return main, parts


def pack_packet_headers(cs: bytes, kind: str, chunk: int = 0) -> bytes:
    """The codestream with its packet headers moved into PPM markers (main
    header; Nppm before each tile-part's headers) or PPT markers (each
    tile-part header), cut into markers of at most `chunk` bytes where
    given; the tiles' data keep the packets' bodies."""
    _, spans = _packet_spans(cs)
    main, parts = _one_part_tiles(cs)
    heads, bodies = {}, {}
    for t, (data, packets) in spans.items():
        heads[t] = b"".join(data[a:h] for a, h, _ in packets)
        bodies[t] = b"".join(data[h:b] for _, h, b in packets)

    def cut(payload: bytes):
        size = chunk or 65000
        return [payload[i:i + size] for i in range(0, len(payload), size)] or [b""]

    def markers(code: int, pieces) -> bytes:
        return b"".join(struct.pack(">HHB", code, 3 + len(p), z) + p
                        for z, p in enumerate(pieces))

    if kind == "PPM":               # an Nppm field is never cut (OpenJPEG stops there)
        pieces = []
        for t, _, _ in parts:
            run = cut(heads[t])
            pieces += [struct.pack(">I", len(heads[t])) + run[0]] + run[1:]
        main += markers(0xFF60, pieces)
    out = [main]
    for t, marks, _ in parts:
        marks += markers(0xFF61, cut(heads[t])) if kind == "PPT" else b""
        out.append(struct.pack(">HHHIBB", 0xFF90, 10, t, 14 + len(marks) + len(bodies[t]), 0, 1)
                   + marks + b"\xff\x93" + bodies[t])
    return b"".join(out) + b"\xff\xd9"
