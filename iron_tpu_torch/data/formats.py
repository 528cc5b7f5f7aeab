"""The image formats the JAX package reads through OpenCV besides PNG, JPEG,
EXR, TIFF and WebP, on numpy: BMP, PNM (PBM, PGM, PPM), PAM, PFM, Radiance
HDR, Sun raster and GIF; and their writers.

Each reader takes the file's bytes and returns what cv2.imread(path,
IMREAD_UNCHANGED) returns, bit for bit, with the channels in RGB(A) order
(OpenCV's are BGR(A)): [H, W] for a gray image, [H, W, 3] or [H, W, 4].
Where OpenCV's decoder departs from the format's documents, the reader
follows OpenCV (each such place says so), since the JAX package reads
through it.  What OpenCV refuses raises ValueError (`io.NoImage` where
OpenCV reads no image from the file), and so does a damaged file OpenCV
reads no image from: the pixel data or the header ends early, a GIF
without its trailer, with a frame past its screen or LZW data that does
not fill its frame exactly, bad Radiance scanlines.

Each writer takes uint8 samples in RGB(A) order and returns the bytes
cv2.imwrite writes from the same samples in BGR(A) order: BMP, PNM, PAM,
Sun raster, PFM and Radiance byte for byte (OpenCV's encoders are
deterministic); GIF the port's own (OpenCV's maps colours to a fixed
palette).  What OpenCV writes no readable file of raises ValueError.
"""
from __future__ import annotations

import struct
from typing import List

import numpy as np

from iron_tpu_torch.data.io import NoImage, c_int, c_strtol, check_size


def _gray(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_BGR2Gray_8u_C3C1R (14-bit fixed point): the gray of
    BGR samples [..., 3]."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    return ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).astype(np.uint8)


def _rgb(bgr: np.ndarray) -> np.ndarray:
    return bgr[..., [2, 1, 0, 3][:bgr.shape[-1]]]


def _unpack(rows: np.ndarray, bpp: int, width: int) -> np.ndarray:
    """Rows of packed samples (uint8 [h, pitch], most significant first)
    -> the sample values [h, width]."""
    if bpp == 8:
        return rows[:, :width]
    bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, bpp)
    return bits.dot(1 << np.arange(bpp - 1, -1, -1))[:, :width].astype(np.uint8)


def _is_color(palette_bgr: np.ndarray) -> bool:
    """OpenCV's IsColorPalette: any entry whose three samples differ."""
    return bool(np.any(palette_bgr != palette_bgr[:, :1]))


# ---------------------------------------------------------------------------
# BMP (OpenCV's grfmt_bmp.cpp)
# ---------------------------------------------------------------------------

def _bmp_rle(data: bytes, pos: int, W: int, H: int, four: bool) -> np.ndarray:
    """RLE8 / RLE4 data -> palette indices [H, W] in file row order
    (bottom row first).  As OpenCV decodes it: a pixel the codes skip
    (end of line, delta, end of bitmap) takes index 0; an RLE8 run that
    ends at the end of its row moves to the next row, and an end-of-line
    right after it is then ignored; a run past the end of its row ends the
    decoding."""
    idx = np.zeros(H * W, np.uint8)
    x = y = 0
    line_end_flag = 0
    n = len(data)

    def skip(count: int) -> None:
        nonlocal x, y
        while True:                          # OpenCV's FillUniColor
            take = min(count, W - x)
            x += take
            count -= take
            if x >= W:
                x, y = 0, y + 1
                if y >= H:
                    return
            if count <= 0:
                return

    while y < H:
        if pos + 2 > n:
            raise NoImage("BMP: the RLE data ends before the image (OpenCV returns no image)")
        length, code = data[pos], data[pos + 1]
        pos += 2
        if length:                           # a run
            if x + length > W:
                break
            if four:
                vals = np.array([code >> 4, code & 15], np.uint8)[np.arange(length) & 1]
            else:
                vals = code
            idx[y * W + x:y * W + x + length] = vals
            x += length
            prev = y
            if x >= W and not four:
                x, y = 0, y + 1
            line_end_flag = y - prev
        elif code > 2:                       # absolute mode
            if x + code > W:
                break
            if four:
                size = (((code + 1) >> 1) + 1) & ~1
                raw = np.frombuffer(data[pos:pos + size], np.uint8)
                vals = np.stack([raw >> 4, raw & 15], -1).reshape(-1)[:code]
            else:
                size = (code + 1) & ~1
                vals = np.frombuffer(data[pos:pos + code], np.uint8)
            if pos + size > n:
                raise NoImage("BMP: the RLE data ends before the image (OpenCV returns no "
                              "image)")
            pos += size
            idx[y * W + x:y * W + x + code] = vals
            x += code
            line_end_flag = 0
        else:                                # end of line, end of bitmap, delta
            count, dy = W - x, H - y
            if four or code or not line_end_flag or count < W:
                if code == 2:
                    if pos + 2 > n:
                        raise NoImage("BMP: the RLE data ends before the image (OpenCV returns "
                                      "no image)")
                    count, dy = data[pos], data[pos + 1]
                    pos += 2
                if code:
                    count += dy * W
                skip(count)
            line_end_flag = 0
    return idx.reshape(H, W)


def read_bmp(data: bytes) -> np.ndarray:
    """Windows BMP: 1, 4, 8 bits with a palette (RLE4 / RLE8 too), 16 bits
    (5-5-5, or 5-6-5 by its bit fields), 24 and 32 bits; bottom-up or
    top-down; the OS/2 12-byte header.  As OpenCV: a palette of grays gives
    one channel (so does every OS/2 file: OpenCV's 12-byte branch never
    marks a file colour); 32 bits with bit fields keep their fourth byte as
    alpha, 32 bits without drop it."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")

    def need(n: int) -> None:                # OpenCV's stream throws at the file's end
        if len(data) < n:
            raise NoImage("BMP: the file ends in its header (OpenCV returns no image)")

    need(18)
    offset, size = struct.unpack("<ii", data[10:18])
    color, bitfields = False, False
    if size <= 0:
        raise NoImage(f"BMP: an info header size of {size} (OpenCV asserts it is positive; no "
                      f"image)")
    if size >= 36:
        need(50)
        W, H, planes_bpp, comp = struct.unpack("<iiIi", data[18:34])
        bpp = planes_bpp >> 16
        clrused = struct.unpack("<i", data[46:50])[0]
        if not 0 <= comp <= 3:
            raise NoImage(f"BMP: compression {comp} (OpenCV asserts 0 to 3; no image)")
        ok = (((bpp in (1, 4, 8, 16, 24, 32)) and comp == 0) or (bpp in (16, 32) and comp == 3)
              or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1))
        if not (W > 0 and H != 0 and ok):
            raise NoImage(f"BMP: a {W} x {H} image of {bpp} bits a pixel with compression "
                          f"{comp} (OpenCV reads 1/4/8/16/24/32 bits, RLE4 / RLE8, 16 / 32-bit bit "
                          f"fields; no image)")
        color = True
        pal_at = 14 + size                   # OpenCV skips the rest of the header
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise NoImage(f"BMP: {clrused} palette entries (OpenCV asserts 0 to 256; no "
                              f"image)")
            count = clrused or 1 << bpp
            need(pal_at + 4 * count)
            palette = np.zeros((256, 4), np.uint8)
            palette[:count] = np.frombuffer(data[pal_at:pal_at + 4 * count],
                                            np.uint8).reshape(-1, 4)
            palette = palette[:, :3]
            color = _is_color(palette[:1 << bpp])
        elif bpp == 16 and comp == 3:
            # OpenCV reads the masks from just past the header, wherever the
            # header keeps them
            need(pal_at + 12)
            r, g, b = struct.unpack("<III", data[pal_at:pal_at + 12])
            if (b, g, r) == (0x1F, 0x3E0, 0x7C00):
                bpp = 15
            elif (b, g, r) != (0x1F, 0x7E0, 0xF800):
                raise NoImage("BMP: 16-bit bit fields other than 5-5-5 and 5-6-5 (OpenCV returns "
                              "no image)")
        elif bpp == 16:
            bpp = 15
        bitfields = comp == 3
    elif size == 12:
        need(26)
        W, H, planes_bpp = struct.unpack("<HHI", data[18:26])
        bpp = planes_bpp >> 16
        comp = 0
        if not (W > 0 and H != 0 and bpp in (1, 4, 8, 24, 32)):
            raise NoImage(f"BMP: OS/2 file with {bpp} bits a pixel (OpenCV returns no image)")
        if bpp <= 8:
            need(26 + 3 * (1 << bpp))
            raw = np.frombuffer(data[26:26 + 3 * (1 << bpp)], np.uint8).reshape(-1, 3)
            palette = np.zeros((256, 3), np.uint8)
            palette[:len(raw)] = raw
    else:
        raise NoImage(f"BMP: an info header of {size} bytes (OpenCV returns no image)")
    check_size(W, abs(H), "BMP")
    if offset < 0:
        raise NoImage(f"BMP: pixel data at offset {offset} (OpenCV returns no image)")
    top_down, H = H < 0, abs(H)
    pitch = ((W * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
    if comp in (1, 2):
        idx = _bmp_rle(data, offset, W, H, four=comp == 2)
        bgr = palette[idx]
    else:
        if offset + pitch * H > len(data):
            raise NoImage("BMP: the pixel data ends before the image (OpenCV returns no image)")
        rows = np.frombuffer(data[offset:offset + pitch * H], np.uint8).reshape(H, pitch)
        if bpp <= 8:
            bgr = palette[_unpack(rows, bpp, W)]
        elif bpp in (15, 16):
            t = rows[:, :2 * W].copy().view("<u2").astype(np.int64)
            if bpp == 15:
                bgr = np.stack([t << 3, (t >> 2) & ~7, (t >> 7) & ~7], -1)
            else:
                bgr = np.stack([t << 3, (t >> 3) & ~3, (t >> 8) & ~7], -1)
            bgr = (bgr & 255).astype(np.uint8)
        else:
            bgr = rows[:, :W * bpp // 8].reshape(H, W, bpp // 8)
            if not (bpp == 32 and bitfields and color):
                bgr = bgr[..., :3]
    if not top_down:
        bgr = bgr[::-1]
    if not color:
        return _gray(bgr[..., :3])
    return np.ascontiguousarray(_rgb(bgr))


def write_bmp(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, 1] (8 bits with a gray palette), [H, W, 3]
    (RGB, 24 bits) or [H, W, 4] (RGBA, 32 bits) as cv2.imwrite writes BMP:
    bottom-up, rows padded to 4 bytes, a 40-byte header (no colour count
    given, though a gray image has its 256-entry palette), or for four
    channels a 124-byte V5 header with BI_BITFIELDS masks of BGRA and the
    colour space 'sRGB' (all else zero)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or not (img.ndim == 2 or img.shape[2] in (3, 4)):
        raise ValueError(f"write_bmp takes uint8 [H, W] or [H, W, 3 / 4], got {img.dtype} "
                         f"{img.shape}")
    H, W = img.shape[:2]
    if img.ndim == 2:
        bpp, pixels = 8, img
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, 1)
        palette[:, 3] = 0
        pal = palette.tobytes()
    else:
        C = img.shape[2]
        bpp, pal = 8 * C, b""
        pixels = img[..., [2, 1, 0, 3][:C]].reshape(H, W * C)
    pitch = (W * bpp // 8 + 3) & ~3
    rows = np.zeros((H, pitch), np.uint8)
    rows[:, :pixels.shape[1]] = pixels
    if bpp == 32:
        info = (struct.pack("<IiiHHIIiiII", 124, W, H, 1, 32, 3, 0, 0, 0, 0, 0)
                + struct.pack("<4I", 0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)
                + b"BGRs" + bytes(64))
    else:
        info = struct.pack("<IiiHHIIiiII", 40, W, H, 1, bpp, 0, 0, 0, 0, 0, 0)
    offset = 14 + len(info) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + pitch * H, 0, 0, offset)
    return head + info + pal + rows[::-1].tobytes()


# ---------------------------------------------------------------------------
# PNM: PBM, PGM, PPM (OpenCV's grfmt_pxm.cpp)
# ---------------------------------------------------------------------------

class _Tokens:
    """OpenCV's ReadNumber over a PNM file: skip blanks and '#' comments,
    read decimal digits (at most `maxdigits`), and swallow the one byte
    that ends a number (so a number may not end the file)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise NoImage("PNM: unexpected end of the file")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def number(self, maxdigits: int = 0) -> int:
        c = self.byte()
        while not 48 <= c <= 57:
            if c == ord("#"):
                while c not in (10, 13):
                    c = self.byte()
                c = self.byte()
            elif c in b" \t\n\v\f\r":
                while c in b" \t\n\v\f\r":
                    c = self.byte()
            else:
                raise NoImage(f"PNM: unexpected byte {c:#x} where a number should be (OpenCV "
                              f"returns no image)")
        val, digits = 0, 0
        while True:
            val = 10 * val + c - 48
            if val > 2 ** 31 - 1:
                raise NoImage("PNM: a number past INT_MAX (OpenCV returns no image)")
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            c = self.byte()
            if not 48 <= c <= 57:
                break
        return val


def read_pnm(data: bytes) -> np.ndarray:
    """PBM, PGM and PPM, ASCII (P1-P3) or binary (P4-P6), 8 or 16 bits a
    sample.  As OpenCV reads them: a bitmap's 1 is black (0) and 0 white
    (255); an ASCII sample of at most 8 bits is scaled to 255 by its
    maxval (x 255 / maxval, truncated, clamped to maxval first), a binary
    one is kept as stored, and 16-bit samples (maxval above 255) are kept
    as stored."""
    if len(data) < 3 or data[0] != ord("P") or data[1] not in b"123456":
        raise ValueError("not a PNM file")
    kind = data[1] - 48
    binary = kind >= 4
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    tok = _Tokens(data, 2)
    W, H = tok.number(), tok.number()
    maxval = 1 if bpp == 1 else tok.number()
    if W <= 0 or H <= 0 or not 0 < maxval <= 65535:
        raise NoImage(f"PNM: a {W}x{H} image with maxval {maxval} (OpenCV returns no image)")
    check_size(W, H, "PNM")
    C = 3 if bpp == 24 else 1
    wide = maxval > 255
    if bpp == 1:
        if binary:
            pitch = (W + 7) // 8
            start = tok.pos
            if start + pitch * H > len(data):
                raise NoImage("PNM: the pixel data ends before the image (OpenCV returns no "
                              "image)")
            rows = np.frombuffer(data[start:start + pitch * H], np.uint8).reshape(H, pitch)
            bits = _unpack(rows, 1, W)
        else:
            bits = np.array([tok.number(1) != 0 for _ in range(W * H)], np.uint8).reshape(H, W)
        return np.where(bits == 1, 0, 255).astype(np.uint8)
    if binary:
        start = tok.pos
        n = W * H * C * (2 if wide else 1)
        if start + n > len(data):
            raise NoImage("PNM: the pixel data ends before the image (OpenCV returns no image)")
        img = np.frombuffer(data[start:start + n], ">u2" if wide else np.uint8)
        img = img.astype(np.uint16 if wide else np.uint8)
    else:
        vals = np.minimum([tok.number() for _ in range(W * H * C)], maxval)
        if wide:
            img = vals.astype(np.uint16)
        else:
            img = (vals * 255 // maxval).astype(np.uint8)
    img = img.reshape(H, W, C)
    return img[..., 0] if C == 1 else img


def write_pnm(img: np.ndarray, kind: str) -> bytes:
    """uint8 / uint16 [H, W] or [H, W, 3] as cv2.imwrite writes `kind`
    ("pbm", "pgm", "ppm" or "pnm"): binary P4 (a pixel of 0 black, any
    other white), P5 or P6 (".pnm": P5 for one channel, P6 for three).  A
    PGM or PBM takes one channel and a PPM three, as OpenCV requires."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    C = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype not in (np.uint8, np.uint16) or C not in (1, 3):
        raise ValueError(f"write_pnm takes uint8 / uint16 [H, W] or [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    if kind == "pnm":
        kind = "pgm" if C == 1 else "ppm"
    if (kind == "ppm") != (C == 3):
        raise ValueError(f"a .{kind} file holds {'three channels' if kind == 'ppm' else 'one'}"
                         f"; the image has {C}")
    H, W = img.shape[:2]
    if kind == "pbm":
        if img.dtype != np.uint8:
            raise ValueError("a .pbm file is written from 8-bit samples")
        bits = np.packbits((img == 0).astype(np.uint8), axis=1)
        return b"P4\n%d %d\n" % (W, H) + bits.tobytes()
    maxval = 255 if img.dtype == np.uint8 else 65535
    head = b"%s\n%d %d\n%d\n" % (b"P5" if C == 1 else b"P6", W, H, maxval)
    return head + img.astype(">u2" if maxval > 255 else np.uint8).tobytes()


# ---------------------------------------------------------------------------
# PFM (OpenCV's grfmt_pfm.cpp)
# ---------------------------------------------------------------------------

_C_FLOAT = None


def _c_atof(field: bytes) -> float:
    """C's atof on the C string `field` (it ends at a NUL): the longest
    leading decimal number, inf or nan; 0.0 where there is none."""
    import re
    global _C_FLOAT
    if _C_FLOAT is None:
        _C_FLOAT = re.compile(rb"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf(?:inity)?|nan)",
                              re.IGNORECASE)
    m = _C_FLOAT.match(field.split(b"\0", 1)[0])
    return float(m.group()) if m else 0.0


def read_pfm(data: bytes) -> np.ndarray:
    """Portable float map: "PF" (three channels) or "Pf" (one), rows bottom
    first, little-endian when the scale is negative.  As OpenCV: the
    samples come out multiplied by the float 1 / |scale|.  OpenCV's header:
    a line break after "PF", then three fields, each ending at one blank
    (a byte above 127 in one gives no image), read by atoi, atoi and atof
    (so "5f" is 5 and "x" is 0); a scale of 0 or NaN gives no image."""
    if len(data) < 3 or data[:2] not in (b"PF", b"Pf") or data[2:3] != b"\n":
        raise NoImage("PFM: no line break after 'PF' (OpenCV returns no image)")
    C = 3 if data[1:2] == b"F" else 1
    pos, fields = 3, []
    for _ in range(3):                       # each field ends at one blank
        end = pos
        while end < len(data) and data[end] not in b" \t\n\v\f\r" and end - pos < 2048:
            if data[end] > 127:
                raise NoImage("PFM: a header byte above 127 (OpenCV's read_number asserts; no "
                              "image)")
            end += 1
        if end >= len(data):
            raise NoImage("PFM: the file ends in its header (OpenCV returns no image)")
        fields.append(data[pos:end])
        pos = end + (end - pos < 2048)
    (W, _, _), (H, _, _) = c_strtol(fields[0]), c_strtol(fields[1])
    W, H = (c_int(max(min(v, 2 ** 63 - 1), -2 ** 63)) for v in (W, H))
    check_size(W, H, "PFM")
    scale = _c_atof(fields[2])
    n = W * H * C * 4
    if pos + n > len(data):
        raise NoImage("PFM: the pixel data ends before the image (OpenCV returns no image)")
    if not abs(scale) > 0:
        raise NoImage(f"PFM: a scale of {scale} (OpenCV asserts |scale| > 0; no image)")
    img = np.frombuffer(data[pos:pos + n], "<f4" if scale < 0 else ">f4").astype(np.float32)
    img = img.reshape(H, W, C)[::-1] * np.float32(1.0 / abs(scale))
    return img[..., 0] if C == 1 else np.ascontiguousarray(img)


def write_pfm(img: np.ndarray) -> bytes:
    """uint8 or float32 [H, W] or [H, W, 3] (RGB) as cv2.imwrite writes PFM:
    "Pf" (one channel) or "PF" (three, in RGB order), the size, scale -1
    (little-endian), the rows bottom first as float32, 8-bit values
    unscaled (95 -> 95.0).  OpenCV writes nothing readable for other
    channel counts (one byte, "P"), so they raise."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    C = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype not in (np.uint8, np.float32) or C not in (1, 3):
        raise ValueError(f"write_pfm takes uint8 / float32 [H, W] or [H, W, 3], got "
                         f"{img.dtype} {img.shape} (OpenCV writes no readable PFM from "
                         f"{C} channels)")
    H, W = img.shape[:2]
    head = b"%s\n%d %d\n-1\n" % (b"PF" if C == 3 else b"Pf", W, H)
    return head + np.ascontiguousarray(img[::-1], "<f4").tobytes()


# ---------------------------------------------------------------------------
# Radiance HDR (OpenCV's rgbe.cpp, after Bruce Walter's rgbe.c)
# ---------------------------------------------------------------------------

def _rgbe_float(rgbe: np.ndarray) -> np.ndarray:
    """rgbe2float: [..., 4] uint8 -> float32 [..., 3]: each of R, G, B
    times the float 2^(E - 136), or 0 where E is 0."""
    e = rgbe[..., 3].astype(np.int64)
    f = np.ldexp(1.0, e - 136).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * f[..., None]
    return np.where((e > 0)[..., None], out, np.float32(0)).astype(np.float32)


def _scan_size(line: bytes):
    """sscanf(line, "-Y %d +X %d", &H, &W) as rgbe.c calls it: (H, W), or
    None where fewer than two numbers convert (a blank in the format takes
    any run of blanks, none too; %d skips blanks, takes a sign and the
    digits after it; the line ends at a NUL)."""
    line = line.split(b"\0", 1)[0]
    pos, out = 0, []
    for part in (b"-Y", b" ", b"%d", b" ", b"+X", b" ", b"%d"):
        if part == b" ":
            while pos < len(line) and line[pos] in b" \t\n\v\f\r":
                pos += 1
        elif part == b"%d":
            v, ok, end = c_strtol(line[pos:])
            if not ok:
                return None
            out.append(c_int(v))
            pos += end
        elif line[pos:pos + 2] != part:
            return None
        else:
            pos += 2
    return tuple(out)


def read_hdr(data: bytes) -> np.ndarray:
    """Radiance RGBE ("#?RADIANCE" / "#?RGBE", FORMAT=32-bit_rle_rgbe,
    "-Y H +X W") -> float32 [H, W, 3] (RGB), flat or with the new-style
    run-length scanlines (OpenCV refuses FORMAT=32-bit_rle_xyze).  As OpenCV's rgbe.c: a file whose first
    scanline is not new-style RLE is read flat from there on (old-style
    run pixels, (1, 1, 1, n), are taken as the pixels they spell)."""
    if not (data.startswith(b"#?RGBE") or data.startswith(b"#?RADIANCE")):
        raise ValueError("not a Radiance HDR file")
    lines, pos = [], 0
    while True:                              # fgets: lines of at most 127 bytes
        end = data.find(b"\n", pos, pos + 127)
        end = pos + 127 if end < 0 else end + 1
        if pos >= len(data):
            raise NoImage("HDR: the file ends in its header (OpenCV returns no image)")
        lines.append(data[pos:end])
        pos = end
        line = lines[-1]
        if line == b"\n" or line[:1] == b"\x00":
            break
    if b"FORMAT=32-bit_rle_rgbe\n" not in lines[1:] or lines[-1] != b"\n":
        raise NoImage("HDR: no FORMAT=32-bit_rle_rgbe line or no blank line after the "
                      "header (OpenCV reads no other)")
    end = data.find(b"\n", pos, pos + 127)
    end = pos + 127 if end < 0 else end + 1
    size = _scan_size(data[pos:end])
    pos = end
    if pos >= len(data):
        raise NoImage("HDR: the file ends in its header (OpenCV returns no image)")
    if size is None:
        raise NoImage(f"HDR: no '-Y H +X W' line (rgbe.c's sscanf fails; OpenCV returns no "
                      f"image)")
    H, W = size
    if W <= 0 or H <= 0:
        raise NoImage(f"HDR: an image of {W} x {H} pixels (OpenCV's reader returns no image)")
    check_size(W, H, "HDR")
    out = np.zeros((H * W, 4), np.uint8)
    row = 0
    if 8 <= W <= 0x7FFF:
        while row < H:
            if pos + 4 > len(data):
                raise NoImage("HDR: the pixel data ends before the image (OpenCV returns no "
                              "image)")
            head = data[pos:pos + 4]
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                break                        # not new-style RLE: flat from here
            if (head[2] << 8 | head[3]) != W:
                raise NoImage("HDR: a scanline of the wrong width (rgbe.c stops; OpenCV returns "
                              "no image)")
            pos += 4
            line = np.empty(4 * W, np.uint8)
            p = 0
            for ch in range(4):
                stop = (ch + 1) * W
                while p < stop:
                    if pos + 2 > len(data):
                        raise NoImage("HDR: the pixel data ends before the image (OpenCV "
                                      "returns no image)")
                    count = data[pos]
                    if count > 128:
                        count -= 128
                        if count > stop - p:
                            raise NoImage("HDR: bad scanline data (rgbe.c stops; OpenCV returns "
                                          "no image)")
                        line[p:p + count] = data[pos + 1]
                        pos += 2
                    else:
                        if count == 0 or count > stop - p:
                            raise NoImage("HDR: bad scanline data (rgbe.c stops; OpenCV returns "
                                          "no image)")
                        if pos + 1 + count > len(data):
                            raise NoImage("HDR: the pixel data ends before the image (OpenCV "
                                          "returns no image)")
                        line[p:p + count] = np.frombuffer(data[pos + 1:pos + 1 + count],
                                                          np.uint8)
                        pos += 1 + count
                    p += count
            out[row * W:(row + 1) * W] = line.reshape(4, W).T
            row += 1
    rest = (H - row) * W
    if rest:
        if pos + 4 * rest > len(data):
            raise NoImage("HDR: the pixel data ends before the image (OpenCV returns no image)")
        out[row * W:] = np.frombuffer(data[pos:pos + 4 * rest], np.uint8).reshape(-1, 4)
    return _rgbe_float(out).reshape(H, W, 3)


def _float_rgbe(rgb: np.ndarray) -> np.ndarray:
    """rgbe.c's float2rgbe: float32 [..., 3] -> uint8 [..., 4]: the largest
    sample v split as m 2^e (frexp), each sample times the float m 256 / v,
    truncated; all zero where v < 1e-32."""
    v = rgb.max(axis=-1)
    m, e = np.frexp(v)
    big = v >= 1e-32
    scale = (m.astype(np.float64) * 256.0 / np.where(big, v, 1)).astype(np.float32)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    out[..., 3] = e + 128
    out[~big] = 0
    return out


def _rle_bytes(d: np.ndarray) -> bytes:
    """rgbe.c's RGBE_WriteBytes_RLE on one channel of a scanline: the
    bytes as runs of equal values (each at most 127, cut from its start);
    a run of 4 or more written as a run (128 + length, value); the bytes
    before it as literals (length up to 128, the bytes), or as a run when
    they are a single run of 2 or 3."""
    n = len(d)
    starts = np.concatenate([[0], np.nonzero(d[1:] != d[:-1])[0] + 1])
    lens = np.diff(np.concatenate([starts, [n]]))
    pieces = -(-lens // 127)                          # a maximal run cut into pieces
    pstart = np.repeat(starts, pieces) + 127 * (np.arange(pieces.sum())
                                                 - np.repeat(np.cumsum(pieces) - pieces, pieces))
    plen = np.minimum(np.repeat(starts + lens, pieces) - pstart, 127)
    out = bytearray()
    cur = 0

    def pending(end: int, last: int) -> None:
        nonlocal cur
        if cur == end:
            return
        if last >= 0 and 1 < plen[last] == end - cur:   # one short run
            out.extend((128 + int(plen[last]), int(d[cur])))
            cur = end
        while cur < end:
            k = min(end - cur, 128)
            out.append(k)
            out.extend(d[cur:cur + k].tobytes())
            cur += k

    for i in np.nonzero(plen >= 4)[0].tolist():
        pending(int(pstart[i]), i - 1)
        out.extend((128 + int(plen[i]), int(d[pstart[i]])))
        cur += int(plen[i])
    pending(n, len(plen) - 1)
    return bytes(out)


def write_hdr(img: np.ndarray) -> bytes:
    """uint8 or float32 [H, W] or [H, W, 3] (RGB) as cv2.imwrite writes
    Radiance HDR: gray repeated to three channels, 8-bit samples times the
    float 1 / 255, "#?RADIANCE", FORMAT=32-bit_rle_rgbe, "-Y H +X W", then
    RGBE pixels, each scanline in the new run-length form when 8 <= W <=
    32767 (its four channels coded apart), else flat.  OpenCV writes no
    file for four channels, so they raise."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype not in (np.uint8, np.float32) or not (img.ndim == 2 or img.shape[2] == 3):
        raise ValueError(f"write_hdr takes uint8 / float32 [H, W] or [H, W, 3], got "
                         f"{img.dtype} {img.shape} (OpenCV writes no HDR file from four "
                         f"channels)")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) * (np.float32(1) / np.float32(255))
    H, W = img.shape[:2]
    rgbe = _float_rgbe(img)
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (H, W)]
    if not 8 <= W <= 0x7FFF:
        return out[0] + rgbe.tobytes()
    head = bytes((2, 2, W >> 8, W & 255))
    for row in rgbe:
        out.append(head)
        out.extend(_rle_bytes(row[:, c]) for c in range(4))
    return b"".join(out)


# ---------------------------------------------------------------------------
# Sun raster (OpenCV's grfmt_sunras.cpp)
# ---------------------------------------------------------------------------

_RAS_MAGIC = b"\x59\xa6\x6a\x95"


def read_sunras(data: bytes) -> np.ndarray:
    """Sun raster, old or standard type: 1 or 8 bits with or without a
    colour map, 24 and 32 bits (BGR; a 32-bit pixel's first byte dropped).
    As OpenCV: a map of grays gives one channel; a gray image without a
    map (1 or 8 bits) reads as all zeros, since OpenCV fills its gray
    look-up table only from a map; byte-encoded (RLE) and RGB-order files
    give no image."""
    if data[:4] != _RAS_MAGIC:
        raise ValueError("not a Sun raster file")
    if len(data) < 32:
        raise NoImage("Sun raster: the file ends in its header (OpenCV returns no image)")
    W, H, bpp, _, enc, maptype, maplen = struct.unpack(">3i4I", data[4:32])
    if enc in (2, 3):
        raise NoImage(f"Sun raster: {('byte-encoded (RLE)', 'RGB-order')[enc - 2]} files are "
                      f"not read (OpenCV returns no image for them)")
    if not (W > 0 and H > 0 and bpp in (1, 8, 24, 32) and enc in (0, 1) and
            ((maptype == 0 and maplen == 0) or
             (maptype == 1 and 0 < maplen <= 3 * (1 << bpp) and bpp <= 8))):
        raise NoImage(f"Sun raster: a {W} x {H} image of {bpp} bits, type {enc}, map type "
                      f"{maptype} ({maplen} bytes): OpenCV's header check fails (no image)")
    if 32 + maplen > len(data):
        raise NoImage("Sun raster: the file ends in its colour map (OpenCV returns no image)")
    check_size(W, H, "Sun raster")
    pos = 32 + maplen
    rowlen = (W * bpp + 7) // 8
    pitch = (rowlen + 1) & ~1
    if pos + pitch * H > len(data):
        raise NoImage("Sun raster: the pixel data ends before the image (OpenCV returns no "
                      "image)")
    rows = np.frombuffer(data[pos:pos + pitch * H], np.uint8).reshape(H, pitch)
    if bpp > 8:
        bgr = rows[:, :rowlen].reshape(H, W, bpp // 8)[..., -3:]
        return np.ascontiguousarray(_rgb(bgr))
    if not maplen:
        return np.zeros((H, W), np.uint8)
    m = np.frombuffer(data[32:pos], np.uint8)
    k = maplen // 3
    palette = np.zeros((256, 3), np.uint8)
    palette[:k] = np.stack([m[2 * k:3 * k], m[k:2 * k], m[:k]], -1)   # BGR
    bgr = palette[_unpack(rows, bpp, W)]
    if not _is_color(palette[:1 << bpp]):
        return _gray(bgr)
    return np.ascontiguousarray(_rgb(bgr))


def write_sunras(img: np.ndarray) -> bytes:
    """uint8 [H, W], [H, W, 3] (RGB) or [H, W, 4] (RGBA) as cv2.imwrite
    writes Sun raster: a standard-type file without a colour map, 8, 24
    (BGR) or 32 bits (BGRA, which reads back as three channels), each row
    padded to an even length.  OpenCV fills a row's pad byte from the bytes
    after the row in its buffer: the next row's first byte; after the last
    row, whatever its memory holds there (here a zero)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or not (img.ndim == 2 or img.shape[2] in (3, 4)):
        raise ValueError(f"write_sunras takes uint8 [H, W] or [H, W, 3 / 4], got {img.dtype} "
                         f"{img.shape}")
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[2]
    rows = (img if C == 1 else img[..., [2, 1, 0, 3][:C]]).reshape(H, W * C)
    pitch = (W * C + 1) & ~1
    flat = np.concatenate([rows.reshape(-1), np.zeros(1, np.uint8)])
    if pitch > W * C:
        rows = np.concatenate([rows, flat[W * C::W * C][:, None]], axis=1)
    head = _RAS_MAGIC + struct.pack(">7I", W, H, 8 * C, pitch * H, 1, 0, 0)
    return head + rows.tobytes()


# ---------------------------------------------------------------------------
# GIF (OpenCV's grfmt_gif.cpp): the first frame
# ---------------------------------------------------------------------------

def _lzw_gif(data: bytes, min_size: int, count: int) -> np.ndarray:
    """GIF's LZW (codes least significant bit first, growing to 12 bits)
    -> the `count` indices of a frame.  As OpenCV's decoder: the codes are
    read up to the end code (or the data's end), and a code past the table
    or more or fewer indices than the frame holds give no image."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    nbits = len(bits)
    weights = 1 << np.arange(12)
    prefix: List[int] = []
    suffix: List[int] = []
    first: List[int] = []
    out = bytearray()
    size, pos, prev = min_size + 1, 0, -1

    def reset():
        nonlocal prefix, suffix, first
        prefix = [-1] * (eoi + 1)
        suffix = list(range(clear)) + [0, 0]
        first = list(range(clear)) + [0, 0]

    def string(code: int) -> bytes:
        s = bytearray()
        while code >= 0:
            s.append(suffix[code])
            code = prefix[code]
        return bytes(s[::-1])

    reset()
    while pos + size <= nbits and len(out) <= count:
        code = int(bits[pos:pos + size].dot(weights[:size]))
        pos += size
        if code == clear:
            reset()
            size, prev = min_size + 1, -1
            continue
        if code == eoi:
            break
        if prev < 0:
            if code >= clear:
                raise NoImage("GIF: corrupt LZW data (a code past the table)")
            out += string(code)
            prev = code
            continue
        if code < len(prefix):
            s = string(code)
            new_first = s[0]
        elif code == len(prefix):
            new_first = first[prev]
            s = string(prev) + bytes([new_first])
        else:
            raise NoImage("GIF: corrupt LZW data (a code past the table)")
        if len(prefix) < 4096:
            prefix.append(prev)
            suffix.append(new_first)
            first.append(first[prev])
            if len(prefix) == 1 << size and size < 12:
                size += 1
        out += s
        prev = code
    if len(out) != count:
        raise NoImage(f"GIF: the LZW data holds {'more' if len(out) > count else 'fewer'} "
                      f"indices than the frame (OpenCV returns no image)")
    return np.frombuffer(bytes(out), np.uint8)


def _gif_walk(data: bytes, pos: int) -> bool:
    """The blocks from `pos` to the trailer, walked as OpenCV's GIF decoder
    counts the frames before it decodes one: a cut file (no trailer), a
    sub-block or colour table past the end or an unknown block gives no
    image.  -> whether a graphic control extension names a transparent
    index."""
    transparent = False
    try:
        while data[pos] != 0x3B:
            if data[pos] == 0x2C:
                flags = data[pos + 9]
                pos += 11 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            elif data[pos] == 0x21:
                if data[pos + 1] == 0xF9 and data[pos + 2] >= 4 and data[pos + 3] & 1:
                    transparent = True
                pos += 2
            else:
                raise NoImage(f"GIF: an unknown block {data[pos]:#x} (OpenCV returns no image)")
            while data[pos]:
                pos += 1 + data[pos]
            pos += 1
    except IndexError:
        raise NoImage("GIF: the file ends before its trailer (OpenCV returns no image)") from None
    return transparent


def read_gif(data: bytes) -> np.ndarray:
    """The first frame of a GIF (87a / 89a): LZW, global or local colour
    table, interlaced or not, placed on the logical screen.  As OpenCV: the
    screen starts as the global table's background colour; the frame's
    pixels are drawn on it except its transparent index; four channels
    (alpha 255 where the frame drew, 0 elsewhere) when any graphic control
    extension of the file names a transparent index, else three."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    if len(data) < 13:
        raise NoImage("GIF: the file ends in its screen descriptor (OpenCV returns no image)")
    SW, SH, flags, bg, _ = struct.unpack("<HHBBB", data[6:13])
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(data[pos:pos + 3 * n], np.uint8)
        if len(gct) < 3 * n:
            raise NoImage("GIF: the file ends in its colour table (OpenCV returns no image)")
        gct = gct.reshape(n, 3)
        pos += 3 * n
    any_transparent = _gif_walk(data, pos)
    transparent = None
    while True:
        block = data[pos]
        if block == 0x21:                    # an extension
            label = data[pos + 1]
            pos += 2
            # OpenCV reads a graphic control and an application extension as
            # fixed blocks: the control's 4 bytes (a disposal method up to 3),
            # NETSCAPE2.0's 3, each then a 0 byte
            if label == 0xF9 and (data[pos] != 4 or data[pos + 1] & 0x10 or data[pos + 5]):
                raise NoImage("GIF: a graphic control extension OpenCV does not take (it returns "
                              "no image)")
            if label == 0xFF and (data[pos:pos + 12] != b"\x0bNETSCAPE2.0" or data[pos + 12] != 3
                                  or data[pos + 16]):
                raise NoImage("GIF: an application extension other than NETSCAPE2.0's (OpenCV "
                              "returns no image)")
            if label == 0xF9 and data[pos + 1] & 1:
                transparent = data[pos + 4]
            while data[pos]:
                pos += 1 + data[pos]
            pos += 1
        elif block == 0x2C:
            break
        else:                               # the trailer (_gif_walk checked the rest)
            raise ValueError("GIF: no image in the file")
    left, top, w, h, iflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
    pos += 10
    if left + w > SW or top + h > SH:
        raise NoImage("GIF: a frame past the logical screen (OpenCV returns no image)")
    check_size(SW, SH, "GIF")
    table = gct
    if iflags & 0x80:
        n = 2 << (iflags & 7)
        table = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    if table is None:
        raise ValueError("GIF: a frame without a colour table")
    min_size = data[pos]
    pos += 1
    chunks = []
    while pos < len(data) and data[pos]:
        chunks.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    idx = _lzw_gif(b"".join(chunks), min_size, w * h).reshape(h, w)
    if iflags & 0x40:                        # interlaced: rows in 4 passes
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(table)] = table
    out = np.zeros((SH, SW, 4), np.uint8)
    if gct is not None and bg < len(gct):
        out[..., :3] = gct[bg]
    drawn = np.ones(idx.shape, bool) if transparent is None else idx != transparent
    region = out[top:top + idx.shape[0], left:left + idx.shape[1]]
    region[drawn] = np.concatenate([pal[idx[drawn]], np.full((int(drawn.sum()), 1), 255,
                                                               np.uint8)], -1)
    return out if any_transparent else out[..., :3].copy()


def _median_cut(colors: np.ndarray, counts: np.ndarray, k: int):
    """A palette of at most k colours for distinct colours [n, 3] seen
    `counts` times: the box of colours with the most pixels times its
    widest side cut at its weighted median on that side, until there are k
    boxes -> (palette [m, 3] uint8, the box of each colour [n])."""
    def score(b):
        if len(b) < 2:
            return 0
        c = colors[b]
        return int((c.max(0) - c.min(0)).max()) * int(counts[b].sum())

    boxes = [np.arange(len(colors))]
    scores = [score(boxes[0])]
    while len(boxes) < k and max(scores) > 0:
        b = boxes.pop(int(np.argmax(scores)))
        scores.pop(int(np.argmax(scores)))
        c = colors[b]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        b = b[np.argsort(c[:, axis], kind="stable")]
        cum = np.cumsum(counts[b])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0)) + 1
        cut = min(max(cut, 1), len(b) - 1)
        boxes += [b[:cut], b[cut:]]
        scores += [score(b[:cut]), score(b[cut:])]
    box_of = np.zeros(len(colors), np.int64)
    palette = np.zeros((len(boxes), 3), np.uint8)
    for i, b in enumerate(boxes):
        box_of[b] = i
        w = counts[b].astype(np.float64)
        palette[i] = np.round((colors[b] * w[:, None]).sum(0) / w.sum())
    return palette, box_of


def _lzw_gif_encode(indices: np.ndarray, min_size: int) -> bytes:
    """GIF's LZW of palette indices (codes least significant bit first,
    growing to 12 bits; a clear code first and whenever the table is full,
    as giflib's encoder does), in data sub-blocks of at most 255 bytes."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    codes, widths = [clear], [min_size + 1]
    size, next_code = min_size + 1, eoi + 1
    table = {}
    px = indices.tolist()
    prefix = px[0]
    for k in px[1:]:
        key = prefix << 8 | k
        c = table.get(key)
        if c is not None:
            prefix = c
            continue
        codes.append(prefix)
        widths.append(size)
        if next_code >= 1 << size and size < 12:
            size += 1
        if next_code >= 4095:                      # the table is full: start again
            codes.append(clear)
            widths.append(size)
            size, next_code = min_size + 1, eoi + 1
            table = {}
        else:
            table[key] = next_code
            next_code += 1
        prefix = k
    codes.append(prefix)
    widths.append(size)
    if next_code >= 1 << size and size < 12:
        size += 1
    codes.append(eoi)
    widths.append(size)
    v, w = np.asarray(codes, np.int64), np.asarray(widths, np.int64)
    owner = np.repeat(np.arange(len(w)), w)
    pos = np.arange(int(w.sum())) - np.repeat(np.cumsum(w) - w, w)
    data = np.packbits(((v[owner] >> pos) & 1).astype(np.uint8), bitorder="little").tobytes()
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] (RGB) or [H, W, 4] (RGBA) as a GIF89a of one frame:
    the image's own colours where it has at most 256 (255 with a
    transparent index), else a median-cut palette of 256 with each colour
    taken to its box's mean.  As OpenCV's writer: a pixel of alpha 0 is
    transparent (the transparent index, whose colour is black and which is
    the screen's background, so it reads as (0, 0, 0, 0)), any other alpha
    opaque, and an image without alpha 0 has no transparency.  OpenCV
    writes an empty file for a gray image, so gray raises."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"write_gif takes uint8 [H, W, 3 / 4], got {img.dtype} {img.shape} "
                         f"(OpenCV writes an empty file for a gray image)")
    H, W = img.shape[:2]
    if not (1 <= H <= 65535 and 1 <= W <= 65535):
        raise ValueError(f"GIF holds at most 65535 x 65535 pixels, not {W} x {H}")
    clear = img[..., 3] == 0 if img.shape[2] == 4 else np.zeros((H, W), bool)
    transparent = bool(clear.any())
    key = (img[..., 0].astype(np.int64) << 16) | (img[..., 1].astype(np.int64) << 8) | img[..., 2]
    key = key[~clear]
    uniq, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], -1)
    room = 256 - int(transparent)
    if len(uniq) <= room:
        palette, box_of = colors.astype(np.uint8), np.arange(len(uniq))
    else:
        palette, box_of = _median_cut(colors, counts, room)
    base = int(transparent)                        # index 0: transparent, black
    idx = np.zeros((H, W), np.int64)
    idx[~clear] = base + box_of[inverse.ravel()]
    table = np.zeros((max(2, 1 << int(np.ceil(np.log2(base + len(palette))))), 3), np.uint8)
    table[base:base + len(palette)] = palette
    bits = int(np.log2(len(table)))
    head = b"GIF89a" + struct.pack("<HHBBB", W, H, 0x80 | (bits - 1) << 4 | (bits - 1), 0, 0)
    gce = b"\x21\xf9\x04\x01\x00\x00\x00\x00" if transparent else b""
    desc = b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0)
    min_size = max(2, bits)
    return (head + table.tobytes() + gce + desc + bytes([min_size])
            + _lzw_gif_encode(idx.ravel(), min_size) + b"\x3b")


# ---------------------------------------------------------------------------
# PAM (P7)
# ---------------------------------------------------------------------------

_PAM_FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")
_PAM_TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
                  b"RGB_ALPHA": 4}
_SPACE = b" \t\n\v\f\r"


def _pam_line(data: bytes, pos: int):
    """OpenCV's ReadPAMHeaderLine: (identifier, or None for a comment;
    value; position after the line).  Blanks before the identifier
    are skipped, newlines too; the identifier (at most 8 bytes, matched up
    to a NUL as C compares it) ends at a blank;
    ENDHDR ends there; otherwise the blanks after it are skipped (newlines
    too) and the value runs to the first CR or LF (at most 255 bytes),
    which is consumed, and loses its trailing blanks.  A line OpenCV does
    not take ends its header: no image."""
    def byte(i):
        if i >= len(data):
            raise NoImage("PAM: the file ends before ENDHDR (OpenCV returns no image)")
        return data[i]
    while byte(pos) in _SPACE:
        pos += 1
    if data[pos] == ord("#"):
        pos += 1
        while byte(pos) not in b"\r\n":
            pos += 1
        return None, b"", pos + 1
    start = pos
    while byte(pos) not in _SPACE and pos - start < 8:
        pos += 1
    ident = data[start:pos].split(b"\0", 1)[0]
    if byte(pos) not in _SPACE or ident not in _PAM_FIELDS:
        raise NoImage(f"PAM: a header line {data[start:pos + 1]!r} OpenCV does not take (it "
                      f"returns no image)")
    pos += 1
    if ident == b"ENDHDR":
        return ident, b"", pos
    while byte(pos) in _SPACE:
        pos += 1
    start = pos
    while byte(pos) not in b"\r\n" and pos - start < 255:
        pos += 1
    if data[pos] not in b"\r\n":
        raise NoImage("PAM: a header value over 255 bytes (OpenCV returns no image)")
    return ident, data[start:pos].split(b"\0", 1)[0].rstrip(_SPACE), pos + 1


def _pam_int(value: bytes, what: str) -> int:
    """OpenCV's ParseInt: an optional '-', then decimal digits to the end
    of the value (it ends at a NUL), below 2^31 - 1; anything else gives no
    image."""
    digits = value[1:] if value[:1] == b"-" else value
    if not digits or not digits.isdigit() or int(digits) >= 2 ** 31 - 1:
        raise NoImage(f"PAM: {what} {value!r} is not a number (OpenCV returns no image)")
    return -int(digits) if value[:1] == b"-" else int(digits)


def read_pam(data: bytes) -> np.ndarray:
    """PAM (P7) as OpenCV reads it: WIDTH, HEIGHT, DEPTH 1-4, MAXVAL up to
    65535, an optional TUPLTYPE (BLACKANDWHITE, GRAYSCALE, GRAYSCALE_ALPHA,
    RGB, RGB_ALPHA; its DEPTH must match it), '#' comment lines, ENDHDR.
    Without a TUPLTYPE only DEPTH 1 or 3 with MAXVAL below 256 is read.
    Samples are kept as stored, not scaled by MAXVAL; above 255 they are
    big-endian 16-bit.  MAXVAL 1 reads each
    row's first W bits (most significant first) as 0 or 255, and is refused
    with DEPTH 2 or 4.  Channels come
    out of OpenCV in the file's order, not as BGR: returned here reversed
    like every other reader's (so an RGB file's R and B trade places, as in
    the JAX package's read_image); two channels stay as they are."""
    if data[:2] != b"P7" or len(data) < 3 or data[2] not in b"\r\n":
        raise NoImage("PAM: not a P7 header (OpenCV returns no image)")
    pos, seen = 3, {}
    while True:
        ident, value, pos = _pam_line(data, pos)
        if ident is None:
            continue
        if ident == b"ENDHDR":
            break
        if ident in seen and ident != b"TUPLTYPE":
            raise NoImage(f"PAM: {ident.decode()} given twice (OpenCV returns no image)")
        if ident == b"TUPLTYPE":
            if value not in _PAM_TUPLTYPES:
                raise NoImage(f"PAM: TUPLTYPE {value!r} (OpenCV returns no image)")
            seen[ident] = value
        else:
            seen[ident] = _pam_int(value, ident.decode())
        if ident == b"MAXVAL" and seen[ident] > 65535:
            raise NoImage(f"PAM: MAXVAL {seen[ident]} (OpenCV returns no image)")
    missing = [f.decode() for f in _PAM_FIELDS[:4] if f not in seen]
    if missing:
        raise NoImage(f"PAM: the header lacks {', '.join(missing)} (OpenCV returns no image)")
    W, H, C, maxval = (seen[f] for f in _PAM_FIELDS[:4])
    tupltype = seen.get(b"TUPLTYPE")
    if tupltype is None:
        if C == 1 and maxval < 256:
            tupltype = b"BLACKANDWHITE" if maxval == 1 else b"GRAYSCALE"
        elif C == 3 and maxval < 256:
            tupltype = b"RGB"
        else:
            raise NoImage(f"PAM: no TUPLTYPE for DEPTH {C}, MAXVAL {maxval} (OpenCV returns no "
                          f"image)")
    if not 1 <= C <= 4:
        raise NoImage(f"PAM: DEPTH {C} (OpenCV reads 1 to 4 channels)")
    check_size(W, H, "PAM")
    if _PAM_TUPLTYPES[tupltype] != C:
        raise ValueError(f"PAM: TUPLTYPE {tupltype.decode()} with DEPTH {C}")
    wide = maxval > 255
    n = W * H * C * (2 if wide else 1)
    if pos + n > len(data):
        raise NoImage("PAM: the pixel data ends before the image (OpenCV returns no image)")
    if maxval == 1:
        if C in (2, 4):
            raise ValueError(f"PAM: MAXVAL 1 with DEPTH {C}")
        rows = np.frombuffer(data[pos:pos + n], np.uint8).reshape(H, W * C)
        img = np.where(_unpack(rows, 1, W) == 1, 255, 0).astype(np.uint8)
        return img if C == 1 else np.repeat(img[..., None], C, -1)
    img = np.frombuffer(data[pos:pos + n], ">u2" if wide else np.uint8).reshape(H, W, C)
    img = img.astype(np.uint16 if wide else np.uint8)
    if C == 1:
        return img[..., 0]
    return img if C == 2 else img[..., [2, 1, 0, 3][:C]]


def write_pam(img: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, 3] (RGB) as cv2.imwrite writes PAM: WIDTH,
    HEIGHT, DEPTH, MAXVAL 255, no TUPLTYPE, then the samples as OpenCV holds
    them (BGR).  OpenCV's four-channel PAM, without a TUPLTYPE, is a file
    its own reader refuses, so four channels raise."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or not (img.ndim == 2 or img.shape[2] == 3):
        raise ValueError(f"write_pam takes uint8 [H, W] or [H, W, 3], got {img.dtype} "
                         f"{img.shape} (OpenCV's four-channel PAM is a file it cannot read)")
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else 3
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL 255\nENDHDR\n" % (W, H, C)
    return head + np.ascontiguousarray(img if C == 1 else img[..., ::-1]).tobytes()
