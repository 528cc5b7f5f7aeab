"""Baseline JPEG on numpy and scipy (the port's replacement for OpenCV's
JPEG codec; the JAX package reads and writes JPEG through cv2).

Writer: JFIF, 8-bit, sequential DCT with Huffman coding (SOF0); colour as
YCbCr with 2x2 chroma subsampling (4:2:0), gray as one component; the
quantisation tables of the standard (ITU T.81 Annex K) scaled to a quality
as libjpeg scales them (95, cv2's default); the standard's Huffman tables.
The colour conversion and the chroma downsampling are libjpeg's fixed-point
ones; the DCT is the exact orthonormal one (scipy.fft).

Reader: 8-bit Huffman files of 1 or 3 components, sequential (SOF0, SOF1)
or progressive (SOF2: spectral selection and successive approximation, DC
and AC first scans and refinements, end-of-band runs), interleaved or not,
any sampling factors, restart intervals.  Chroma is upsampled as libjpeg
does by default (triangle filter for 2x2, 2x1 and 1x2, replication
otherwise) and converted to RGB with libjpeg's fixed-point tables; the
inverse DCT is the exact one.  Arithmetic-coded, lossless, hierarchical
and 12-bit files raise: the port has no decoder for them (nothing in
reach writes one to hold a reader against).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np
from scipy.fft import dctn, idctn

# zigzag scan order: ZIGZAG[k] is the natural (row-major) index of the k-th
# coefficient in the stream
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# T.81 Annex K.1, natural order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)

# T.81 Annex K.3: (BITS, HUFFVAL) of the four standard tables
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])

_SOF_NAMES = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
              0xC7: "hierarchical", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded "
              "progressive", 0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded "
              "hierarchical", 0xCE: "arithmetic-coded hierarchical", 0xCF: "arithmetic-coded "
              "hierarchical"}

_FIX = lambda x: int(x * 65536 + 0.5)      # libjpeg's 16-bit fixed point


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (baseline:
    entries clamped to 1..255), natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _huff_codes(bits, vals) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of every symbol 0..255 (T.81 Annex C)."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[vals[k]], len_of[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _category(v: np.ndarray) -> np.ndarray:
    """SSSS: the bit length of |v| (0 for 0)."""
    a = np.abs(v)
    s = np.zeros(v.shape, np.int64)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return s


def _extra_bits(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The s-bit code of v (negative values as v - 1 in s bits)."""
    return np.where(v >= 0, v, v + (1 << s) - 1)


def _rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """libjpeg's rgb_ycc_convert (16-bit fixed point), uint8 [H, W, 3] ->
    int64 [3, H, W]."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_FIX(0.299) * r + _FIX(0.587) * g + _FIX(0.114) * b + half) >> 16
    cb = (-_FIX(0.16874) * r - _FIX(0.33126) * g + _FIX(0.5) * b + off + half - 1) >> 16
    cr = (_FIX(0.5) * r - _FIX(0.41869) * g - _FIX(0.08131) * b + off + half - 1) >> 16
    return np.stack([y, cb, cr])


def _h2v2_downsample(plane: np.ndarray) -> np.ndarray:
    """libjpeg's h2v2_downsample: the mean of each 2x2 with a bias of 1, 2,
    1, 2, ... along a row (plane of even size)."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) & 1)
    return (s + bias[None]) >> 2


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[h, w] (multiples of 8) -> [h / 8, w / 8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _fdct_quantize(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Level shift, orthonormal 8x8 DCT, quantisation rounded half away from
    zero -> [by, bx, 64] int64 in zigzag order."""
    coef = dctn(_blocks(plane.astype(np.float64) - 128.0), type=2, norm="ortho", axes=(2, 3))
    coef = coef.reshape(coef.shape[:2] + (64,)) / q
    return (np.sign(coef) * np.floor(np.abs(coef) + 0.5)).astype(np.int64)[..., ZIGZAG]


def _pad_edges(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Replicate the last row and column up to [h, w] (libjpeg's edge
    expansion)."""
    return np.pad(a, ((0, h - a.shape[0]), (0, w - a.shape[1])), mode="edge")


def _entropy_code(coefs: np.ndarray, tables: np.ndarray, comps: np.ndarray,
                  huff: List[Tuple]) -> bytes:
    """Huffman-code blocks [n, 64] (zigzag, in stream order), block i with
    table set tables[i] and DC predictor comps[i]; returns the stuffed
    entropy-coded segment."""
    n = coefs.shape[0]
    dc = coefs[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comps):
        sel = np.nonzero(comps == c)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    # items: (block, key within block, value, length); value = code << s | bits
    dc_code, dc_len = (np.stack([huff[t][0][0] for t in range(len(huff))]),
                       np.stack([huff[t][0][1] for t in range(len(huff))]))
    ac_code, ac_len = (np.stack([huff[t][1][0] for t in range(len(huff))]),
                       np.stack([huff[t][1][1] for t in range(len(huff))]))
    s = _category(diff)
    items = [(np.arange(n), np.zeros(n, np.int64),
              (dc_code[tables, s] << s) | _extra_bits(diff, s), dc_len[tables, s] + s)]

    ac = coefs[:, 1:]
    b, k = np.nonzero(ac)
    k = k + 1                                   # zigzag position 1..63
    v = ac[b, k - 1]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    n_zrl = run // 16
    sa = _category(v)
    sym = ((run % 16) << 4) | sa
    t_ac = tables[b]
    items.append((b, k * 32 + 31, (ac_code[t_ac, sym] << sa) | _extra_bits(v, sa),
                  ac_len[t_ac, sym] + sa))
    if n_zrl.any():                             # runs of 16 zeros before a coefficient
        rep = np.repeat(np.arange(len(b)), n_zrl)
        j = np.arange(len(rep)) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
        items.append((b[rep], k[rep] * 32 + j, ac_code[t_ac[rep], 0xF0],
                      ac_len[t_ac[rep], 0xF0]))
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    items.append((eob, np.full(len(eob), 64 * 32), ac_code[tables[eob], 0],
                  ac_len[tables[eob], 0]))

    blk = np.concatenate([i[0] for i in items])
    key = np.concatenate([i[1] for i in items])
    val = np.concatenate([i[2] for i in items])
    ln = np.concatenate([i[3] for i in items])
    order = np.argsort(blk * (65 * 32) + key, kind="stable")
    val, ln = val[order], ln[order]
    total = int(ln.sum())
    owner = np.repeat(np.arange(len(ln)), ln)
    pos = np.arange(total) - np.repeat(np.cumsum(ln) - ln, ln)
    bits = ((val[owner] >> (ln[owner] - 1 - pos)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-total) % 8, np.uint8)])   # pad with 1-bits
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """A uint8 [H, W], [H, W, 1] or [H, W, 3 or 4] (RGB[A]; alpha dropped)
    image as baseline JPEG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 3:
        img = img[..., :3]
    if img.ndim not in (2, 3) or img.shape[0] == 0 or img.shape[1] == 0 or \
            (img.ndim == 3 and img.shape[2] != 3) or max(img.shape[:2]) > 65535:
        raise ValueError(f"encode_jpeg takes [H, W] or [H, W, 3] of at most 65535^2, "
                         f"got {img.shape}")
    H, W = img.shape[:2]
    qy, qc = quant_table(_LUMA_Q, quality), quant_table(_CHROMA_Q, quality)
    huff = [(_huff_codes(*_DC_LUMA), _huff_codes(*_AC_LUMA)),
            (_huff_codes(*_DC_CHROMA), _huff_codes(*_AC_CHROMA))]
    if img.ndim == 2:
        h8, w8 = -(-H // 8) * 8, -(-W // 8) * 8
        coefs = _fdct_quantize(_pad_edges(img.astype(np.int64), h8, w8), qy).reshape(-1, 64)
        tables = comps = np.zeros(len(coefs), np.int64)
        frame_comps = [(1, 0x11, 0)]
        dqt = b"\x00" + bytes(qy[ZIGZAG].tolist())
    else:
        h16, w16 = -(-H // 16) * 16, -(-W // 16) * 16
        ycc = [_pad_edges(p, h16, w16) for p in _rgb_to_ycc(img)]
        y = _fdct_quantize(ycc[0], qy)                                  # [2my, 2mx, 64]
        cb, cr = (_fdct_quantize(_h2v2_downsample(p), qc) for p in ycc[1:])
        my, mx = h16 // 16, w16 // 16
        y = y.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
        coefs = np.concatenate([y, cb.reshape(-1, 1, 64), cr.reshape(-1, 1, 64)], 1)
        coefs = coefs.reshape(-1, 64)
        tables = np.tile([0, 0, 0, 0, 1, 1], my * mx)
        comps = np.tile([0, 0, 0, 0, 1, 2], my * mx)
        frame_comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
        dqt = b"\x00" + bytes(qy[ZIGZAG].tolist()) + b"\x01" + bytes(qc[ZIGZAG].tolist())
    out = [b"\xff\xd8", _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           _segment(0xFFDB, dqt),
           _segment(0xFFC0, struct.pack(">BHHB", 8, H, W, len(frame_comps))
                    + b"".join(struct.pack(">BBB", *c) for c in frame_comps))]
    dht = b""
    for cls, tid, (bits, vals) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA), (0, 1, _DC_CHROMA),
                                   (1, 1, _AC_CHROMA))[:2 if img.ndim == 2 else 4]:
        dht += bytes([cls << 4 | tid]) + bytes(bits) + bytes(vals)
    out.append(_segment(0xFFC4, dht))
    out.append(_segment(0xFFDA, bytes([len(frame_comps)])
                        + b"".join(bytes([c[0], c[2] << 4 | c[2]]) for c in frame_comps)
                        + b"\x00\x3f\x00"))
    out.append(_entropy_code(coefs, tables, comps, huff))
    out.append(b"\xff\xd9")
    return b"".join(out)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _lookup(bits, vals) -> List[int]:
    """A 65,536-entry table: the next 16 bits of the stream -> length << 8 |
    symbol (0 for a bit pattern that is no code)."""
    table = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = length << 8 | vals[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _windows(data: bytes) -> List[int]:
    """The 16 stream bits that start at each bit position of `data` (zeros
    past its end)."""
    b = np.frombuffer(data + bytes(10), np.uint8).astype(np.int64)
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    p = np.arange(8 * (len(data) + 8))
    return ((w24[p >> 3] >> (8 - (p & 7))) & 0xFFFF).tolist()


def _unstuff(seg: bytes) -> bytes:
    return seg.replace(b"\xff\x00", b"\xff")


# what a scan codes (T.81 G.1.2): every coefficient at once (sequential),
# or, progressively, the DC or a band of AC coefficients, first or a
# refinement bit
_SEQUENTIAL, _DC_FIRST, _DC_REFINE, _AC_FIRST, _AC_REFINE = range(5)


def _decode_interval(data: bytes, units, mode: int, ss: int, se: int, al: int) -> None:
    """Decode the MCUs `units` of one restart interval of a scan into their
    blocks.  A unit is a list of (block, component, DC table, AC table), a
    block the 64 coefficients of an 8x8 block in zigzag order (a list,
    updated in place).  DC predictors and the end-of-band run start at 0."""
    win = _windows(data)
    n_bits = 8 * len(data)
    pos, eobrun = 0, 0
    preds: Dict[int, int] = {}
    p1, m1 = 1 << al, -1 << al

    def bits(n: int) -> int:
        nonlocal pos
        v = win[pos] >> (16 - n)
        pos += n
        return v

    def huff(table, what: str) -> int:
        nonlocal pos
        look = table[win[pos]]
        if not look:
            raise ValueError(f"JPEG: corrupt entropy-coded data (bad {what} code)")
        pos += look >> 8
        return look & 255

    def extend(v: int, s: int) -> int:
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    if mode == _SEQUENTIAL:
        # the baseline scan, once per coefficient: the table look-ups, the
        # bit reads and the sign extension written out in the loop
        for unit in units:
            for blk, c, dct, act in unit:
                look = dct[win[pos]]
                if not look:
                    raise ValueError("JPEG: corrupt entropy-coded data (bad DC code)")
                pos += look >> 8
                s = look & 255
                v = 0
                if s:
                    v = win[pos] >> (16 - s)
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                v += preds.get(c, 0)
                preds[c] = v
                blk[0] = v
                k = 1
                while k < 64:
                    look = act[win[pos]]
                    if not look:
                        raise ValueError("JPEG: corrupt entropy-coded data (bad AC code)")
                    pos += look >> 8
                    s = look & 15
                    if s == 0:
                        if look & 255 != 0xF0:
                            break
                        k += 16
                        continue
                    k += (look >> 4) & 15
                    v = win[pos] >> (16 - s)
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    if k < 64:
                        blk[k] = v
                    k += 1
            if pos > n_bits:
                raise ValueError("JPEG: entropy-coded data ends early")
        return

    for unit in units:
        for blk, c, dct, act in unit:
            if mode == _DC_FIRST:
                s = huff(dct, "DC")
                preds[c] = preds.get(c, 0) + (extend(bits(s), s) if s else 0)
                blk[0] = preds[c] << al
            elif mode == _DC_REFINE:
                if bits(1):
                    blk[0] |= p1
            elif mode == _AC_FIRST:
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = huff(act, "AC")
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        if k > 63:
                            raise ValueError("JPEG: corrupt progressive AC scan")
                        blk[k] = extend(bits(s), s) << al
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        eobrun = (1 << r) - 1 + (bits(r) if r else 0)
                        break
            else:                       # AC refinement (libjpeg's decode_mcu_AC_refine)
                k = ss
                if not eobrun:
                    while k <= se:
                        rs = huff(act, "AC")
                        r, s = rs >> 4, rs & 15
                        if s:
                            s = p1 if bits(1) else m1
                        elif r != 15:
                            eobrun = (1 << r) + (bits(r) if r else 0)
                            break
                        # pass r zero coefficients, refining the nonzero ones
                        while k <= se:
                            if blk[k]:
                                if bits(1) and not blk[k] & p1:
                                    blk[k] += p1 if blk[k] >= 0 else m1
                            elif r:
                                r -= 1
                            else:
                                break
                            k += 1
                        if s:
                            if k > 63:
                                raise ValueError("JPEG: corrupt progressive AC scan")
                            blk[k] = s
                        k += 1
                if eobrun:
                    # the band's end lies in an end-of-band run: refine the
                    # nonzero coefficients left
                    while k <= se:
                        if blk[k] and bits(1) and not blk[k] & p1:
                            blk[k] += p1 if blk[k] >= 0 else m1
                        k += 1
                    eobrun -= 1
        if pos > n_bits:
            raise ValueError("JPEG: entropy-coded data ends early")


def _upsample(p: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """libjpeg's default upsampling of a component by (fy, fx): the
    triangle ("fancy") filters for 2x2, 2x1 and 1x2, replication otherwise."""
    p = p.astype(np.int64)
    if (fy, fx) == (1, 1):
        return p
    if (fy, fx) in ((2, 2), (1, 2)):
        if fy == 2:
            up = np.concatenate([p[:1], p[:-1]])
            down = np.concatenate([p[1:], p[-1:]])
            rows = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
            rows[0::2], rows[1::2] = 3 * p + up, 3 * p + down     # column sums, x4
        else:
            rows = p
        left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
        out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int64)
        if fy == 2:
            out[:, 0::2] = (3 * rows + left + 8) >> 4
            out[:, 1::2] = (3 * rows + right + 7) >> 4
            out[:, 0] = (4 * rows[:, 0] + 8) >> 4
            out[:, -1] = (4 * rows[:, -1] + 7) >> 4
        else:
            out[:, 0::2] = (3 * rows + left + 1) >> 2
            out[:, 1::2] = (3 * rows + right + 2) >> 2
            out[:, 0], out[:, -1] = rows[:, 0], rows[:, -1]
        return out
    if (fy, fx) == (2, 1):
        up = np.concatenate([p[:1], p[:-1]])
        down = np.concatenate([p[1:], p[-1:]])
        out = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
        out[0::2], out[1::2] = (3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2
        return out
    return np.repeat(np.repeat(p, fy, axis=0), fx, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's ycc_rgb_convert (16-bit fixed point, clamped)."""
    cb, cr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((_FIX(1.402) * cr + half) >> 16)
    b = y + ((_FIX(1.772) * cb + half) >> 16)
    g = y + ((-_FIX(0.34414) * cb - _FIX(0.71414) * cr + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _scan_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data of a scan from `pos`, cut at its RSTn
    markers, and the position of the marker that ends it."""
    segs, start, end = [], pos, pos
    while True:
        end = data.find(b"\xff", end)
        if end < 0 or end + 1 >= len(data):
            raise ValueError("JPEG: the scan runs past the end of the file")
        nxt = data[end + 1]
        if nxt == 0x00 or nxt == 0xFF:
            end += 1 if nxt == 0xFF else 2
            continue
        segs.append(data[start:end])
        if 0xD0 <= nxt <= 0xD7:
            start = end = end + 2
            continue
        return segs, end


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline, extended sequential or progressive Huffman JPEG bytes ->
    uint8 [H, W, 1] (gray) or [H, W, 3] (RGB)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qt: Dict[int, np.ndarray] = {}
    dc_t: Dict[int, List[int]] = {}
    ac_t: Dict[int, List[int]] = {}
    frame = None
    progressive = False
    restart = 0
    # per component: its blocks (64 zigzag coefficients each) over the grid
    # of whole MCUs, row-major, and the grid's (rows, columns)
    coefs: Dict[int, List[List[int]]] = {}
    grids: Dict[int, Tuple[int, int]] = {}
    coded = set()
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:
            pos -= 1
            continue
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data) or pos + struct.unpack(">H", data[pos:pos + 2])[0] > len(data):
            raise ValueError(f"JPEG: marker segment {marker:#04x} runs past the end of the file")
        (n,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + n]
        pos += n
        if marker in _SOF_NAMES:
            raise ValueError(f"JPEG: {_SOF_NAMES[marker]} files are not supported (the port "
                             f"decodes baseline, extended sequential and progressive Huffman "
                             f"JPEG)")
        if marker == 0xCC:
            raise ValueError("JPEG: arithmetic-coded files are not supported (the port "
                             "decodes baseline, extended sequential and progressive Huffman "
                             "JPEG)")
        if marker == 0xDB:
            i = 0
            while i < len(body):
                prec, tid = body[i] >> 4, body[i] & 15
                if prec:
                    q = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    q = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                qt[tid] = q
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                cls, tid = body[i] >> 4, body[i] & 15
                bits = list(body[i + 1:i + 17])
                vals = list(body[i + 17:i + 17 + sum(bits)])
                i += 17 + sum(bits)
                (ac_t if cls else dc_t)[tid] = _lookup(bits, vals)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker in (0xC0, 0xC1, 0xC2):
            prec, H, W, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"JPEG: {prec}-bit samples are not supported (8-bit only)")
            if nc not in (1, 3):
                raise ValueError(f"JPEG: {nc} components are not supported (1 or 3)")
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                      body[8 + 3 * i]) for i in range(nc)]
            frame = (H, W, comps)
            progressive = marker == 0xC2
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            for cid, h, v, _ in comps:
                grids[cid] = (-(-H // (8 * vmax)) * v, -(-W // (8 * hmax)) * h)
                coefs[cid] = [[0] * 64 for _ in range(grids[cid][0] * grids[cid][1])]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            H, W, comps = frame
            ns = body[0]
            sel = {body[1 + 2 * i]: body[2 + 2 * i] for i in range(ns)}
            ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, \
                body[3 + 2 * ns] & 15
            if not progressive:
                mode = _SEQUENTIAL
            elif ss == 0:
                mode = _DC_REFINE if ah else _DC_FIRST
            else:
                mode = _AC_REFINE if ah else _AC_FIRST
            if progressive and (se > 63 or ss > se or (ss > 0 and ns != 1) or
                                (ss == 0 and se != 0)):
                raise ValueError(f"JPEG: bad progressive scan (Ss {ss}, Se {se}, {ns} "
                                 f"components)")
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            scomps = [c for c in comps if c[0] in sel]
            tab = lambda cid: (dc_t.get(sel[cid] >> 4), ac_t.get(sel[cid] & 15))
            if ns == 1:
                # one block an MCU, over the component's own blocks
                cid, h, v, _ = scomps[0]
                cols = grids[cid][1]
                bw = -(-(-(-W * h // hmax)) // 8)
                bh = -(-(-(-H * v // vmax)) // 8)
                units = [[(coefs[cid][r * cols + c], cid, *tab(cid))]
                         for r in range(bh) for c in range(bw)]
            else:
                units = [[(coefs[cid][(my * v + r) * grids[cid][1] + mx * h + c], cid, *tab(cid))
                          for cid, h, v, _ in scomps for r in range(v) for c in range(h)]
                         for my in range(-(-H // (8 * vmax))) for mx in range(-(-W // (8 * hmax)))]
            segs, pos = _scan_segments(data, pos)
            per = restart if restart else len(units)
            done = 0
            for seg in segs:
                if done >= len(units):
                    break
                _decode_interval(_unstuff(seg), units[done:done + per], mode, ss, se, al)
                done += per
            if done < len(units):
                raise ValueError("JPEG: fewer MCUs in the scan than the frame needs")
            coded.update(c[0] for c in scomps)
    if frame is None:
        raise ValueError("JPEG: no frame header")
    H, W, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    planes = []
    for cid, h, v, tq in comps:
        if tq not in qt:
            raise ValueError(f"JPEG: quantisation table {tq} missing")
        if cid not in coded:
            raise ValueError(f"JPEG: no scan holds component {cid}")
        by, bx = grids[cid]
        grid = np.asarray(coefs[cid], np.int64).reshape(by, bx, 64)
        cw, ch = -(-W * h // hmax), -(-H * v // vmax)
        nat = np.zeros(grid.shape, np.float64)
        nat[..., ZIGZAG] = grid * qt[tq]
        pix = idctn(nat.reshape(by, bx, 8, 8), type=2, norm="ortho", axes=(2, 3))
        pix = np.clip(np.floor(pix + 128.5), 0, 255).astype(np.int64)
        plane = pix.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)[:ch, :cw]
        planes.append(_upsample(plane, vmax // v, hmax // h)[:H, :W])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)[..., None]
    return _ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))
