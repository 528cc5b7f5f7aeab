"""JPEG on numpy (the port's replacement for OpenCV's JPEG codec; the JAX
package reads and writes JPEG through cv2).

Writer, byte-equal to cv2.imencode(".jpg") (libjpeg-turbo's compressor at
OpenCV's settings): JFIF, 8-bit, sequential DCT with Huffman coding
(SOF0); colour as YCbCr with 2x2 chroma subsampling (4:2:0), gray as one
component; the quantisation tables of the standard (ITU T.81 Annex K)
scaled to a quality as libjpeg scales them (95, cv2's default); the
standard's Huffman tables.  Every step is libjpeg's integer one: the
fixed-point RGB -> YCbCr (jccolor.c), the edge padding and h2v2
downsampling (jcprepct.c, jcsample.c), jpeg_fdct_islow (jfdctint.c), the
quantisation's rounding (jcdctmgr.c), the dummy blocks that fill the last
MCUs (jccoefct.c) and the markers (jcmarker.c).

Reader, bit-equal to cv2.imread(IMREAD_UNCHANGED) (libjpeg-turbo): 8-bit
DCT files, sequential (SOF0, SOF1) or progressive (SOF2: spectral selection
and successive approximation, end-of-band runs), Huffman- or
arithmetic-coded (SOF9, SOF10: T.81's QM coder with the DAC conditioning);
lossless files (SOF3: predictors 1-7, point transform, 2-8 bits); 1, 3
or 4 components, interleaved or not, any sampling factors, restart
intervals.
The inverse DCT is libjpeg-turbo's SIMD islow one (jidctint.c's integer
arithmetic, with the 16-bit wraps and saturations of its x86 code, which
only corrupt data reaches); chroma is upsampled as libjpeg does by default
(triangle filters for 2x2, 2x1 and 1x2, replication otherwise, and always
in a lossless file); the colour space follows libjpeg's JFIF / Adobe /
component-id rules, and four components (CMYK, YCCK) go to BGR as OpenCV
converts them.  Hierarchical, arithmetic-coded lossless and 12-bit DCT
files raise, as do lossless files of more than 8 bits (OpenCV gives no
image for them).

A damaged file reads as cv2.imread reads it from its path (`decode_jpeg`
says how): libjpeg-turbo's recovery as OpenCV's stdio source drives it,
and NoImage where libjpeg stops.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from iron_tpu_torch.data.io import NoImage, check_size

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


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_fdct_islow (jfdctint.c) on level-shifted samples
    [..., 8, 8] (int64): two 1-D passes, rows then columns, in 13-bit fixed
    point with PASS1_BITS = 2 -> the coefficients scaled up by 8, in
    natural order."""
    def one_pass(d, first: bool):
        out = np.empty_like(d)
        t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        if first:
            out[..., 0], out[..., 4] = (t10 + t11) << 2, (t10 - t11) << 2
            n = 11                                  # CONST_BITS - PASS1_BITS
        else:
            out[..., 0], out[..., 4] = (t10 + t11 + 2) >> 2, (t10 - t11 + 2) >> 2
            n = 15                                  # CONST_BITS + PASS1_BITS
        r = 1 << (n - 1)
        z1 = (t12 + t13) * 4433
        out[..., 2] = (z1 + t13 * 6270 + r) >> n
        out[..., 6] = (z1 - t12 * 15137 + r) >> n
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
        z1, z2 = z1 * -7373, z2 * -20995
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
        out[..., 7] = (t4 + z1 + z3 + r) >> n
        out[..., 5] = (t5 + z2 + z4 + r) >> n
        out[..., 3] = (t6 + z2 + z3 + r) >> n
        out[..., 1] = (t7 + z1 + z4 + r) >> n
        return out
    rows = one_pass(blocks, True)
    return np.swapaxes(one_pass(np.swapaxes(rows, -1, -2), False), -1, -2)


def _fdct_quantize(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Samples [h, w] (multiples of 8) -> the quantised coefficients of its
    blocks [h / 8, w / 8, 64] (int64, zigzag order): level shift,
    jpeg_fdct_islow, and libjpeg's quantisation of the 8x-scaled
    coefficient c by 8q: (|c| + 4q) // 8q with c's sign."""
    h, w = plane.shape
    blocks = (plane.astype(np.int64) - 128).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    coef = _fdct_islow(blocks).reshape(h // 8, w // 8, 64)
    d = (q << 3)[None, None]
    mag = (np.abs(coef) + (d >> 1)) // d
    return np.where(coef < 0, -mag, mag)[..., ZIGZAG]


def _pad_edges(a: np.ndarray, h: int, w: int) -> np.ndarray:
    """Replicate the last row and column up to [h, w] (libjpeg's
    expand_right_edge and expand_bottom_edge)."""
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


def _dummy_blocks(y: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """The luma blocks of whole 2x2-block MCUs [2my, 2mx, 64] of which only
    the first rows x cols are the image's: libjpeg's compress_data
    (jccoefct.c) codes the others as dummy blocks, all AC zero, a right-edge
    block with the DC of the block to its left and a bottom-row block with
    the DC of its MCU's last block of the row above."""
    y = y.copy()
    y[:, cols:] = 0
    y[rows:] = 0
    if cols % 2:
        y[:rows, cols, 0] = y[:rows, cols - 1, 0]
    if rows % 2:
        last = y[rows - 1, 1::2, 0]                    # each MCU's upper-right block
        y[rows, :, 0] = np.repeat(last, 2)
    return y


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """A uint8 [H, W], [H, W, 1] or [H, W, 3 or 4] (RGB[A]; alpha dropped)
    image as the bytes cv2.imencode(".jpg") writes at `quality` (OpenCV's
    default 95): libjpeg's compressor with its defaults, baseline, 4:2:0
    chroma, the standard Huffman tables."""
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
    by, bx = -(-H // 8), -(-W // 8)                    # the luma blocks of the image
    if img.ndim == 2:
        # one component: a scan of by x bx one-block MCUs, no dummy blocks
        coefs = _fdct_quantize(_pad_edges(img, 8 * by, 8 * bx), qy).reshape(-1, 64)
        tables = comps = np.zeros(len(coefs), np.int64)
        frame_comps = [(1, 0x11, 0)]
        qts = [qy]
    else:
        my, mx = -(-H // 16), -(-W // 16)              # MCUs; also the chroma blocks
        ycc = _rgb_to_ycc(img)
        y = np.zeros((2 * my, 2 * mx, 64), np.int64)
        y[:by, :bx] = _fdct_quantize(_pad_edges(ycc[0], 8 * by, 8 * bx), qy)
        y = _dummy_blocks(y, by, bx)
        # chroma (jcprepct.c, jcsample.c): the full-resolution rows padded to
        # an even count and the columns to 16 mx, downsampled, then the last
        # downsampled row repeated down to 8 my
        ch = [_pad_edges(_h2v2_downsample(_pad_edges(p, H + H % 2, 16 * mx)), 8 * my, 8 * mx)
              for p in ycc[1:]]
        cb, cr = (_fdct_quantize(p, qc) for p in ch)
        y = y.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
        coefs = np.concatenate([y, cb.reshape(-1, 1, 64), cr.reshape(-1, 1, 64)], 1)
        coefs = coefs.reshape(-1, 64)
        tables = np.tile([0, 0, 0, 0, 1, 1], my * mx)
        comps = np.tile([0, 0, 0, 0, 1, 2], my * mx)
        frame_comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
        qts = [qy, qc]
    # libjpeg's markers: JFIF APP0, a DQT a table, SOF0, a DHT a table
    # (DC then AC of each table set), SOS
    out = [b"\xff\xd8", _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out += [_segment(0xFFDB, bytes([t]) + bytes(q[ZIGZAG].tolist())) for t, q in enumerate(qts)]
    out.append(_segment(0xFFC0, struct.pack(">BHHB", 8, H, W, len(frame_comps))
                        + b"".join(struct.pack(">BBB", *c) for c in frame_comps)))
    for cls, tid, (bits, vals) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA), (0, 1, _DC_CHROMA),
                                   (1, 1, _AC_CHROMA))[:2 * len(qts)]:
        out.append(_segment(0xFFC4, bytes([cls << 4 | tid]) + bytes(bits) + bytes(vals)))
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
    symbol.  A bit pattern that is no code reads as libjpeg reads it
    (jpeg_huff_decode, JWRN_HUFF_BAD_CODE): 17 bits, symbol 0."""
    table = np.full(1 << 16, 17 << 8, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = length << 8 | vals[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _derived(tables: Dict, tid: int, dc: bool) -> List[int]:
    """libjpeg's jpeg_make_d_derived_tbl at the start of a scan: the table
    `tid` of a class, checked as libjpeg checks it (no table, more than
    256 codes, an all-ones code, a DC symbol past 15: no image), as a
    look-up table (`_lookup`, built once)."""
    t = tables.get(tid)
    if t is None:
        raise NoImage(f"JPEG: the scan uses Huffman table {tid}, which is not defined (libjpeg "
                      f"stops: JERR_NO_HUFF_TABLE)")
    if t[2] is None:
        bits, vals = t[0], t[1]
        code = 0
        first = next((i for i in range(16) if bits[i]), 16)
        last = max((i for i in range(16) if bits[i]), default=-1)
        for i in range(first, last + 1):
            code += bits[i]
            if code >= 1 << (i + 1):
                raise NoImage("JPEG: a Huffman table with an all-ones code (JERR_BAD_HUFF_TABLE)")
            code <<= 1
        if dc and any(v > 15 for v in vals):
            raise NoImage("JPEG: a DC Huffman table with a symbol past 15 (JERR_BAD_HUFF_TABLE)")
        t[2] = _lookup(bits, vals)
    return t[2]


def _windows(data: bytes, pad: int = 8) -> List[int]:
    """The 16 stream bits that start at each bit position of `data` and of
    `pad` bytes after it (zeros past its end, as libjpeg's bit reader
    gives them after a marker)."""
    b = np.frombuffer(data + bytes(pad + 2), np.uint8).astype(np.int64)
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    p = np.arange(8 * (len(data) + pad))
    return ((w24[p >> 3] >> (8 - (p & 7))) & 0xFFFF).tolist()


def _next_marker(src: bytes, p: int) -> Tuple[int, int]:
    """libjpeg's next_marker from byte p: bytes before a marker skipped
    (JWRN_EXTRANEOUS_DATA), FF fill bytes swallowed, FF 00 passed over ->
    (the marker's code, the position after it).  `src` ends in FF D9."""
    while True:
        p = src.index(b"\xff", p) + 1
        while src[p] == 0xFF:
            p += 1
        p += 1
        if src[p - 1]:
            return src[p - 1], p


def _entropy_segment(src: bytes, p: int) -> Tuple[bytes, int, int]:
    """The entropy-coded bytes from p as libjpeg's readers take them (FF 00,
    and FF FF ... 00, is one FF byte), up to the next marker -> (bytes, the
    marker's code, the position after it)."""
    parts, start = [], p
    while True:
        q = src.index(b"\xff", p)
        r = q + 1
        while src[r] == 0xFF:
            r += 1
        if src[r]:
            parts.append(src[start:q])
            return b"".join(parts), src[r], r + 1
        parts.append(src[start:q + 1])
        p = start = r + 1


def _resync(src: bytes, marker: int, p: int, want: int) -> Tuple[Optional[int], int]:
    """libjpeg's read_restart_marker with the marker met (`marker`, read up
    to p) where RST`want` is due: the due marker is taken; any other goes
    through jpeg_resync_to_restart: a marker below SOF0 or a restart two
    back is skipped to the next marker, one of the next two restarts or a
    non-restart marker is left unread (-> (marker, p): the next interval
    then has no data), any other restart is taken (-> (None, p))."""
    while True:
        if marker == 0xD0 + want:
            return None, p
        if marker < 0xC0:
            skip = True
        elif not 0xD0 <= marker <= 0xD7 or marker - 0xD0 in ((want + 1) & 7, (want + 2) & 7):
            return marker, p
        elif marker - 0xD0 in ((want - 1) & 7, (want - 2) & 7):
            skip = True
        else:
            return None, p
        if skip:
            marker, p = _next_marker(src, p)


def _scan_data(src: bytes, p: int, n_units: int, restart: int, decode) -> Tuple[int, int]:
    """Run one scan's entropy-coded data from p as libjpeg does, restart
    interval by restart interval: each interval's data is the bytes up to
    the next marker; at each restart the marker met goes through
    `_resync`, the DC predictions (and the decoder's state) start anew,
    and the out-of-data flag clears if a marker was taken.  `decode(seg,
    first, count)` decodes units [first, first + count) from `seg` and
    returns True if the data ran out (libjpeg's insufficient_data: the
    units after that are left as they were).  -> (the marker met after
    the scan, the position after it)."""
    per = restart if restart else n_units
    marker, out, want = None, False, 0
    for i in range(0, n_units, per):
        if i:
            if marker is None:
                marker, p = _next_marker(src, p)
            marker, p = _resync(src, marker, p, want)
            want = (want + 1) & 7
            if marker is None:
                out = False
        if out:
            continue
        seg = b""
        if marker is None:
            seg, marker, p = _entropy_segment(src, p)
        out = decode(seg, i, min(per, n_units - i))
    return marker, p


def _w16(v):
    """An int (or int64 array) stored into libjpeg's JCOEF (int16), or
    taken in 16 bits as the SIMD IDCT takes it."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


# what a scan codes (T.81 G.1.2): every coefficient at once (sequential),
# or, progressively, the DC or a band of AC coefficients, first or a
# refinement bit
_SEQUENTIAL, _DC_FIRST, _DC_REFINE, _AC_FIRST, _AC_REFINE = range(5)


def _decode_interval(data: bytes, units, mode: int, ss: int, se: int,
                     al: int) -> Tuple[bool, int]:
    """Decode the MCUs `units` of one restart interval of a scan into their
    blocks, as libjpeg-turbo's jdhuff.c / jdphuff.c decode them.  A unit is
    a list of (block, component, DC table, AC table), a block the 64
    coefficients of an 8x8 block in zigzag order (a list, updated in
    place).  DC predictors and the end-of-band run start at 0.  Past the
    end of `data` the bits are zeros; the unit during which they run out is
    decoded to its end and the units after it are left untouched
    (libjpeg's insufficient_data).  A coefficient index past 63 writes
    coefficient 63 (libjpeg's jpeg_natural_order guard).  -> (whether the
    data ran out, the units decoded)."""
    # the stream's bits, with 8 zero bytes after them: a unit that reads
    # further (the data ran out in it) is decoded again with room for the
    # most a unit can read, the refinement's blocks restored first (its
    # newly nonzero coefficients would read as nonzero)
    saved = [list(b[0]) for u in units for b in u] if mode == _AC_REFINE else None
    try:
        return _decode_units(_windows(data), len(data), units, mode, ss, se, al)
    except IndexError:
        if saved is not None:
            for b, old in zip((b[0] for u in units for b in u), saved):
                b[:] = old
        return _decode_units(_windows(data, 3000), len(data), units, mode, ss, se, al)


def _decode_units(win: List[int], n_bytes: int, units, mode: int, ss: int, se: int,
                  al: int) -> Tuple[bool, int]:
    """`_decode_interval` on the stream's windows (`_windows`)."""
    n_bits = 8 * n_bytes
    pos, eobrun = 0, 0
    preds: Dict[int, int] = {}
    p1, m1 = 1 << al, -1 << al

    def bits(n: int) -> int:
        nonlocal pos
        v = win[pos] >> (16 - n)
        pos += n
        return v

    def huff(table) -> int:
        nonlocal pos
        look = table[win[pos]]
        pos += look >> 8
        return look & 255

    def extend(v: int, s: int) -> int:
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    if mode == _SEQUENTIAL:
        # the baseline scan, once per coefficient: the table look-ups, the
        # bit reads and the sign extension written out in the loop
        for done, unit in enumerate(units, 1):
            for blk, c, dct, act in unit:
                look = dct[win[pos]]
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
                blk[0] = v if -0x8000 <= v < 0x8000 else _w16(v)
                k = 1
                while k < 64:
                    look = act[win[pos]]
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
                    blk[k if k < 64 else 63] = v
                    k += 1
            if pos > n_bits:
                return True, done
        return False, len(units)

    for done, unit in enumerate(units, 1):
        for blk, c, dct, act in unit:
            if mode == _DC_FIRST:
                s = huff(dct)
                preds[c] = preds.get(c, 0) + (extend(bits(s), s) if s else 0)
                blk[0] = _w16(preds[c] << al)
            elif mode == _DC_REFINE:
                if bits(1):
                    blk[0] |= p1
            elif mode == _AC_FIRST:
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = huff(act)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        blk[min(k, 63)] = _w16(extend(bits(s), s) << al)
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
                        rs = huff(act)
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
                                    blk[k] = _w16(blk[k] + (p1 if blk[k] >= 0 else m1))
                            elif r:
                                r -= 1
                            else:
                                break
                            k += 1
                        if s:
                            blk[min(k, 63)] = s
                        k += 1
                if eobrun:
                    # the band's end lies in an end-of-band run: refine the
                    # nonzero coefficients left
                    while k <= se:
                        if blk[k] and bits(1) and not blk[k] & p1:
                            blk[k] = _w16(blk[k] + (p1 if blk[k] >= 0 else m1))
                        k += 1
                    eobrun -= 1
        if pos > n_bits:
            return True, done
    return False, len(units)


# T.81 Table D.2, the QM coder's probability estimation: Qe, the next state
# after an LPS and after an MPS, and the states that switch the MPS sense.
# State 113 is libjpeg's fixed 0.5 estimate (T.851), used for signs and for
# the refinement bits of progressive DC scans.
_QE = [
    0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036, 0x001a, 0x000d,
    0x0006, 0x0003, 0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c, 0x17b9, 0x1182, 0x0cef, 0x09a1,
    0x072f, 0x055c, 0x0406, 0x0303, 0x0240, 0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a, 0x0068,
    0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d, 0x2ef1, 0x261f, 0x1f33, 0x19a8, 0x1518,
    0x1177, 0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706, 0x05cd, 0x04de, 0x040f, 0x0363, 0x02d4,
    0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab, 0x008f, 0x5b12, 0x4d04,
    0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf, 0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b,
    0x0d51, 0x0bb6, 0x0a40, 0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516,
    0x5570, 0x4ca9, 0x44d9, 0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf,
    0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639, 0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f,
    0x5a10, 0x5522, 0x59eb, 0x5a1d]
_NLPS = [
    1, 14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9, 10, 12, 15, 36, 38, 39, 40, 42, 43, 45, 46, 48,
    49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32, 33, 37, 64, 65, 67, 68, 69, 70, 72, 73, 74, 75,
    77, 78, 79, 48, 50, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82, 83, 84,
    86, 87, 87, 72, 72, 74, 74, 75, 77, 77, 80, 88, 89, 90, 91, 92, 93, 86, 88, 95, 96, 97, 99,
    99, 93, 95, 101, 102, 103, 104, 99, 105, 106, 107, 103, 105, 108, 109, 110, 111, 110, 112,
    112, 113]
# the next state after an MPS is the next index, but at the end of each run
_NMPS_JUMP = {13: 13, 35: 9, 63: 32, 79: 48, 87: 71, 94: 86, 100: 93, 104: 99, 107: 103,
              109: 107, 111: 109, 112: 111, 113: 113}
_SWITCH = (0, 14, 36, 64, 80, 88, 95, 105, 110, 112)
# libjpeg's packing (jaricom.c): Qe << 16 | next MPS << 8 | switch << 7 | next LPS
ARITAB = [(_QE[i] << 16) | (_NMPS_JUMP.get(i, i + 1) << 8) | ((i in _SWITCH) << 7) | _NLPS[i]
          for i in range(114)]


class _ArithOverflow(Exception):
    """libjpeg's JWRN_ARITH_BAD_CODE: corrupt arithmetic-coded data; the
    rest of the restart interval is left as it is."""


def _arith_interval(data: bytes, units, mode: int, ss: int, se: int, al: int,
                    cond_dc: Dict[int, Tuple[int, int]], cond_ac: Dict[int, int]) -> bool:
    """Decode the MCUs `units` of one restart interval of an arithmetic-coded
    scan (T.81 Annex D, F.1.4 / F.2.4 and G.1.3; libjpeg's jdarith.c).  A
    unit is a list of (block, component, DC table, AC table), a block's 64
    coefficients in zigzag order; `cond_dc` and `cond_ac` map a table to the
    conditioning of the DAC segment ((L, U) and Kx).  Statistics, DC predictors and contexts
    start at zero; past the end of `data` the coder reads zeros, as libjpeg
    does once it meets a marker.  A magnitude or spectral overflow (corrupt
    data) leaves the rest of the interval as it is, the block being decoded
    with what it had, as libjpeg's jdarith.c does.  -> False (the
    arithmetic decoder has no out-of-data flag).  A sequential scan ignores
    its header's Ss, Se, Ah and Al (jdarith.c only warns,
    JWRN_NOT_SEQUENTIAL, and its decode_mcu codes coefficients 1 to 63
    unshifted), as it does where a file cut inside the SOS segment leaves
    them to the fake EOI markers libjpeg reads past the end."""
    if mode == _SEQUENTIAL:
        al = 0
    n = len(data)
    pos, c, a, ct = 0, 0, 0, -16
    dc_stats: Dict[int, List[int]] = {}
    ac_stats: Dict[int, List[int]] = {}
    last: Dict[int, int] = {}
    ctx: Dict[int, int] = {}
    fixed = [113]

    def decode(st: List[int], i: int) -> int:
        nonlocal pos, c, a, ct
        while a < 0x8000:                   # renormalise, reading bytes (D.2.6)
            ct -= 1
            if ct < 0:
                c = (c << 8) | (data[pos] if pos < n else 0)
                pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000          # the two initial bytes are in
            a <<= 1
        sv = st[i]
        e = ARITAB[sv & 0x7F]
        qe, nl, nm = e >> 16, e & 0xFF, (e >> 8) & 0xFF
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:                      # conditional exchange
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7

    def bits_of(st: List[int], i: int, m: int) -> int:
        """Figure F.24: the bits of |v| - 1 below its top bit m, all from
        bin i + 14; -> |v|."""
        v, i = m, i + 14
        while m > 1:
            m >>= 1
            if decode(st, i):
                v |= m
        return v + 1

    def category(st: List[int], i: int, m: int) -> Tuple[int, int]:
        """Figure F.23 from bin i on: -> (top bit of |v| - 1, last bin)."""
        while decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise _ArithOverflow
            i += 1
        return m, i

    def dc_diff(comp: int, t: int) -> int:
        st = dc_stats.setdefault(t, [0] * 64)
        s0 = ctx.get(comp, 0)
        if not decode(st, s0):
            ctx[comp] = 0
            return 0
        sign = decode(st, s0 + 1)
        i = s0 + 2 + sign
        m = decode(st, i)
        if m:
            m, i = category(st, 20, 1)
        lo, hi = cond_dc.get(t, (0, 1))
        # the conditioning category of the next difference (F.1.4.4.1.2)
        if m < (1 << lo) >> 1:
            ctx[comp] = 0
        elif m > (1 << hi) >> 1:
            ctx[comp] = 12 + 4 * sign
        else:
            ctx[comp] = 4 + 4 * sign
        v = bits_of(st, i, m)
        return -v if sign else v

    def ac_first(blk: List[int], t: int, k: int, se: int) -> None:
        st = ac_stats.setdefault(t, [0] * 256)
        kx = cond_ac.get(t, 5)
        while k <= se:
            i = 3 * (k - 1)
            if decode(st, i):               # end of block
                return
            while not decode(st, i + 1):
                i += 3
                k += 1
                if k > se:
                    raise _ArithOverflow
            sign = decode(fixed, 0)
            i += 2
            m = decode(st, i)
            if m and decode(st, i):
                m, i = category(st, 189 if k <= kx else 217, 2)
            v = bits_of(st, i, m)
            blk[k] = (-v if sign else v) << al
            k += 1

    def ac_refine(blk: List[int], t: int) -> None:
        st = ac_stats.setdefault(t, [0] * 256)
        p1, m1 = 1 << al, -1 << al
        kex = se
        while kex > 0 and not blk[kex]:
            kex -= 1
        k = ss
        while k <= se:
            i = 3 * (k - 1)
            if k > kex and decode(st, i):   # end of band
                return
            while True:
                if blk[k]:                  # a correction bit
                    if decode(st, i + 2):
                        blk[k] += m1 if blk[k] < 0 else p1
                    break
                if decode(st, i + 1):       # a newly nonzero coefficient
                    blk[k] = m1 if decode(fixed, 0) else p1
                    break
                i += 3
                k += 1
                if k > se:
                    raise _ArithOverflow
            k += 1

    try:
        for unit in units:
            for blk, comp, dct, act in unit:
                if mode in (_SEQUENTIAL, _DC_FIRST):
                    v = (last.get(comp, 0) + dc_diff(comp, dct)) & 0xFFFF
                    last[comp] = v
                    v = v - 0x10000 if v >= 0x8000 else v
                    blk[0] = _w16(v << al) if mode == _DC_FIRST else v
                    if mode == _SEQUENTIAL:
                        ac_first(blk, act, 1, 63)
                elif mode == _DC_REFINE:
                    if decode(fixed, 0):
                        blk[0] |= 1 << al
                elif mode == _AC_FIRST:
                    ac_first(blk, act, ss, se)
                else:
                    ac_refine(blk, act)
    except _ArithOverflow:
        pass
    return False


def _lossless_rows(data: bytes, flat: np.ndarray, fresh: np.ndarray, row0: int, rows: int,
                   mcols: int, pattern: List[int], tables) -> bool:
    """Decode MCU rows [row0, row0 + rows) of one restart interval of a
    Huffman-coded lossless scan (T.81 H.1.2.2; libjpeg-turbo's jdlhuff.c)
    into `flat` (the sample differences, one MCU a row: the components of
    its samples in `pattern` order; `tables` the DC look-up table of each
    component).  As libjpeg does, the row during which the data runs out is
    decoded to its end with zero bits; the rows after it keep zero
    differences and their `fresh` mark (the undifferencer starts anew on
    each: a constant row).  `fresh` is cleared on every decoded row but the
    interval's first.  -> True if the data ran out."""
    try:
        return _lossless_decode(_windows(data), len(data), flat, fresh, row0, rows, mcols,
                                pattern, tables)
    except IndexError:        # a row read past the zeros after the data: room for a row
        return _lossless_decode(_windows(data, 5 * mcols * len(pattern) + 8), len(data), flat,
                                fresh, row0, rows, mcols, pattern, tables)


def _lossless_decode(win, n_bytes, flat, fresh, row0, rows, mcols, pattern, tables) -> bool:
    """`_lossless_rows` on the stream's windows (`_windows`)."""
    n_bits = 8 * n_bytes
    pos = 0
    per = len(pattern)
    for r in range(row0, row0 + rows):
        if pos > n_bits:
            return True
        out = []
        for _ in range(mcols):
            for comp in pattern:
                look = tables[comp][win[pos]]
                pos += look >> 8
                s = look & 255
                if s == 16:
                    v = 32768
                elif s:
                    v = win[pos] >> (16 - s)
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                else:
                    v = 0
                out.append(v)
        flat[r * mcols:(r + 1) * mcols] = np.asarray(out, np.int64).reshape(mcols, per)
        fresh[r] = r == row0
    return pos > n_bits


def _undifference(diff: np.ndarray, predictor: int, first: int, fresh: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's jdpred.c: samples [h, w] from their differences.  A
    row marked `fresh` (the first row, one that starts a restart interval,
    one the decoder found no data for) predicts each sample from its left
    neighbour, its first sample from `first`; every other row's first
    sample from the one above, the rest by `predictor` (1: a, 2: b, 3: c,
    4: a + b - c, 5: a + (b - c) / 2, 6: b + (a - c) / 2, 7: (a + b) / 2;
    a left, b above, c above left), modulo 2^16."""
    h, w = diff.shape
    out = np.empty((h, w), np.int64)
    for y in range(h):
        d = diff[y]
        if fresh[y]:
            d = d.copy()
            d[0] += first
            out[y] = np.cumsum(d) & 0xFFFF
            continue
        b = out[y - 1]
        cc = np.concatenate([b[:1], b[:-1]])       # c; the first column uses b
        if predictor in (1, 4, 5):
            step = {1: 0, 4: b - cc, 5: (b - cc) >> 1}[predictor]
            row = d + step
            row[0] = d[0] + b[0]
            out[y] = np.cumsum(row) & 0xFFFF
        elif predictor in (2, 3):
            out[y] = (d + (b if predictor == 2 else cc)) & 0xFFFF
        else:
            r, bl, cl, dl = [0] * w, b.tolist(), cc.tolist(), d.tolist()
            ra = r[0] = (dl[0] + bl[0]) & 0xFFFF
            for x in range(1, w):
                p = bl[x] + ((ra - cl[x]) >> 1) if predictor == 6 else (ra + bl[x]) >> 1
                ra = r[x] = (dl[x] + p) & 0xFFFF
            out[y] = r
    return out


_FIX_Q = {n: v for n, v in zip(
    ("0_298", "0_390", "0_541", "0_765", "0_899", "1_175", "1_501", "1_847", "1_961", "2_053",
     "2_562", "3_072"),
    (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137, 16069, 16819, 20995, 25172))}


def _islow_pass(d: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of libjpeg-turbo's SIMD jpeg_idct_islow (jidctint-sse2.asm /
    -avx2.asm, which OpenCV's libjpeg-turbo runs on x86) over the 8 int16
    inputs d: jidctint.c's butterfly with 13-bit constants, its products
    paired as the SIMD code pairs them, in0 + in4, in0 - in4, in7 + in3 and
    in5 + in1 taken in 16 bits (wrapping), the rest in 32, each output
    descaled by `shift` bits with rounding and saturated to 16 bits.  On the
    values of a valid file this is jidctint.c to the bit; corrupt data can
    reach the wraps and saturations."""
    f = _FIX_Q
    in0, in1, in2, in3, in4, in5, in6, in7 = d
    tmp3 = in2 * (f["0_541"] + f["0_765"]) + in6 * f["0_541"]
    tmp2 = in2 * f["0_541"] + in6 * (f["0_541"] - f["1_847"])
    tmp0, tmp1 = _w16(in0 + in4) << 13, _w16(in0 - in4) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _w16(in7 + in3), _w16(in5 + in1)
    z3, z4 = (z3 * (f["1_175"] - f["1_961"]) + z4 * f["1_175"],
              z3 * f["1_175"] + z4 * (f["1_175"] - f["0_390"]))
    t0 = in7 * (f["0_298"] - f["0_899"]) - in1 * f["0_899"] + z3
    t3 = -in7 * f["0_899"] + in1 * (f["1_501"] - f["0_899"]) + z4
    t1 = in5 * (f["2_053"] - f["2_562"]) - in3 * f["2_562"] + z4
    t2 = -in5 * f["2_562"] + in3 * (f["3_072"] - f["2_562"]) + z3
    r = 1 << (shift - 1)
    return [np.clip((x + r) >> shift, -0x8000, 0x7FFF)
            for x in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                      tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Quantised coefficients [..., 8, 8] (natural order, int16 values in
    int64) and their quantisation table [8, 8] -> the 8-bit samples
    [..., 8, 8] as OpenCV's libjpeg-turbo gives them (its SIMD islow
    inverse DCT, bit for bit): the dequantisation in 16 bits, the columns
    (a block whose rows 1-7 are all zero takes the DC shortcut, shifted in
    16 bits), the rows, and the result saturated to -128..127 plus 128."""
    dq = _w16(coef * q)
    ws = np.stack(_islow_pass([dq[..., k, :] for k in range(8)], 13 - 2), axis=-2)
    dc_only = ~coef[..., 1:, :].any(axis=(-2, -1))
    if dc_only.any():
        ws[dc_only] = _w16(dq[dc_only][:, :1, :] << 2)
    out = np.stack(_islow_pass([ws[..., k] for k in range(8)], 13 + 2 + 3), axis=-1)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _upsample(p: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """libjpeg's default upsampling of a component by (fy, fx): the
    triangle ("fancy") filters for 2x2 and 2x1 (on components more than 2
    samples wide) and 1x2, replication otherwise."""
    p = p.astype(np.int64)
    if (fy, fx) == (1, 1):
        return p
    if fx == 2 and fy in (1, 2) and p.shape[1] > 2:
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
    """libjpeg's ycc_rgb_convert (16-bit fixed point, clamped) -> int64
    [H, W, 3]."""
    cb, cr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((_FIX(1.402) * cr + half) >> 16)
    b = y + ((_FIX(1.772) * cb + half) >> 16)
    g = y + ((-_FIX(0.34414) * cb - _FIX(0.71414) * cr + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255)


def _color_space(nc: int, ids: List[int], jfif: bool, adobe, lossless: bool) -> str:
    """The colour space libjpeg-turbo assumes (jdapimin.c
    default_decompress_parms): JFIF means YCbCr; an Adobe APP14 segment's
    transform picks RGB / YCbCr (3 components) or CMYK / YCCK (4); without
    either, component ids 1, 2, 3 mean YCbCr (RGB in a lossless file) and
    'R', 'G', 'B' mean RGB."""
    if nc == 1:
        return "gray"
    if nc == 4:
        return "cmyk" if adobe == 0 or adobe is None else "ycck"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    if ids == [82, 71, 66]:
        return "rgb"
    return "rgb" if lossless else "ycc"


def _to_output(planes: List[np.ndarray], space: str) -> np.ndarray:
    """Full-size component planes -> what cv2.imread(IMREAD_UNCHANGED)
    gives, channels in RGB order: gray [H, W, 1], colour [H, W, 3].  Four
    components come out of libjpeg as CMYK (YCCK converted to it: C, M, Y
    = 255 - R, G, B) and go to colour as OpenCV's icvCvt_CMYK2BGR does (the
    samples taken as Adobe's inverted CMYK: k - ((255 - c) k >> 8))."""
    if space == "gray":
        return planes[0].astype(np.uint8)[..., None]
    if space == "rgb":
        return np.stack(planes[:3], -1).astype(np.uint8)
    if space == "ycc":
        return _ycc_to_rgb(*planes).astype(np.uint8)
    cmy = np.stack(planes[:3], -1)
    if space == "ycck":
        cmy = 255 - _ycc_to_rgb(*planes[:3])
    k = planes[3][..., None].astype(np.int64)
    return (k - (((255 - cmy) * k) >> 8)).astype(np.uint8)


# libjpeg's stdio source (OpenCV's cv2.imread reads a file through it) at
# the end of a file: a warning, then FF D9, a fake EOI, each time it is
# asked for more bytes -- past the end, a marker segment reads these bytes
# and a scan meets an EOI
_EOF_FILL = b"\xff\xd9" * 32770

# frame markers: SOFn -> (coding, progressive); the rest of the SOF range
# (hierarchical, arithmetic-coded lossless) raises
_FRAMES = {0xC0: ("huffman", False), 0xC1: ("huffman", False), 0xC2: ("huffman", True),
           0xC3: ("lossless", False), 0xC9: ("arithmetic", False),
           0xCA: ("arithmetic", True)}
_UNREAD = {0xC5: "hierarchical", 0xC6: "hierarchical", 0xC7: "hierarchical",
           0xCB: "arithmetic-coded lossless", 0xCD: "hierarchical", 0xCE: "hierarchical",
           0xCF: "hierarchical"}
# the markers libjpeg's read_markers takes; any other (JPG, JPGn, RESn,
# DHP, EXP) stops it (JERR_UNKNOWN_MARKER)
_SEGMENTS = {0xC4, 0xCC, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE, *range(0xE0, 0xF0)}
# libjpeg's jpeg_std_huff_tables (the standard's tables): jdhuff.c puts
# them in the slots of a sequential Huffman file that no DHT filled
_STD_DC = {0: _DC_LUMA, 1: _DC_CHROMA}
_STD_AC = {0: _AC_LUMA, 1: _AC_CHROMA}
# the natural positions of the DC and the first 9 AC coefficients in
# zigzag order: libjpeg-turbo's block smoothing estimates AC 1-9
_SMOOTH_POS = ZIGZAG[:10]


def _u16(src: bytes, p: int) -> int:
    return (src[p] << 8) | src[p + 1]


def decode_jpeg(data: bytes, space: Optional[str] = None) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 1] (gray) or [H, W, 3] (RGB), as
    cv2.imread(IMREAD_UNCHANGED) decodes them (channels in RGB order).
    Reads 8-bit sequential and progressive files, Huffman- or
    arithmetic-coded, and lossless (Huffman) files of 2-8 bits; 1, 3 or 4
    components.  Hierarchical, arithmetic-coded lossless and 12-bit files
    raise.

    A damaged file reads as libjpeg-turbo reads it from a file: the bytes
    after the end are fake EOI markers; entropy-coded data that runs out
    leaves the rest of its restart interval as it was (zero coefficients in
    a sequential file: gray 128); a bad Huffman code decodes as 0; bytes
    before a marker are skipped; a restart marker out of place goes through
    libjpeg's resynchronisation; a progressive file whose scans stop short
    gets libjpeg-turbo's block smoothing.  What libjpeg treats as fatal (a
    scan before the frame, no scan at all, a table that is missing or
    malformed, a bad length, an unknown marker, a bad scan header) raises
    NoImage, as cv2.imread returns none; after the scan of a one-scan
    file, libjpeg reads nothing that could change the image.

    `space` overrides the colour space libjpeg would assume, as libtiff's
    JPEG codec does: "ycc" converts three components YCbCr -> RGB
    (JPEGCOLORMODE_RGB), "raw" gives the components as decoded, [H, W, n]
    (JCS_UNKNOWN; full-size components only, as libtiff then reads no
    subsampled ones)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    src = data + _EOF_FILL
    qt: Dict[int, np.ndarray] = {}
    dc_t: Dict[int, list] = {}          # table id -> [BITS, HUFFVAL, look-up table]
    ac_t: Dict[int, list] = {}
    cond_dc: Dict[int, Tuple[int, int]] = {}
    cond_ac: Dict[int, int] = {}
    frame = None
    coding, progressive = "huffman", False
    restart = 0
    jfif, adobe = False, None
    # per component: its blocks (64 zigzag coefficients each) over the grid
    # of whole MCUs, row-major, and the grid's (rows, columns); a lossless
    # frame's components hold the samples instead
    coefs: Dict[int, List[List[int]]] = {}
    grids: Dict[int, Tuple[int, int]] = {}
    samples: Dict[int, np.ndarray] = {}
    qlatch: Dict[int, np.ndarray] = {}   # the quantisation table of a component's first scan
    # progressive: libjpeg's coef_bits of each component (the Al of the
    # last scan of each coefficient, -1 before any) and the values before
    # its latest scan
    bits_now: Dict[int, List[int]] = {}
    bits_prev: Dict[int, List[int]] = {}
    scans, last_good = 0, 0
    scanned = set()
    marker, p = None, 2
    while True:
        if marker is None:
            marker, p = _next_marker(src, p)
        m, marker = marker, None
        if m == 0xD9:
            if not scans:
                raise NoImage("JPEG: the image ends before its first scan (libjpeg stops: "
                              "JERR_NO_IMAGE)")
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if m in _UNREAD or (m in _FRAMES and frame is not None):
            if frame is not None:
                raise NoImage("JPEG: a second frame header (libjpeg stops: JERR_SOF_DUPLICATE)")
            # OpenCV refuses both: libjpeg-turbo has no hierarchical decoder
            # and no arithmetic decoder of lossless scans (JERR_ARITH_NOTIMPL)
            raise NoImage(f"JPEG: {_UNREAD[m]} files are not read (OpenCV's libjpeg-turbo "
                          f"decodes no such file either)")
        if m not in _FRAMES and m not in _SEGMENTS:
            raise NoImage(f"JPEG: marker {m:#04x} (libjpeg stops: JERR_UNKNOWN_MARKER or "
                          f"JERR_SOI_DUPLICATE)")
        n = _u16(src, p)
        if m in _FRAMES:
            prec, H, W, nc = src[p + 2], _u16(src, p + 3), _u16(src, p + 5), src[p + 7]
            if frame is not None or not (H and W and nc) or n != 8 + 3 * nc:
                raise NoImage("JPEG: a second, empty or malformed frame header (libjpeg stops)")
            coding, progressive = _FRAMES[m]
            if coding == "lossless" and not 2 <= prec <= 8:
                raise NoImage(f"JPEG: {prec}-bit lossless files are not read (OpenCV returns "
                              f"no image for them)")
            if coding != "lossless" and prec != 8:
                raise NoImage(f"JPEG: {prec}-bit samples are not supported (8-bit only)")
            if nc not in (1, 3, 4):
                raise ValueError(f"JPEG: {nc} components are not supported (1, 3 or 4)")
            comps = [(src[p + 8 + 3 * i], src[p + 9 + 3 * i] >> 4, src[p + 9 + 3 * i] & 15,
                      src[p + 10 + 3 * i]) for i in range(nc)]
            if H > 65500 or W > 65500 or any(not (1 <= c[1] <= 4 and 1 <= c[2] <= 4)
                                            for c in comps):
                raise NoImage("JPEG: a frame too large or with bad sampling factors (libjpeg "
                              "stops)")
            frame = (H, W, comps, prec)
            p += n                          # libjpeg's get_sof reads the segment by its length
            if W * H > 1 << 30:
                # past OpenCV's limit: cv2.imread raises once libjpeg's
                # jpeg_read_header reaches the first scan; nothing is allocated
                continue
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            unit = 1 if coding == "lossless" else 8
            for cid, h, v, _ in comps:
                grids[cid] = (-(-H // (unit * vmax)) * v, -(-W // (unit * hmax)) * h)
                if coding == "lossless":
                    samples[cid] = np.zeros(grids[cid], np.int64)
                else:
                    coefs[cid] = [[0] * 64 for _ in range(grids[cid][0] * grids[cid][1])]
                bits_now[cid] = [-1] * 64
                bits_prev[cid] = [-1] * 64
        elif m == 0xDA:
            if frame is None:
                raise NoImage("JPEG: a scan before the frame header (libjpeg stops: "
                              "JERR_SOS_NO_SOF)")
            check_size(frame[1], frame[0], "JPEG")
            marker, p, good, ns = _scan(src, p, frame, coding, progressive, restart, scans,
                                        dc_t, ac_t, qt, qlatch, cond_dc, cond_ac, coefs, grids,
                                        samples, bits_now, bits_prev, scanned)
            scans += 1
            last_good = good
            if scans == 1 and not progressive and ns == len(frame[2]):
                # one scan of every component: libjpeg decodes it as it
                # outputs the image and reads nothing after it that could
                # change the image
                break
            continue
        else:
            body = src[p + 2:p + max(n, 2)]
            if m == 0xC4:
                i = 0
                while len(body) - i > 16:
                    cls, tid = body[i] >> 4, body[i] & 15
                    bits = list(body[i + 1:i + 17])
                    count = sum(bits)
                    if count > 256 or count > len(body) - i - 17 or cls > 1 or tid > 3:
                        raise NoImage("JPEG: a malformed DHT segment (libjpeg stops)")
                    vals = list(body[i + 17:i + 17 + count])
                    i += 17 + count
                    (ac_t if cls else dc_t)[tid] = [bits, vals, None]
                if i != len(body):
                    raise NoImage("JPEG: a DHT segment of a bad length (JERR_BAD_LENGTH)")
            elif m == 0xDB:
                i = 0
                while i < len(body):
                    prec, tid = body[i] >> 4, body[i] & 15
                    size = 129 if prec else 65
                    if tid > 3:
                        raise NoImage(f"JPEG: a DQT segment for table {tid} (libjpeg stops: "
                                      "JERR_DQT_INDEX)")
                    if len(body) - i < size:
                        raise NoImage("JPEG: a DQT segment shorter than its table (libjpeg "
                                      "stops: JERR_BAD_LENGTH)")
                    if prec:
                        q = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int64)
                    else:
                        q = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += size
                    qt[tid] = q
            elif m == 0xCC:                 # arithmetic conditioning (DAC)
                if len(body) % 2:
                    raise NoImage("JPEG: a DAC segment of a bad length (JERR_BAD_LENGTH)")
                for i in range(0, len(body), 2):
                    cls, tid, v = body[i] >> 4, body[i] & 15, body[i + 1]
                    if cls > 1 or (not cls and (v & 15) > (v >> 4)):
                        raise NoImage("JPEG: a malformed DAC segment (libjpeg stops)")
                    if cls:
                        cond_ac[tid] = v
                    else:
                        cond_dc[tid] = (v & 15, v >> 4)
            elif m == 0xDD:
                if n != 4:
                    raise NoImage("JPEG: a DRI segment of a bad length (JERR_BAD_LENGTH)")
                restart = _u16(body, 0)
            elif m == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\x00":
                jfif = True
            elif m == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
            p += max(n, 2)
    H, W, comps, prec = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    smooth = progressive and _smoothing_ok(comps, qlatch, bits_now)
    planes = []
    if coding == "lossless" and any(cid not in scanned for cid, _, _, _ in comps):
        # seen in OpenCV's libjpeg-turbo: a lossless file cut before a
        # component's scan gives no image
        raise NoImage("JPEG: a lossless file with a component no scan reached (OpenCV returns "
                      "no image)")
    for cid, h, v, tq in comps:
        cw, ch = -(-W * h // hmax), -(-H * v // vmax)
        if coding == "lossless":
            plane = samples[cid][:ch, :cw]
        else:
            by, bx = grids[cid]
            grid = np.asarray(coefs[cid], np.int64).reshape(by, bx, 64)
            if smooth:
                prev = bits_prev[cid] if scans > 1 else [-1] * 64
                grid = _smooth(grid, -(-ch // 8), -(-cw // 8), v, -(-H // (8 * vmax)),
                               qlatch[cid][_INV_ZIGZAG], bits_now[cid], prev, last_good)
            nat = np.zeros(grid.shape, np.int64)
            nat[..., ZIGZAG] = grid
            # a component no scan reached has no table: libjpeg's multipliers are 0
            q = qlatch[cid][_INV_ZIGZAG] if cid in qlatch else np.zeros(64, np.int64)
            pix = idct_islow(nat.reshape(by, bx, 8, 8), q.reshape(8, 8)).astype(np.int64)
            plane = pix.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)[:ch, :cw]
        if coding == "lossless":
            # libjpeg-turbo's fancy upsampling needs DCT blocks: a lossless
            # component is replicated
            plane = np.repeat(np.repeat(plane, vmax // v, axis=0), hmax // h, axis=1)
        else:
            plane = _upsample(plane, vmax // v, hmax // h)
        planes.append(plane[:H, :W])
    if space == "raw":
        if hmax > 1 or vmax > 1:
            raise ValueError("JPEG: subsampled components without a colour conversion are not "
                             "read by the port")
        return np.stack(planes, -1).astype(np.uint8)
    if space == "ycc":
        if len(planes) != 3:
            raise ValueError(f"JPEG: a YCbCr conversion of {len(planes)} components")
        return _to_output(planes, "ycc")
    space = _color_space(len(comps), [c[0] for c in comps], jfif, adobe, coding == "lossless")
    if coding == "lossless" and space in ("ycc", "ycck"):
        raise NoImage("JPEG: a lossless file in YCbCr or YCCK needs a colour conversion that "
                      "libjpeg-turbo refuses in lossless mode (OpenCV returns no image)")
    return _to_output(planes, space)


# natural index -> zigzag index (a table in zigzag order read in natural order)
_INV_ZIGZAG = np.argsort(ZIGZAG)


def _scan(src, p, frame, coding, progressive, restart, scans, dc_t, ac_t, qt, qlatch, cond_dc,
          cond_ac, coefs, grids, samples, bits_now, bits_prev, scanned):
    """One SOS segment at p and its entropy-coded data, as libjpeg's get_sos,
    the per-scan set-up (quantisation tables latched, Huffman tables
    derived, progressive parameters checked and coef_bits updated) and the
    scan's decoder take them; `scans` counts the scans before it.  ->
    (the marker met after the scan, the position after it), the marker a
    (the marker met after the scan, the position after it, libjpeg's
    last_good_iMCU_row after it, the scan's number of components)."""
    H, W, comps, prec = frame
    n, ns = _u16(src, p), src[p + 2]
    if n != 2 * ns + 6 or not 1 <= ns <= 4:
        raise NoImage("JPEG: an SOS segment of a bad length (JERR_BAD_LENGTH)")
    # libjpeg's component search: by id, among the first four components,
    # skipping a component whose index is taken in the scan's list
    cur: List[Optional[int]] = [None] * 4
    sel = {}
    for i in range(ns):
        cc, c = src[p + 3 + 2 * i], src[p + 4 + 2 * i]
        ci = next((k for k in range(min(len(comps), 4))
                   if comps[k][0] == cc and cur[k] is None), None)
        if ci is None:
            raise NoImage(f"JPEG: a scan names component {cc}, which the frame lacks or the "
                          f"scan names twice (JERR_BAD_COMPONENT_ID)")
        cur[i] = ci
        sel[comps[ci][0]] = c
    q0 = p + 3 + 2 * ns
    ss, se, ah, al = src[q0], src[q0 + 1], src[q0 + 2] >> 4, src[q0 + 2] & 15
    p += n
    scomps = [comps[cur[i]] for i in range(ns)]
    scanned.update(c[0] for c in scomps)
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    if ns > 1 and sum(c[1] * c[2] for c in scomps) > 10:
        raise NoImage("JPEG: more than 10 blocks an MCU (JERR_BAD_MCU_SIZE)")
    if coding == "lossless":
        if not (1 <= ss <= 7 and se == 0 and ah == 0 and al < prec):
            raise NoImage(f"JPEG: lossless scan with predictor {ss}, Se {se}, Ah {ah}, Al {al} "
                          f"(libjpeg stops: JERR_BAD_PROGRESSION)")
        return (*_lossless_scan(src, p, scomps, sel, dc_t, samples, restart, H, W, hmax, vmax,
                                ss, al, prec), 0, ns)
    for cid, _, _, tq in scomps:
        if cid not in qlatch:
            if tq not in qt:
                raise NoImage(f"JPEG: quantisation table {tq} missing (libjpeg stops: "
                              f"JERR_NO_QUANT_TABLE)")
            qlatch[cid] = qt[tq]
    if not progressive:
        mode = _SEQUENTIAL
    elif ss == 0:
        mode = _DC_REFINE if ah else _DC_FIRST
    else:
        mode = _AC_REFINE if ah else _AC_FIRST
    if progressive:
        if (se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)) or \
                (ah and al != ah - 1) or al > 13:
            raise NoImage(f"JPEG: bad progressive scan (Ss {ss}, Se {se}, Ah {ah}, Al {al}, "
                          f"{ns} components; libjpeg stops: JERR_BAD_PROGRESSION)")
        for cid, _, _, _ in scomps:
            now, prev = bits_now[cid], bits_prev[cid]
            for k in range(min(ss, 1), max(se, 9) + 1):
                prev[k] = now[k] if scans else 0
            for k in range(ss, se + 1):
                now[k] = al
    if coding == "arithmetic":
        tab = lambda cid: (sel[cid] >> 4, sel[cid] & 15)
    else:
        if not progressive and not scans:
            # jdhuff.c's jinit_huff_decoder: the standard tables in empty slots
            for tables, std in ((dc_t, _STD_DC), (ac_t, _STD_AC)):
                for tid, (bits, vals) in std.items():
                    tables.setdefault(tid, [bits, vals, None])
        need_dc = mode == _SEQUENTIAL or mode == _DC_FIRST
        need_ac = mode in (_SEQUENTIAL, _AC_FIRST, _AC_REFINE)
        looks = {cid: (_derived(dc_t, sel[cid] >> 4, True) if need_dc else None,
                       _derived(ac_t, sel[cid] & 15, False) if need_ac else None)
                 for cid in sel}
        tab = lambda cid: looks[cid]
    if ns == 1:
        # one block an MCU, over the component's own blocks
        cid, h, v, _ = scomps[0]
        cols = grids[cid][1]
        bw = -(-(-(-W * h // hmax)) // 8)
        bh = -(-(-(-H * v // vmax)) // 8)
        units = [[(coefs[cid][r * cols + c], cid, *tab(cid))]
                 for r in range(bh) for c in range(bw)]
        imcu = lambda u: u // bw // v
    else:
        mcols = -(-W // (8 * hmax))
        units = [[(coefs[cid][(my * v + r) * grids[cid][1] + mx * h + c], cid, *tab(cid))
                  for cid, h, v, _ in scomps for r in range(v) for c in range(h)]
                 for my in range(-(-H // (8 * vmax))) for mx in range(mcols)]
        imcu = lambda u: u // mcols
    last_unit = [0]

    def decode(seg: bytes, first: int, count: int) -> bool:
        part = units[first:first + count]
        if coding == "arithmetic":
            out, done = _arith_interval(seg, part, mode, ss, se, al, cond_dc, cond_ac), count
        else:
            out, done = _decode_interval(seg, part, mode, ss, se, al)
        last_unit[0] = first + done - 1
        return out

    marker, p = _scan_data(src, p, len(units), restart, decode)
    return marker, p, imcu(last_unit[0]), ns


def _lossless_scan(src, p, scomps, sel, dc_t, samples, restart, H, W, hmax, vmax, predictor, pt,
                   prec):
    """Decode one lossless scan from p into `samples` (per component, over
    its grid of whole MCUs): the differences of every restart interval,
    then the prediction, then the point transform (x << Pt, kept to 8
    bits).  -> (the marker met after the scan, the position after it)."""
    if len(scomps) == 1:
        cid, h, v, _ = scomps[0]
        ch, cw = -(-H * v // vmax), -(-W * h // hmax)
        pattern, mrows, mcols, shapes = [cid], ch, cw, {cid: (1, 1)}
    else:
        pattern = [cid for cid, h, v, _ in scomps for _ in range(h * v)]
        mrows, mcols = -(-H // vmax), -(-W // hmax)
        shapes = {cid: (v, h) for cid, h, v, _ in scomps}
    if restart % mcols:
        raise NoImage(f"JPEG: a lossless restart interval of {restart} MCUs, not whole rows "
                      f"of {mcols} (libjpeg stops: JERR_BAD_RESTART)")
    tables = {}
    for cid in sel:
        t = dc_t.get(sel[cid] >> 4)
        if t is not None and any(s > 16 for s in t[1]):
            raise NoImage("JPEG: a lossless Huffman table with a symbol past 16")
        tables[cid] = _derived(dc_t, sel[cid] >> 4, False)
    flat = np.zeros((mrows * mcols, len(pattern)), np.int64)
    fresh = np.ones(mrows, bool)     # rows the undifferencer starts anew on
    rows_per = restart // mcols if restart else mrows

    def decode(seg: bytes, first: int, count: int) -> bool:
        return _lossless_rows(seg, flat, fresh, first, count, mcols, pattern, tables)

    # `_scan_data` counts units: here MCU rows, a restart interval whole rows
    marker, p = _scan_data(src, p, mrows, rows_per if restart else 0, decode)
    col = 0
    for cid in dict.fromkeys(pattern):
        v, h = shapes[cid]
        part = flat[:, col:col + v * h].reshape(mrows, mcols, v, h)
        col += v * h
        grid = part.transpose(0, 2, 1, 3).reshape(mrows * v, mcols * h)
        cv_ = next(c for c in scomps if c[0] == cid)
        ch = -(-H * cv_[2] // vmax)
        cw = -(-W * cv_[1] // hmax)
        rows_fresh = np.zeros(mrows * v, bool)
        rows_fresh[0::v] = fresh
        plane = _undifference(grid[:ch, :cw], predictor, 1 << (prec - pt - 1), rows_fresh[:ch])
        samples[cid][:ch, :cw] = (plane << pt) & 0xFF
    return marker, p


def _smoothing_ok(comps, qlatch, bits_now) -> bool:
    """libjpeg-turbo's smoothing_ok (jdcoefct.c): block smoothing of a
    progressive file's output when every component has its quantisation
    table, nonzero quantisers for the DC and AC 1-9, its DC begun, and some
    of AC 1-9 not yet exact in some component."""
    useful = False
    for cid, _, _, _ in comps:
        if cid not in qlatch or not qlatch[cid][:10].all() or bits_now[cid][0] < 0:
            return False
        useful = useful or any(bits_now[cid][k] != 0 for k in range(1, 10))
    return useful


# libjpeg-turbo's block smoothing (jdcoefct.c decompress_smooth_data): each
# of AC 1-9 -- by its zigzag index k -- estimated from the DC values of the
# 5x5 blocks around, DC(i, j) the block i - 2 rows and j - 2 columns away;
# (k, weights when no AC is known yet (DC interpolation), weights otherwise)
_SMOOTH_AC = [
    (1, [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
         [-1, -1, 0, 1, 1]],
     [[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5]),
    (2, [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0] * 5, [1, -13, -38, -13, 1],
         [1, 3, 3, 3, 1]],
     [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0] * 5, [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]]),
    (3, [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],
     [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]]),
    (4, [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5, [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
     [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5, [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]]),
    (5, [[0] * 5, [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0] * 5],
     [[0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5]),
    (6, [[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0] * 5], None),
    (7, [[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0], [0] * 5], None),
    (8, [[0] * 5, [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0], [0] * 5], None),
    (9, [[0] * 5, [0, 1, 2, 1, 0], [0] * 5, [0, -1, -2, -1, 0], [0] * 5], None),
]
_SMOOTH_DC = [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
              [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]]


def _smooth(grid: np.ndarray, hb: int, wb: int, v: int, T: int, q: np.ndarray,
            bits_now: List[int], bits_prev: List[int], last_good: int) -> np.ndarray:
    """A progressive component's blocks [rows, cols, 64] (zigzag, over the
    grid of whole MCUs) with libjpeg-turbo's block smoothing applied to the
    hb x wb blocks the image holds (`q` its quantisation table in natural
    order, v its vertical sampling, T the iMCU rows): in each block, each
    of AC 1-9 that is still 0 and not known exactly (its coef_bits nonzero)
    gets an estimate from the DC values of the 5x5 blocks around (capped
    below 2^Al), and where no AC is known at all the DC too.  Rows past
    `last_good` (libjpeg's last_good_iMCU_row: the data of the last scan
    ran out before them) use the coef_bits from before that scan.  The
    neighbours at the edges are those libjpeg's sliding registers hold."""
    out = grid.copy()
    D = grid[..., 0]
    rows = np.arange(hb)
    m = rows // v
    block_rows = np.where(m < T - 1, v, hb - (T - 1) * v)
    ibr, total = m * block_rows + rows % v, block_rows * T
    prev = np.where(ibr > 0, rows - 1, rows)
    pprev = np.where(ibr > 1, rows - 2, prev)
    nxt = np.where(ibr < total - 1, rows + 1, rows)
    nnxt = np.where(ibr < total - 2, rows + 2, nxt)
    ring = (pprev, prev, rows, nxt, nnxt)
    late = m > last_good
    qv = {k: int(q[_SMOOTH_POS[k]]) for k in range(10)}
    for bits in (bits_now, bits_prev):
        sel = late if bits is bits_prev else ~late
        if not sel.any():
            continue
        change_dc = all(bits[k] == -1 for k in range(1, 10))
        # the sliding registers, one column of the 5x5 window each, over rows
        reg = [[D[r, 0] for r in ring] for _ in range(5)]
        for c in range(wb):
            if c == 0 and c < wb - 1:
                reg[3] = [D[r, 1] for r in ring]
            if c + 1 < wb - 1:
                reg[4] = [D[r, c + 2] for r in ring]
            dc = [[reg[j][i] for j in range(5)] for i in range(5)]   # dc[i][j] over rows
            blk = out[rows, c]
            for k, w_dc, w_ac in _SMOOTH_AC:
                al = bits[k]
                w = w_dc if change_dc else w_ac
                if al == 0 or w is None:
                    continue
                num = qv[0] * sum(w[i][j] * dc[i][j] for i in range(5) for j in range(5)
                                  if w[i][j])
                qk = qv[k]
                pred = ((qk << 7) + np.abs(num)) // (qk << 8)
                if al > 0:
                    pred = np.minimum(pred, (1 << al) - 1)
                pred = np.where(num >= 0, pred, -pred)
                take = sel & (grid[rows, c, k] == 0)
                blk[take, k] = [_w16(int(x)) for x in pred[take]]
            if change_dc:
                num = qv[0] * sum(_SMOOTH_DC[i][j] * dc[i][j] for i in range(5) for j in range(5))
                pred = ((qv[0] << 7) + np.abs(num)) // (qv[0] << 8)
                pred = np.where(num >= 0, pred, -pred)
                blk[sel, 0] = [_w16(int(x)) for x in pred[sel]]
            out[rows, c] = blk
            reg = reg[1:] + [reg[4]]
    return out


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))
