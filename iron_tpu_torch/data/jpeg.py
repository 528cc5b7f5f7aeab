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
The inverse DCT is libjpeg's integer one (jidctint.c); chroma is upsampled
as libjpeg does by default (triangle filters for 2x2, 2x1 and 1x2,
replication otherwise, and always in a lossless file); the colour space
follows libjpeg's JFIF / Adobe / component-id rules, and four components
(CMYK, YCCK) go to BGR as OpenCV converts them.  Hierarchical, arithmetic-coded lossless and 12-bit DCT
files raise, as do lossless files of more than 8 bits (OpenCV gives no
image for them).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from iron_tpu_torch.data.io import NoImage

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


def _arith_interval(data: bytes, units, mode: int, ss: int, se: int, al: int,
                    cond_dc: Dict[int, Tuple[int, int]], cond_ac: Dict[int, int]) -> None:
    """Decode the MCUs `units` of one restart interval of an arithmetic-coded
    scan (T.81 Annex D, F.1.4 / F.2.4 and G.1.3; libjpeg's jdarith.c).  A
    unit is a list of (block, component, DC table, AC table), a block's 64
    coefficients in zigzag order; `cond_dc` and `cond_ac` map a table to the
    conditioning of the DAC segment ((L, U) and Kx).  Statistics, DC predictors and contexts
    start at zero; past the end of `data` the coder reads zeros, as libjpeg
    does once it meets a marker."""
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
                raise ValueError("JPEG: corrupt arithmetic-coded data (magnitude overflow)")
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
                    raise ValueError("JPEG: corrupt arithmetic-coded data (spectral overflow)")
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
                    raise ValueError("JPEG: corrupt arithmetic-coded data (spectral overflow)")
            k += 1

    for unit in units:
        for blk, comp, dct, act in unit:
            if mode in (_SEQUENTIAL, _DC_FIRST):
                v = (last.get(comp, 0) + dc_diff(comp, dct)) & 0xFFFF
                last[comp] = v
                blk[0] = (v - 0x10000 if v >= 0x8000 else v) << (al if mode == _DC_FIRST else 0)
                if mode == _SEQUENTIAL:
                    ac_first(blk, act, 1, 63)
            elif mode == _DC_REFINE:
                if decode(fixed, 0):
                    blk[0] |= 1 << al
            elif mode == _AC_FIRST:
                ac_first(blk, act, ss, se)
            else:
                ac_refine(blk, act)


def _lossless_interval(data: bytes, units, tables) -> List[int]:
    """The sample differences of one restart interval of a Huffman-coded
    lossless scan (T.81 H.1.2.2; libjpeg-turbo's jdlhuff.c), in the order
    of `units`, each unit the list of the components of its samples, and
    `tables` the DC look-up table of each component."""
    win = _windows(data)
    pos = 0
    out = []
    for unit in units:
        for comp in unit:
            look = tables[comp][win[pos]]
            if not look:
                raise ValueError("JPEG: corrupt lossless data (bad difference code)")
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
    if pos > 8 * len(data):
        raise ValueError("JPEG: lossless data ends early")
    return out


def _undifference(diff: np.ndarray, predictor: int, first: int, restart_rows: int) -> np.ndarray:
    """libjpeg-turbo's jdpred.c: samples [h, w] from their differences.  A
    row that starts a restart interval (and the first row) predicts each
    sample from its left neighbour, its first sample from `first`; every
    other row's first sample from the one above, the rest by `predictor`
    (1: a, 2: b, 3: c, 4: a + b - c, 5: a + (b - c) / 2, 6: b + (a - c) / 2,
    7: (a + b) / 2; a left, b above, c above left), modulo 2^16."""
    h, w = diff.shape
    out = np.empty((h, w), np.int64)
    for y in range(h):
        d = diff[y]
        if y == 0 or (restart_rows and y % restart_rows == 0):
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


def _islow_1d(d: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of libjpeg's jpeg_idct_islow (jidctint.c: 13-bit constants,
    the Loeffler-Ligtenberg-Moschytz butterfly) over the 8 inputs d, each
    output descaled by `shift` bits with rounding."""
    f = _FIX_Q
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * f["0_541"]
    tmp2, tmp3 = z1 - z3 * f["1_847"], z1 + z2 * f["0_765"]
    tmp0, tmp1 = (d[0] + d[4]) << 13, (d[0] - d[4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175"]
    t0, t1, t2, t3 = t0 * f["0_298"], t1 * f["2_053"], t2 * f["3_072"], t3 * f["1_501"]
    z1, z2 = z1 * -f["0_899"], z2 * -f["2_562"]
    z3, z4 = z3 * -f["1_961"] + z5, z4 * -f["0_390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    r = 1 << (shift - 1)
    return [(x + r) >> shift for x in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                       tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients [..., 8, 8] (natural order, int64) -> the
    8-bit samples [..., 8, 8] as libjpeg's default (JDCT_ISLOW) inverse DCT
    gives them, bit for bit: columns then rows, and its range limit (the
    result taken modulo 1024 as a signed 10-bit value, plus 128, clamped)."""
    cols = _islow_1d([coef[..., k, :] for k in range(8)], 13 - 2)
    ws = np.stack(cols, axis=-2)
    rows = _islow_1d([ws[..., k] for k in range(8)], 13 + 2 + 3)
    out = np.stack(rows, axis=-1) & 1023
    out = np.where(out >= 512, out - 1024, out) + 128
    return np.clip(out, 0, 255).astype(np.uint8)


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


# frame markers: SOFn -> (coding, progressive); the rest of the SOF range
# (hierarchical, arithmetic-coded lossless) raises
_FRAMES = {0xC0: ("huffman", False), 0xC1: ("huffman", False), 0xC2: ("huffman", True),
           0xC3: ("lossless", False), 0xC9: ("arithmetic", False),
           0xCA: ("arithmetic", True)}
_UNREAD = {0xC5: "hierarchical", 0xC6: "hierarchical", 0xC7: "hierarchical",
           0xCB: "arithmetic-coded lossless", 0xCD: "hierarchical", 0xCE: "hierarchical",
           0xCF: "hierarchical"}


def decode_jpeg(data: bytes, space: Optional[str] = None) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 1] (gray) or [H, W, 3] (RGB), as
    cv2.imread(IMREAD_UNCHANGED) decodes them (channels in RGB order).
    Reads 8-bit sequential and progressive files, Huffman- or
    arithmetic-coded, and lossless (Huffman) files of 2-8 bits; 1, 3 or 4
    components.  Hierarchical, arithmetic-coded lossless and 12-bit files
    raise.

    `space` overrides the colour space libjpeg would assume, as libtiff's
    JPEG codec does: "ycc" converts three components YCbCr -> RGB
    (JPEGCOLORMODE_RGB), "raw" gives the components as decoded, [H, W, n]
    (JCS_UNKNOWN; full-size components only, as libtiff then reads no
    subsampled ones)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qt: Dict[int, np.ndarray] = {}
    dc_t: Dict[int, List[int]] = {}
    ac_t: Dict[int, List[int]] = {}
    cond_dc: Dict[int, Tuple[int, int]] = {}
    cond_ac: Dict[int, int] = {}
    frame = None
    coding, progressive = "huffman", False
    restart = 0
    jfif, adobe = False, None
    # per component: its blocks (64 zigzag coefficients each) over the grid
    # of whole MCUs, row-major, and the grid's (rows, columns); a lossless
    # frame's components hold one difference a sample instead
    coefs: Dict[int, List[List[int]]] = {}
    grids: Dict[int, Tuple[int, int]] = {}
    samples: Dict[int, np.ndarray] = {}
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
        if marker in _UNREAD:
            # hierarchical files OpenCV refuses; whether it reads a valid
            # arithmetic-coded lossless file is not known
            err = NoImage if _UNREAD[marker] == "hierarchical" else ValueError
            raise err(f"JPEG: {_UNREAD[marker]} files are not read (OpenCV's libjpeg-turbo "
                      f"decodes no such file either)")
        if marker == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
            adobe = body[11]
        elif marker == 0xDB:
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
        elif marker == 0xCC:                 # arithmetic conditioning (DAC)
            for i in range(0, len(body) - 1, 2):
                cls, tid, v = body[i] >> 4, body[i] & 15, body[i + 1]
                if cls:
                    cond_ac[tid] = v
                else:
                    cond_dc[tid] = (v & 15, v >> 4)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker in _FRAMES:
            coding, progressive = _FRAMES[marker]
            prec, H, W, nc = struct.unpack(">BHHB", body[:6])
            if coding == "lossless" and not 2 <= prec <= 8:
                raise NoImage(f"JPEG: {prec}-bit lossless files are not read (OpenCV returns "
                              f"no image for them)")
            if coding != "lossless" and prec != 8:
                raise NoImage(f"JPEG: {prec}-bit samples are not supported (8-bit only)")
            if nc not in (1, 3, 4):
                raise ValueError(f"JPEG: {nc} components are not supported (1, 3 or 4)")
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                      body[8 + 3 * i]) for i in range(nc)]
            frame = (H, W, comps, prec)
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            unit = 1 if coding == "lossless" else 8
            for cid, h, v, _ in comps:
                grids[cid] = (-(-H // (unit * vmax)) * v, -(-W // (unit * hmax)) * h)
                if coding == "lossless":
                    samples[cid] = np.zeros(grids[cid], np.int64)
                else:
                    coefs[cid] = [[0] * 64 for _ in range(grids[cid][0] * grids[cid][1])]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            H, W, comps, prec = frame
            ns = body[0]
            sel = {body[1 + 2 * i]: body[2 + 2 * i] for i in range(ns)}
            ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, \
                body[3 + 2 * ns] & 15
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            scomps = [c for c in comps if c[0] in sel]
            segs, pos = _scan_segments(data, pos)
            if coding == "lossless":
                if not 1 <= ss <= 7:
                    raise ValueError(f"JPEG: lossless scan with predictor {ss}")
                _lossless_scan(segs, scomps, sel, dc_t, samples, grids, restart, H, W, hmax,
                               vmax, ss, al, prec)
                coded.update(c[0] for c in scomps)
                continue
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
            if coding == "arithmetic":
                tab = lambda cid: (sel[cid] >> 4, sel[cid] & 15)
            else:
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
            per = restart if restart else len(units)
            done = 0
            for seg in segs:
                if done >= len(units):
                    break
                if coding == "arithmetic":
                    # fill bytes before the marker are no data; past the end
                    # the coder reads zeros
                    _arith_interval(_unstuff(seg.rstrip(b"\xff")), units[done:done + per], mode,
                                    ss, se, al, cond_dc, cond_ac)
                else:
                    _decode_interval(_unstuff(seg), units[done:done + per], mode, ss, se, al)
                done += per
            if done < len(units):
                raise ValueError("JPEG: fewer MCUs in the scan than the frame needs")
            coded.update(c[0] for c in scomps)
    if frame is None:
        raise ValueError("JPEG: no frame header")
    H, W, comps, prec = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    planes = []
    for cid, h, v, tq in comps:
        if cid not in coded:
            raise ValueError(f"JPEG: no scan holds component {cid}")
        cw, ch = -(-W * h // hmax), -(-H * v // vmax)
        if coding == "lossless":
            plane = samples[cid][:ch, :cw]
        else:
            if tq not in qt:
                raise ValueError(f"JPEG: quantisation table {tq} missing")
            by, bx = grids[cid]
            grid = np.asarray(coefs[cid], np.int64).reshape(by, bx, 64)
            nat = np.zeros(grid.shape, np.int64)
            nat[..., ZIGZAG] = grid * qt[tq]
            pix = idct_islow(nat.reshape(by, bx, 8, 8)).astype(np.int64)
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


def _lossless_scan(segs, scomps, sel, dc_t, samples, grids, restart, H, W, hmax, vmax,
                   predictor, pt, prec) -> None:
    """Decode one lossless scan into `samples` (per component, over its
    grid of whole MCUs): the differences of every restart interval, then
    the prediction, then the point transform (x << Pt, kept to 8 bits)."""
    if len(scomps) == 1:
        cid, h, v, _ = scomps[0]
        ch, cw = -(-H * v // vmax), -(-W * h // hmax)
        pattern, mrows, mcols, shapes = [cid], ch, cw, {cid: (1, 1)}
    else:
        pattern = [cid for cid, h, v, _ in scomps for _ in range(h * v)]
        mrows, mcols = -(-H // vmax), -(-W // hmax)
        shapes = {cid: (v, h) for cid, h, v, _ in scomps}
    tables = {cid: dc_t.get(sel[cid] >> 4) for cid in sel}
    if any(t is None for t in tables.values()):
        raise ValueError("JPEG: a lossless scan names a Huffman table that is not defined")
    n_mcu = mrows * mcols
    per = restart if restart else n_mcu
    diffs: List[int] = []
    for seg in segs:
        if len(diffs) >= n_mcu * len(pattern):
            break
        count = min(per, n_mcu - len(diffs) // len(pattern))
        diffs += _lossless_interval(_unstuff(seg), [pattern] * count, tables)
    if len(diffs) < n_mcu * len(pattern):
        raise ValueError("JPEG: fewer samples in the lossless scan than the frame needs")
    flat = np.asarray(diffs, np.int64).reshape(n_mcu, len(pattern))
    col = 0
    restart_rows = restart // mcols if restart else 0
    for cid in dict.fromkeys(pattern):
        v, h = shapes[cid]
        part = flat[:, col:col + v * h].reshape(mrows, mcols, v, h)
        col += v * h
        grid = part.transpose(0, 2, 1, 3).reshape(mrows * v, mcols * h)
        cv_ = next(c for c in scomps if c[0] == cid)
        ch = -(-H * cv_[2] // vmax)
        cw = -(-W * cv_[1] // hmax)
        plane = _undifference(grid[:ch, :cw], predictor, 1 << (prec - pt - 1),
                              restart_rows * v)
        samples[cid][:ch, :cw] = (plane << pt) & 0xFF


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))
