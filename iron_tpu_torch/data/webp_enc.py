"""Lossless WebP (VP8L) writer on numpy: the file cv2.imwrite(".webp")
writes at OpenCV's default (lossless), read back by cv2.imread and the
port's decoder (`webp.py`) to the same array.

The bitstream (the WebP lossless specification, RFC 9649) is this
encoder's own, not libwebp's: the subtract-green transform, then the
predictor transform over 16 x 16 tiles, each tile the mode of left, top,
their average, Select or ClampAddSubtractFull that leaves the smallest
residuals; no colour cache; runs of equal residual pixels as backward
references to the pixel before (distance code 2); one group of five
canonical prefix codes, each a Huffman code of the image's own counts
limited to 15 bits, written through a code-length code.  The bytes differ
from libwebp's, whose encoder makes choices of its own.

As OpenCV does: gray is written as three equal channels; four channels
keep their alpha, and a file whose alpha is 255 everywhere says it has
none, so it reads back as three channels.  libwebp (not `exact`) also
replaces the colour of pixels whose alpha is 0 by values of its choosing;
this writer keeps them.
"""
from __future__ import annotations

import heapq
import struct
from typing import List, Tuple

import numpy as np

from iron_tpu_torch.data.webp import _CODE_LENGTH_ORDER, _CODE_TO_PLANE

_TILE_BITS = 4                        # predictor tiles of 16 x 16 pixels
_MODES = (1, 2, 7, 11, 12)            # L, T, avg(L, T), Select, ClampAddSubtractFull
_LEFT_PLANE_CODE = _CODE_TO_PLANE.index(0x07) + 1   # (dx, dy) = (1, 0): the pixel before
_MAX_COPY = 4096                      # the longest backward reference


def _huffman_lengths(counts: np.ndarray, limit: int) -> np.ndarray:
    """Code lengths of a complete prefix code of at most `limit` bits for
    the symbols with nonzero `counts` (Huffman's, then JPEG's Annex K.3
    adjustment where a code is longer than `limit`); one used symbol gets
    length 1."""
    used = np.flatnonzero(counts)
    lengths = np.zeros(len(counts), np.int64)
    if used.size == 1:
        lengths[used] = 1
    if used.size <= 1:
        return lengths
    heap = [(int(counts[s]), int(s), (int(s),)) for s in used]
    heapq.heapify(heap)
    depth = {int(s): 0 for s in used}
    tie = len(counts)
    while len(heap) > 1:
        c1, _, a = heapq.heappop(heap)
        c2, _, b = heapq.heappop(heap)
        for s in a + b:
            depth[s] += 1
        heapq.heappush(heap, (c1 + c2, tie, a + b))
        tie += 1
    bits = np.bincount(list(depth.values()), minlength=max(depth.values()) + 1)
    for i in range(len(bits) - 1, limit, -1):      # Annex K.3's adjust_bits
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    order = sorted(used.tolist(), key=lambda s: (depth[s], -int(counts[s]), s))
    k = 0
    for length in range(1, min(len(bits), limit + 1)):
        for _ in range(int(bits[length])):
            lengths[order[k]] = length
            k += 1
    return lengths


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """The canonical codes of `lengths` (shorter first, then by symbol),
    bit-reversed as VP8L reads them (the first bit read is the code's
    first)."""
    codes = np.zeros(len(lengths), np.int64)
    code = 0
    for length in range(1, int(lengths.max(initial=0)) + 1):
        for s in np.flatnonzero(lengths == length):
            codes[s] = int(format(code, f"0{length}b")[::-1], 2)
            code += 1
        code <<= 1
    return codes


class _Fields:
    """Fields of an LSB-first bitstream, as (value, width) arrays."""

    def __init__(self):
        self.values: List[np.ndarray] = []
        self.widths: List[np.ndarray] = []

    def put(self, value: int, width: int) -> None:
        self.values.append(np.array([value], np.int64))
        self.widths.append(np.array([width], np.int64))

    def put_many(self, values: np.ndarray, widths: np.ndarray) -> None:
        self.values.append(np.asarray(values, np.int64).ravel())
        self.widths.append(np.asarray(widths, np.int64).ravel())

    def tobytes(self) -> bytes:
        v = np.concatenate(self.values)
        w = np.concatenate(self.widths)
        keep = w > 0
        v, w = v[keep], w[keep]
        owner = np.repeat(np.arange(len(w)), w)
        pos = np.arange(int(w.sum())) - np.repeat(np.cumsum(w) - w, w)
        bits = ((v[owner] >> pos) & 1).astype(np.uint8)
        return np.packbits(bits, bitorder="little").tobytes()


class _Code:
    """A prefix code of an alphabet, built from the symbols' counts."""

    def __init__(self, counts: np.ndarray):
        self.lengths = _huffman_lengths(counts, 15)
        used = np.flatnonzero(self.lengths)
        self.single = used.size <= 1
        # one symbol (or none) is read with no bits
        self.widths = np.zeros(len(counts), np.int64) if self.single else self.lengths
        self.codes = _canonical_codes(self.lengths)

    def write(self, out: _Fields) -> None:
        used = np.flatnonzero(self.lengths)
        if self.single and (used.size == 0 or used[0] < 256):
            sym = int(used[0]) if used.size else 0      # simple code, one symbol
            out.put(1, 1)
            out.put(0, 1)
            wide = sym > 1
            out.put(int(wide), 1)
            out.put(sym, 8 if wide else 1)
            return
        out.put(0, 1)                                   # a normal code
        tokens, extra, extra_bits = _length_tokens(self.lengths)
        cl = _huffman_lengths(np.bincount(tokens, minlength=19), 7)
        cl_codes = _canonical_codes(cl)
        cl_widths = cl if np.count_nonzero(cl) > 1 else np.zeros(19, np.int64)
        n = max(4, max(i + 1 for i, s in enumerate(_CODE_LENGTH_ORDER) if cl[s]))
        out.put(n - 4, 4)
        for s in _CODE_LENGTH_ORDER[:n]:
            out.put(int(cl[s]), 3)
        out.put(0, 1)                                   # max_symbol: the whole alphabet
        f = np.stack([cl_codes[tokens], extra], 1)
        w = np.stack([cl_widths[tokens], extra_bits], 1)
        out.put_many(f, w)


def _length_tokens(lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Code lengths as code-length-code symbols: 0-15 literal, 16 the
    previous length 3-6 times, 17 zeros 3-10 times, 18 zeros 11-138 times;
    -> (symbols, their extra values, the extra values' widths)."""
    tok, ext, eb = [], [], []
    lengths = lengths.tolist()
    i = 0
    while i < len(lengths):
        v = lengths[i]
        j = i
        while j < len(lengths) and lengths[j] == v:
            j += 1
        n = j - i
        if v == 0:
            while n >= 11:
                k = min(n, 138)
                tok.append(18), ext.append(k - 11), eb.append(7)
                n -= k
            if n >= 3:
                tok.append(17), ext.append(n - 3), eb.append(3)
                n = 0
            tok += [0] * n
            ext += [0] * n
            eb += [0] * n
        else:
            tok.append(v), ext.append(0), eb.append(0)
            n -= 1
            while n >= 3:
                k = min(n, 6)
                tok.append(16), ext.append(k - 3), eb.append(2)
                n -= k
            tok += [v] * n
            ext += [0] * n
            eb += [0] * n
        i = j
    return np.asarray(tok, np.int64), np.asarray(ext, np.int64), np.asarray(eb, np.int64)


def _prefix_split(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """VP8L's prefix coding of lengths and distance codes v >= 1 -> (prefix
    symbol, extra value, extra width)."""
    d = v.astype(np.int64) - 1
    h = np.zeros_like(d)
    big = d >= 4
    h[big] = np.frexp(d[big].astype(np.float64))[1] - 1     # the top bit's place
    second = np.where(big, (d >> np.maximum(h - 1, 0)) & 1, 0)
    sym = np.where(big, 2 * h + second, d)
    width = np.where(big, h - 1, 0)
    extra = np.where(big, d & ((1 << width) - 1), 0)
    return sym, extra, width


def _write_image(out: _Fields, argb: np.ndarray) -> None:
    """An entropy-coded image of uint32 ARGB [n] (no colour cache, no meta
    codes): its five prefix codes, then its pixels, equal runs as backward
    references to the pixel before."""
    n = argb.size
    starts = np.concatenate([[0], np.flatnonzero(argb[1:] != argb[:-1]) + 1])
    run = np.diff(np.concatenate([starts, [n]]))
    # each run: its first pixel as a literal, the rest as copies of <= 4096
    copies = run - 1
    n_copy = -(-copies // _MAX_COPY)
    tok_per_run = 1 + n_copy
    first = np.cumsum(tok_per_run) - tok_per_run
    n_tok = int(tok_per_run.sum())
    is_lit = np.zeros(n_tok, bool)
    is_lit[first] = True
    lit_px = argb[starts]
    k = np.arange(n_tok) - np.repeat(first, tok_per_run)       # 0 literal, 1.. copies
    run_of = np.repeat(np.arange(len(starts)), tok_per_run)
    length = np.minimum(copies[run_of] - (k - 1) * _MAX_COPY, _MAX_COPY)
    copy_len = length[~is_lit]
    lsym, lext, lwid = _prefix_split(copy_len)
    dsym, dext, dwid = _prefix_split(np.full(len(copy_len), _LEFT_PLANE_CODE))

    a, r, g, b = ((lit_px >> s) & 0xFF for s in (24, 16, 8, 0))
    green = _Code(np.bincount(np.concatenate([g, 256 + lsym]).astype(np.int64),
                              minlength=280))
    red, blue, alpha = (_Code(np.bincount(c.astype(np.int64), minlength=256))
                        for c in (r, b, a))
    dist = _Code(np.bincount(dsym, minlength=40))
    for code in (green, red, blue, alpha, dist):
        code.write(out)

    vals = np.zeros((n_tok, 4), np.int64)
    wids = np.zeros((n_tok, 4), np.int64)
    vals[is_lit] = np.stack([green.codes[g], red.codes[r], blue.codes[b], alpha.codes[a]], 1)
    wids[is_lit] = np.stack([green.widths[g], red.widths[r], blue.widths[b],
                             alpha.widths[a]], 1)
    vals[~is_lit] = np.stack([green.codes[256 + lsym], lext, dist.codes[dsym], dext], 1)
    wids[~is_lit] = np.stack([green.widths[256 + lsym], lwid, dist.widths[dsym], dwid], 1)
    out.put_many(vals, wids)


def _residuals(p: np.ndarray):
    """Channels [H, W, 4] (int64, A R G B) -> (residual channels, the mode
    of each tile [th, tw]) of the predictor transform."""
    H, W, _ = p.shape
    L = np.zeros_like(p)
    T = np.zeros_like(p)
    TL = np.zeros_like(p)
    L[:, 1:], T[1:], TL[1:, 1:] = p[:, :-1], p[:-1], p[:-1, :-1]
    preds = {1: L, 2: T, 7: (L + T) >> 1,
             11: np.where((np.abs(L - TL).sum(-1) - np.abs(T - TL).sum(-1) <= 0)[..., None],
                          T, L),
             12: np.clip(L + T - TL, 0, 255)}
    th, tw = -(-H // (1 << _TILE_BITS)), -(-W // (1 << _TILE_BITS))
    costs = []
    for m in _MODES:
        res = (p - preds[m]) & 0xFF
        c = np.minimum(res, 256 - res).sum(-1)
        pad = np.zeros((th << _TILE_BITS, tw << _TILE_BITS), np.int64)
        pad[:H, :W] = c
        costs.append(pad.reshape(th, 1 << _TILE_BITS, tw, 1 << _TILE_BITS).sum((1, 3)))
    modes = np.asarray(_MODES)[np.argmin(np.stack(costs), axis=0)]
    ys, xs = np.arange(H)[:, None] >> _TILE_BITS, np.arange(W)[None, :] >> _TILE_BITS
    per_px = modes[ys, xs]
    pred = np.zeros_like(p)
    for m in _MODES:
        sel = per_px == m
        pred[sel] = preds[m][sel]
    # the edges: the first pixel from opaque black, the first row from the
    # left, the first column from the top
    pred[0, 0] = (255, 0, 0, 0)
    pred[0, 1:] = L[0, 1:]
    pred[1:, 0] = T[1:, 0]
    return (p - pred) & 0xFF, modes


def _pack(ch: np.ndarray) -> np.ndarray:
    """A R G B channels [..., 4] -> uint32 ARGB."""
    ch = ch.astype(np.uint32)
    return (ch[..., 0] << 24) | (ch[..., 1] << 16) | (ch[..., 2] << 8) | ch[..., 3]


def encode_webp_lossless(img: np.ndarray) -> bytes:
    """uint8 [H, W], [H, W, 3] (RGB) or [H, W, 4] (RGBA) as a lossless WebP
    file (RIFF, one VP8L chunk) of at most 16384 pixels a side."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_webp_lossless takes uint8 [H, W] or [H, W, 3 / 4], got "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape[:2]
    if not (1 <= H <= 16384 and 1 <= W <= 16384):
        raise ValueError(f"WebP holds at most 16384 x 16384 pixels, not {W} x {H}")
    a = img[..., 3] if img.shape[2] == 4 else np.full((H, W), 255, np.uint8)
    has_alpha = bool((a != 255).any())
    p = np.stack([a, img[..., 0], img[..., 1], img[..., 2]], -1).astype(np.int64)
    p[..., 1] = (p[..., 1] - p[..., 2]) & 0xFF            # subtract green
    p[..., 3] = (p[..., 3] - p[..., 2]) & 0xFF
    res, modes = _residuals(p)

    out = _Fields()
    out.put(0x2F, 8)
    out.put(W - 1, 14)
    out.put(H - 1, 14)
    out.put(int(has_alpha), 1)
    out.put(0, 3)
    out.put(1, 1)                    # transform: subtract green
    out.put(2, 2)
    out.put(1, 1)                    # transform: predictor
    out.put(0, 2)
    out.put(_TILE_BITS - 2, 3)
    out.put(0, 1)                    # the modes' image: no colour cache
    _write_image(out, (0xFF000000 | (modes.astype(np.uint32) << 8)).ravel())
    out.put(0, 1)                    # no more transforms
    out.put(0, 1)                    # no colour cache
    out.put(0, 1)                    # no meta prefix codes
    _write_image(out, _pack(res).ravel())
    vp8l = out.tobytes()
    chunk = b"VP8L" + struct.pack("<I", len(vp8l)) + vp8l + b"\x00" * (len(vp8l) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
