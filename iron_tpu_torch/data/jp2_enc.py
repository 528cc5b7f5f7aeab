"""A JPEG 2000 writer on numpy: the .jp2 file cv2.imwrite makes of an 8-bit
gray, RGB or RGBA image, byte for byte.  OpenCV hands the image to OpenJPEG
2.5.3 with one quality layer at a compression ratio of 4 (its
IMWRITE_JPEG2000_COMPRESSION_X1000 default) and OpenJPEG's other defaults.

    encode_jp2(img) -> bytes        img: uint8 [H, W], [H, W, 3] or [H, W, 4],
                                    channels in the file's order (RGB(A))

The codestream (ISO/IEC 15444-1): one tile the size of the image, 8-bit
unsigned components without a component transform, the DC level shift of
-128, five levels of the reversible 5/3 wavelet in integer lifting (columns
first, then rows), no quantisation with 2 guard bits, 64 x 64 code-blocks of
the default style in one precinct a resolution, LRCP with one layer.

Tier 1 (`_encode_block`) codes each code-block's bit-planes with the three
passes of Annex D and the MQ coder of Annex C with OpenJPEG's FLUSH, and
keeps, for each pass, OpenJPEG's rate (the bytes so far, plus 3 for a pass
that is not terminated, made non-decreasing and kept off a 0xFF) and its
cumulative distortion decrease (the nmsedec tables at 6 fractional bits,
weighted by the 5/3 norm of the sub-band).

Rate allocation (`_allocate`) is opj_tcd_rateallocate's: a byte budget of
a quarter of the raw pixel bytes less every byte written before the tile
(the JP2 boxes and the main header), and a bisection over R-D slope
thresholds in which a threshold passes where the packets it selects
(opj_tcd_makelayer) fit the budget, stopped once it moves by under 5e-6 of
itself.  Where the image compresses below the budget every pass is kept and
the file decodes exactly, unless the smallest slope is positive: the
bisection then stops short of it and drops the passes of that slope, as
OpenJPEG does.

Tier 2 writes the packet headers as opj_t2_encode_packet does: a 1 (the
packet is never marked empty, even where no block sends a pass), tag trees
for inclusion and zero bit-planes, the pass-count code, the Lblock
increment and the segment lengths, with the bit stuffing after 0xFF; no SOP
or EPH.

OpenCV writes no readable file of an image with a side under 32 pixels (the
five levels need 32) and refuses 2 channels; both raise here.
"""
from __future__ import annotations

import math
import struct
import sys

import numpy as np

from iron_tpu_torch.data.jp2 import JP2_SIGNATURE, _TagTree, _pair, _resolutions
from iron_tpu_torch.data.jp2_t1 import _AGG, _NLPS, _NMPS, _QE, _SC, _UNI, _ZC, _scan

LEVELS = 5
RATIO = 4.0                         # OpenCV's tcp_rates[0]
COMMENT = b"Created by OpenJPEG version 2.5.3"
_DBL_EPSILON = 2.220446049250313e-16
_FRACBITS = 6                       # T1_NMSEDEC_FRACBITS

# opj_dwt_norms: the 5/3 sub-band norms by orientation and level
_NORMS = ((1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3),
          (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9),
          (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9),
          (.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93))


def _nmsedec_lut(f) -> list:
    """t1_generate_luts.c: the distortion decrease of a sample whose next
    seven bits are i, at 6 fractional bits, times 8192."""
    out = []
    for i in range(128):
        t = i / 64.0
        out.append(max(0, int(math.floor(f(t, i) * 64.0 + 0.5) / 64.0 * 8192.0)))
    return out


_SIG = _nmsedec_lut(lambda t, i: t * t - (t - 1.5) ** 2)
_SIG0 = _nmsedec_lut(lambda t, i: t * t)
_REF = _nmsedec_lut(lambda t, i: (t - 1.0) ** 2 - (t - (1.5 if i & 64 else 0.5)) ** 2)
_REF0 = _nmsedec_lut(lambda t, i: (t - 1.0) ** 2)


# ---------------------------------------------------------------------------
# the forward 5/3 wavelet
# ---------------------------------------------------------------------------

def _fdwt53(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The forward 5/3 along the last axis in integer lifting, the exact
    inverse of jp2._idwt53: the low-pass band in [..., :sn], the high-pass
    one after it; cas is the parity of the first sample's coordinate."""
    n = a.shape[-1]
    if n == 1:
        return a * 2 if cas else a.copy()
    s, d = a[..., cas::2], a[..., 1 - cas::2]
    left, right = _pair(s, -cas, n - sn)
    d = d - ((left + right) >> 1)
    left, right = _pair(d, cas - 1, sn)
    s = s + ((left + right + 2) >> 2)
    return np.concatenate([s, d], axis=-1)


def _forward_dwt(a: np.ndarray, res) -> np.ndarray:
    """Every level of a tile-component, largest first; each level's bands
    land where jp2._tile_component reads them."""
    buf = a.astype(np.int64)
    for r in range(len(res) - 1, 0, -1):
        rs, prev = res[r], res[r - 1]
        rw, rh = rs["x1"] - rs["x0"], rs["y1"] - rs["y0"]
        buf[:rh, :rw] = _fdwt53(buf[:rh, :rw].T, prev["y1"] - prev["y0"], rs["y0"] & 1).T
        buf[:rh, :rw] = _fdwt53(buf[:rh, :rw], prev["x1"] - prev["x0"], rs["x0"] & 1)
    return buf


# ---------------------------------------------------------------------------
# tier 1
# ---------------------------------------------------------------------------

def _encode_block(coefs: np.ndarray, orient: int, weight: float):
    """Code one code-block (int [h, w]) as OpenJPEG's opj_t1_encode_cblk
    does.  Returns (numbps, its codeword segment, [(rate, cumulative
    distortion decrease)] a pass)."""
    h, w = coefs.shape
    stride = w + 2
    size = (h + 2) * stride
    flat = np.zeros((h + 2, stride), np.int64)
    flat[1:-1, 1:-1] = coefs
    flat = flat.ravel()
    mag = np.abs(flat).tolist()
    neg = (flat < 0).tolist()
    numbps = int(max(mag)).bit_length()
    if numbps == 0:
        return 0, b"", []
    cols, order = _scan(w, h)
    zc = _ZC[orient]
    sc_lut = _SC
    qe_t, nmps_t, nlps_t = _QE, _NMPS, _NLPS

    sig = [0] * size
    nb = [0] * size
    sc = [12] * size
    mu = [0] * size
    vis = [0] * size

    out = bytearray(1)                  # out[0]: the byte before the segment
    cx = [0] * 19
    cx[0], cx[_AGG], cx[_UNI] = 2 * 4, 2 * 3, 2 * 46
    a, c, ct, bp = 0x8000, 0, 12, 0

    def byteout():
        nonlocal c, ct, bp
        if out[bp] == 0xFF:
            bp += 1
            out.append((c >> 20) & 0xFF)
            c &= 0xFFFFF
            ct = 7
        elif not c & 0x8000000:
            bp += 1
            out.append((c >> 19) & 0xFF)
            c &= 0x7FFFF
            ct = 8
        else:
            out[bp] += 1
            if out[bp] == 0xFF:
                c &= 0x7FFFFFF
                bp += 1
                out.append((c >> 20) & 0xFF)
                c &= 0xFFFFF
                ct = 7
            else:
                bp += 1
                out.append((c >> 19) & 0xFF)
                c &= 0x7FFFF
                ct = 8

    def enc(k, d):
        """ENCODE (C.2.2) of decision d in context k."""
        nonlocal a, c, ct
        s = cx[k]
        q = qe_t[s]
        a -= q
        if (s & 1) == d:                    # CODEMPS
            if a & 0x8000:
                c += q
                return
            if a < q:
                a = q
            else:
                c += q
            cx[k] = nmps_t[s]
        else:                               # CODELPS
            if a < q:
                c += q
            else:
                a = q
            cx[k] = nlps_t[s]
        while True:                         # RENORME
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                byteout()
            if a & 0x8000:
                return

    def significant(i, ng):
        sig[i] = 1
        nb[i - stride - 1] += 1
        nb[i - stride + 1] += 1
        nb[i + stride - 1] += 1
        nb[i + stride + 1] += 1
        nb[i - 1] += 15
        nb[i + 1] += 15
        nb[i - stride] += 5
        nb[i + stride] += 5
        if ng:
            sc[i - 1] -= 5
            sc[i + 1] -= 5
            sc[i - stride] -= 1
            sc[i + stride] -= 1
        else:
            sc[i - 1] += 5
            sc[i + 1] += 5
            sc[i - stride] += 1
            sc[i + stride] += 1

    passes = []
    cum = 0.0
    bpno = numbps - 1
    ptype = 2
    while bpno >= 0:
        nmsedec = 0
        if bpno:
            sig_t, ref_t, sh = _SIG, _REF, bpno - _FRACBITS
        else:
            sig_t, ref_t, sh = _SIG0, _REF0, -_FRACBITS
        if ptype == 0:                      # significance propagation
            for i in order:
                if sig[i] or not nb[i]:
                    continue
                vis[i] = 1
                m = mag[i]
                v = (m >> bpno) & 1
                enc(zc[nb[i]], v)
                if v:
                    k, x = sc_lut[sc[i]]
                    enc(k, neg[i] ^ x)
                    nmsedec += sig_t[(m >> sh if sh >= 0 else m << -sh) & 127]
                    significant(i, neg[i])
        elif ptype == 1:                    # magnitude refinement
            for i in order:
                if sig[i] and not vis[i]:
                    m = mag[i]
                    nmsedec += ref_t[(m >> sh if sh >= 0 else m << -sh) & 127]
                    enc(16 if mu[i] else (15 if nb[i] else 14), (m >> bpno) & 1)
                    mu[i] = 1
        else:                               # cleanup, with run-length coding
            for col in cols:
                if len(col) == 4:
                    i0, i1, i2, i3 = col
                    if not (sig[i0] or sig[i1] or sig[i2] or sig[i3] or vis[i0] or vis[i1]
                            or vis[i2] or vis[i3] or nb[i0] or nb[i1] or nb[i2] or nb[i3]):
                        r = 0
                        while r < 4 and not (mag[col[r]] >> bpno) & 1:
                            r += 1
                        enc(_AGG, r != 4)
                        if r == 4:
                            continue
                        enc(_UNI, r >> 1)
                        enc(_UNI, r & 1)
                        i = col[r]
                        m = mag[i]
                        k, x = sc_lut[sc[i]]
                        nmsedec += sig_t[(m >> sh if sh >= 0 else m << -sh) & 127]
                        enc(k, neg[i] ^ x)
                        significant(i, neg[i])
                        col = col[r + 1:]
                for i in col:
                    if sig[i] or vis[i]:
                        continue
                    m = mag[i]
                    v = (m >> bpno) & 1
                    enc(zc[nb[i]], v)
                    if v:
                        k, x = sc_lut[sc[i]]
                        nmsedec += sig_t[(m >> sh if sh >= 0 else m << -sh) & 127]
                        enc(k, neg[i] ^ x)
                        significant(i, neg[i])
            vis = [0] * size                # the cleanup pass clears the visited marks
        # opj_t1_getwmsedec, stepsize 1
        t = weight * (1 << bpno)
        cum += t * (t * nmsedec / 8192.0)
        if bpno == 0 and ptype == 2:        # the last pass: FLUSH (C.2.9)
            tempc = c + a
            c |= 0xFFFF
            if c >= tempc:
                c -= 0x8000
            c = (c << ct) & 0xFFFFFFFF
            byteout()
            c = (c << ct) & 0xFFFFFFFF
            byteout()
            if out[bp] != 0xFF:
                bp += 1
            passes.append([bp - 1, cum])
        else:
            passes.append([bp - 1 + 3, cum])
        ptype += 1
        if ptype == 3:
            ptype = 0
            bpno -= 1
    data = bytes(out[1:bp])
    last = bp - 1                           # make the rates non-decreasing
    for p in reversed(passes):
        if p[0] > last:
            p[0] = last
        else:
            last = p[0]
    for p in passes:                        # no pass ends on 0xFF
        if data[p[0] - 1] == 0xFF:
            p[0] -= 1
    return numbps, data, [tuple(p) for p in passes]


# ---------------------------------------------------------------------------
# rate allocation
# ---------------------------------------------------------------------------

def _passes_at(blk, thresh: float) -> int:
    """opj_tcd_makelayer: how many passes of a block a slope threshold
    keeps, each pass's slope taken from the last pass kept."""
    passes = blk["passes"]
    n = 0
    for p, (rate, dist) in enumerate(passes):
        if n == 0:
            dr, dd = rate, dist
        else:
            dr, dd = rate - passes[n - 1][0], dist - passes[n - 1][1]
        if not dr:
            if dd != 0:
                n = p + 1
            continue
        if thresh - dd / dr < _DBL_EPSILON:
            n = p + 1
    return n


def _allocate(packets, maxlen: int) -> None:
    """opj_tcd_rateallocate for one layer: set each block's "n", the passes
    it sends."""
    blocks = [blk for bands in packets for band in bands for blk in band["blocks"]]
    lo, hi = sys.float_info.max, 0.0
    for blk in blocks:
        prev_rate, prev_dist = 0, 0.0
        for rate, dist in blk["passes"]:
            dr = rate - prev_rate
            dd = dist - prev_dist
            prev_rate, prev_dist = rate, dist
            if dr == 0:
                continue
            slope = dd / dr
            lo = min(lo, slope)
            hi = max(hi, slope)

    def fits(thresh: float) -> bool:
        for blk in blocks:
            blk["n"] = _passes_at(blk, thresh)
        total = 0
        for bands in packets:
            total += len(_packet_header(bands))
            total += sum(blk["passes"][blk["n"] - 1][0] for band in bands
                         for blk in band["blocks"] if blk["n"])
            if total > maxlen:
                return False
        return True

    thresh, stable = 0.0, 0.0
    for _ in range(128):
        new = (lo + hi) / 2
        if abs(new - thresh) <= 0.5 * 1e-5 * thresh:
            break                           # the threshold has stabilised
        thresh = new
        if fits(thresh):
            hi = stable = thresh
        else:
            lo = thresh
    good = thresh if stable == 0 else stable
    for blk in blocks:
        blk["n"] = _passes_at(blk, good)


# ---------------------------------------------------------------------------
# tier 2
# ---------------------------------------------------------------------------

class _BitWriter:
    """opj_bio: bits MSB first, a 0 bit stuffed after each 0xFF byte."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def put(self, v: int, n: int = 1) -> None:
        for k in range(n - 1, -1, -1):
            if self.ct == 0:
                self._byteout()
            self.ct -= 1
            self.buf |= ((v >> k) & 1) << self.ct

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTreeWriter(_TagTree):
    """opj_tgt's encoder over the nodes of the decoder's tag tree (all
    values 999, all lows 0 at the start)."""

    def __init__(self, w: int, h: int):
        super().__init__(w, h)
        self.known = [0] * len(self.parent)

    def set(self, leaf: int, value: int) -> None:
        node = leaf
        while node >= 0 and self.value[node] > value:
            self.value[node] = value
            node = self.parent[node]

    def encode(self, bits: _BitWriter, leaf: int, threshold: int) -> None:
        path = [leaf]
        while self.parent[path[-1]] >= 0:
            path.append(self.parent[path[-1]])
        low = 0
        for node in reversed(path):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bits.put(1)
                        self.known[node] = 1
                    break
                bits.put(0)
                low += 1
            self.low[node] = low


def _put_passes(bits: _BitWriter, n: int) -> None:
    """opj_t2_putnumpasses (Table B.4)."""
    if n == 1:
        bits.put(0)
    elif n == 2:
        bits.put(2, 2)
    elif n <= 5:
        bits.put(0xC | (n - 3), 4)
    elif n <= 36:
        bits.put(0x1E0 | (n - 6), 9)
    else:
        bits.put(0xFF80 | (n - 37), 16)


def _packet_header(bands) -> bytes:
    """The header of the one layer's packet of a precinct, as
    opj_t2_encode_packet writes it for the blocks' chosen pass counts."""
    bits = _BitWriter()
    bits.put(1)                         # never the empty-packet bit, even with no block sent
    for band in bands:
        blocks = band["blocks"]
        cw, ch = band["cw"], band["ch"]
        incl, imsb = _TagTreeWriter(cw, ch), _TagTreeWriter(cw, ch)
        for k, blk in enumerate(blocks):
            imsb.set(k, band["numbps"] - blk["numbps"])
            if blk["n"]:
                incl.set(k, 0)
        for k, blk in enumerate(blocks):
            incl.encode(bits, k, 1)
            n = blk["n"]
            if not n:
                continue
            imsb.encode(bits, k, 999)
            _put_passes(bits, n)
            length = blk["passes"][n - 1][0]
            lenbits = 3
            increment = max(0, max(length, 1).bit_length() - (lenbits + n.bit_length() - 1))
            bits.put((1 << (increment + 1)) - 2, increment + 1)     # comma code
            bits.put(length, lenbits + increment + n.bit_length() - 1)
    return bits.flush()


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------

def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _jp2_header(h: int, w: int, nc: int) -> bytes:
    """The signature, ftyp and jp2h boxes OpenJPEG writes for OpenCV."""
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
    colr = _box(b"colr", struct.pack(">BBBI", 1, 0, 0, 17 if nc == 1 else 16))
    cdef = b""
    if nc == 4:                         # the fourth component is opacity
        cdef = _box(b"cdef", struct.pack(">H", 4) + b"".join(
            struct.pack(">HHH", c, 0, c + 1) for c in range(3)) + struct.pack(">HHH", 3, 1, 0))
    return (JP2_SIGNATURE + _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
            + _box(b"jp2h", ihdr + colr + cdef))


def _main_header(h: int, w: int, nc: int) -> bytes:
    siz = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, w, h, 0, 0, nc) + b"\x07\x01\x01" * nc
    cod = struct.pack(">BBHBBBBBB", 0, 0, 1, 0, LEVELS, 4, 4, 0, 1)
    qcd = bytes([0x40, 8 << 3] + [9 << 3, 9 << 3, 10 << 3] * LEVELS)
    com = struct.pack(">H", 1) + COMMENT

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">HH", marker, len(body) + 2) + body

    return (b"\xff\x4f" + seg(0xFF51, siz) + seg(0xFF52, cod) + seg(0xFF5C, qcd)
            + seg(0xFF64, com))


def _budget(h: int, w: int, nc: int, before_tile: int) -> int:
    """opj_j2k_update_rates in float32, then ceil: the most bytes the tile's
    packets may take (its floor of 30 bytes never binds from 32 x 32 up)."""
    f32 = np.float32
    rate = f32((8.0 * nc * w * h) / float(f32(RATIO) * f32(8)))
    return int(math.ceil(float(f32(rate - f32(before_tile)))))


def encode_jp2(img: np.ndarray) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA), channels
    in the file's order -> the .jp2 file cv2.imwrite writes of it (module
    docstring)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"the JPEG 2000 writer takes uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        comps = [img]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        comps = [img[..., k] for k in range(img.shape[2])]
    else:
        raise ValueError(f"the JPEG 2000 writer takes 1, 3 or 4 channels, not an array of "
                         f"shape {img.shape} (OpenCV refuses it too)")
    h, w = img.shape[:2]
    if min(h, w) < 1 << LEVELS:
        raise ValueError(f"a {w} x {h} image is too small for JPEG 2000's {LEVELS} wavelet "
                         f"levels (32 pixels a side); OpenCV writes no readable file of it")
    nc = len(comps)
    cp = {"levels": LEVELS, "cbw": 6, "cbh": 6, "precincts": [(15, 15)] * (LEVELS + 1),
          "guard": 2, "steps": [(8, 0)] + [(9, 0), (9, 0), (10, 0)] * LEVELS}
    by_res = [[] for _ in range(LEVELS + 1)]       # per resolution, per component: bands
    for comp in comps:
        res = _resolutions((0, 0, w, h), cp, 8)
        buf = _forward_dwt(comp.astype(np.int64) - 128, res)
        for r, rs in enumerate(res):
            prev = res[r - 1] if r else None
            level = LEVELS - r
            bands = []
            for band in rs["precincts"][0]:
                b = band["bandno"]
                ox = prev["x1"] - prev["x0"] if b & 1 else 0
                oy = prev["y1"] - prev["y0"] if b & 2 else 0
                blocks = []
                for blk in band["blocks"]:
                    y, x = blk.y0 - band["y0"] + oy, blk.x0 - band["x0"] + ox
                    numbps, data, passes = _encode_block(
                        buf[y:y + blk.y1 - blk.y0, x:x + blk.x1 - blk.x0], b,
                        _NORMS[b][min(level, 9 if b == 0 else 8)])
                    blocks.append({"numbps": numbps, "data": data, "passes": passes, "n": 0})
                bands.append({"numbps": band["numbps"], "blocks": blocks, "cw": band["cw"],
                              "ch": band["ch"]})
            by_res[r].append(bands)
    packets = [bands for r in range(LEVELS + 1) for bands in by_res[r]]   # LRCP
    head = _jp2_header(h, w, nc)
    main = _main_header(h, w, nc)
    _allocate(packets, _budget(h, w, nc, len(head) + 8 + len(main)))
    body = bytearray()
    for bands in packets:
        body += _packet_header(bands)
        for band in bands:
            for blk in band["blocks"]:
                if blk["n"]:
                    body += blk["data"][:blk["passes"][blk["n"] - 1][0]]
    sot = struct.pack(">HHHIBB", 0xFF90, 10, 0, 14 + len(body), 0, 1)
    cs = main + sot + b"\xff\x93" + bytes(body) + b"\xff\xd9"
    return head + _box(b"jp2c", cs)
