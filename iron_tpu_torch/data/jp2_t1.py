"""JPEG 2000 tier 1 on Python integers: the MQ decoder and the three coding
passes of one code-block (ISO/IEC 15444-1 Annexes C and D), giving the
coefficients as OpenJPEG's code-block decoder leaves them.

    decode_block(segments, w, h, numbps, orient, style=0, roishift=0)
        -> int64 [h, w]

The values carry one extra bit, as OpenJPEG's do: a coefficient that turns
significant at bit-plane p is set to 3 * 2^p (the "one plus half" midpoint of
its interval, doubled), and each refinement at plane q moves it by 2^q
toward the half of the interval its bit names.  The caller halves them
(reversible, truncating toward zero) or multiplies them by half the step
size (irreversible).

The passes come in codeword segments, (bytes, pass count) each, as tier 2
splits them (jp2.py): one segment under the default style, one a pass under
TERMALL, and under BYPASS ten passes, then (raw significance + refinement)
and (MQ cleanup) in turn.  Each code-block style decodes as OpenJPEG 2.5's
opj_t1_decode_cblk decodes it: BYPASS reads a segment's significance and
refinement passes as raw bits (opj_mqc_raw_decode: a byte after 0xFF gives
7 bits, 0xFF followed by a byte above 0x8F gives 1-bits without moving on)
where the segment starts at bpno + 1 <= numbps - 4 (with ROI's shift in
bpno and not in numbps); RESET resets the contexts after every MQ pass;
VSC keeps a stripe's first row from marking the row above (so its last row
sees no neighbour below); SEGSYM decodes four symbols in the uniform
context after each cleanup pass and ignores them; PTERM changes nothing in
the decoder.  An MQ segment follows C.3: BYTEIN with the bit stuffing after
0xFF, and past the segment's end the 0xFF 0xFF that OpenJPEG appends, which
feeds 1-bits.  With an RGN shift s the block's first pass is at plane
s + numbps - 1, and magnitudes of at least 2^s are shifted down by s after
the passes (opj_t1_clbl_decode_processor).

The neighbourhood state is kept per sample in flat lists with a one-sample
border (stride w + 2): `nb` holds 15 h + 5 v + d, the counts of significant
horizontal, vertical and diagonal neighbours, which indexes the
orientation's zero-coding table; `sc` holds 5 (hsum + 2) + (vsum + 2), the
sums of the horizontal and vertical neighbours' signs (+1 / -1), which
indexes the sign-coding table.  Both are updated when a sample turns
significant, so a context is one list lookup.
"""
from __future__ import annotations

import functools

import numpy as np

# (Qe, NMPS, NLPS, SWITCH) of the 47 states, Table C.2
_MQ = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
# a context's state is 2 * (table index) + MPS
_QE = [q for q, _, _, _ in _MQ for _ in (0, 1)]
_NMPS = [2 * n + m for _, n, _, _ in _MQ for m in (0, 1)]
_NLPS = [2 * n + (m ^ s) for _, _, n, s in _MQ for m in (0, 1)]

# contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run length, 18 uniform
_AGG, _UNI = 17, 18


def _zc_table(orient: int) -> list:
    """Table D.1: the zero-coding context of 15 h + 5 v + d for a subband
    (0 LL, 1 HL, 2 LH, 3 HH; HL swaps H and V)."""
    out = []
    for code in range(45):
        h, v, d = code // 15, code // 5 % 3, code % 5
        if orient == 1:
            h, v = v, h
        if orient == 3:
            hv = h + v
            if d >= 3:
                k = 8
            elif d == 2:
                k = 7 if hv else 6
            elif d == 1:
                k = 5 if hv >= 2 else 3 + hv
            else:
                k = min(hv, 2)
        elif h == 2:
            k = 8
        elif h == 1:
            k = 7 if v else (6 if d else 5)
        elif v:
            k = 2 + v
        else:
            k = min(d, 2)
        out.append(k)
    return out


_ZC = [_zc_table(o) for o in range(4)]
# Table D.3: (H, V) contributions -> (context, XOR bit)
_SC_D3 = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0), (0, 1): (10, 0), (0, 0): (9, 0),
          (0, -1): (10, 1), (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}
_SC = [_SC_D3[max(-1, min(1, code // 5 - 2)), max(-1, min(1, code % 5 - 2))]
       for code in range(25)]


@functools.lru_cache(maxsize=64)
def _scan(w: int, h: int):
    """The stripe columns of a w x h block in scan order (flat indices with
    the one-sample border), and the samples in that order."""
    stride = w + 2
    cols = []
    for y0 in range(0, h, 4):
        rows = range(y0 + 1, min(y0 + 4, h) + 1)
        cols.extend(tuple(y * stride + x for y in rows) for x in range(1, w + 1))
    return tuple(cols), tuple(i for col in cols for i in col)


def decode_block(segments, w: int, h: int, numbps: int, orient: int, style: int = 0,
                 roishift: int = 0) -> np.ndarray:
    """Decode the codeword segments [(bytes, passes)] of a w x h code-block
    whose first pass is the cleanup pass at bit-plane roishift + numbps - 1,
    under code-block style `style` (module docstring).  Returns OpenJPEG's
    doubled coefficients (module docstring), int64."""
    stride = w + 2
    size = (h + 2) * stride
    cols, order = _scan(w, h)
    zc = _ZC[orient]
    sc_lut = _SC
    qe_t, nmps_t, nlps_t = _QE, _NMPS, _NLPS

    sig = [0] * size
    nb = [0] * size
    sc = [12] * size            # hsum = vsum = 0
    val = [0] * size
    mu = [0] * size
    # VSC: a sample in a stripe's first row does not mark the row above
    north = _vsc_rows(w, h) if style & 0x08 else None

    cx = [0] * 19
    a = c = ct = bp = 0
    buf = b""

    def reset():
        cx[:] = [0] * 19
        cx[0], cx[_AGG], cx[_UNI] = 2 * 4, 2 * 3, 2 * 46

    def dec(k):
        """DECODE (C.3.2) in context k."""
        nonlocal a, c, ct, bp
        s = cx[k]
        q = qe_t[s]
        a -= q
        if (c >> 16) < q:
            if a < q:
                d = s & 1
                cx[k] = nmps_t[s]
            else:
                d = 1 - (s & 1)
                cx[k] = nlps_t[s]
            a = q
        else:
            c -= q << 16
            if a & 0x8000:
                return s & 1
            if a < q:
                d = 1 - (s & 1)
                cx[k] = nlps_t[s]
            else:
                d = s & 1
                cx[k] = nmps_t[s]
        while True:                         # RENORMD
            if ct == 0:                     # BYTEIN
                if buf[bp] == 0xFF:
                    if buf[bp + 1] > 0x8F:
                        c += 0xFF00
                        ct = 8
                    else:
                        bp += 1
                        c += buf[bp] << 9
                        ct = 7
                else:
                    bp += 1
                    c += buf[bp] << 8
                    ct = 8
            a <<= 1
            c = (c << 1) & 0xFFFFFFFF
            ct -= 1
            if a & 0x8000:
                return d

    def raw():
        """opj_mqc_raw_decode: one raw bit."""
        nonlocal c, ct, bp
        if ct == 0:
            if c == 0xFF:
                if buf[bp] > 0x8F:
                    ct = 8
                else:
                    c = buf[bp]
                    bp += 1
                    ct = 7
            else:
                c = buf[bp]
                bp += 1
                ct = 8
        ct -= 1
        return (c >> ct) & 1

    def significant(i, neg, v):
        val[i] = -v if neg else v
        sig[i] = 1
        nb[i + stride - 1] += 1
        nb[i + stride + 1] += 1
        nb[i - 1] += 15
        nb[i + 1] += 15
        nb[i + stride] += 5
        if neg:
            sc[i - 1] -= 5
            sc[i + 1] -= 5
            sc[i + stride] -= 1
        else:
            sc[i - 1] += 5
            sc[i + 1] += 5
            sc[i + stride] += 1
        if north is None or north[i]:
            nb[i - stride - 1] += 1
            nb[i - stride + 1] += 1
            nb[i - stride] += 5
            sc[i - stride] += -1 if neg else 1

    reset()
    bpno1 = roishift + numbps               # OpenJPEG's bpno_plus_one
    ptype = 2                               # the first pass is a cleanup pass
    vis = [0] * size                        # coded in this plane's significance pass
    for data, passes in segments:
        is_raw = style & 0x01 and ptype < 2 and bpno1 <= numbps - 4
        buf = bytes(data) + b"\xff\xff"
        bp = 0
        if is_raw:                          # opj_mqc_raw_init_dec
            c = ct = 0
        else:                               # INITDEC (C.3.5)
            c = (buf[0] << 16) if data else 0xFF << 16
            if buf[0] == 0xFF:
                if buf[1] > 0x8F:
                    c += 0xFF00
                    ct = 8
                else:
                    bp = 1
                    c += buf[1] << 9
                    ct = 7
            else:
                bp = 1
                c += buf[1] << 8
                ct = 8
            c = (c << 7) & 0xFFFFFFFF
            ct -= 7
            a = 0x8000
        for _ in range(passes):
            if bpno1 < 1:
                break
            half = 1 << (bpno1 - 1)
            oph = 3 * half
            if ptype == 0:                  # significance propagation
                vis = [0] * size
                for i in order:
                    if sig[i] or not nb[i]:
                        continue
                    vis[i] = 1
                    if is_raw:
                        if raw():
                            significant(i, raw(), oph)
                    elif dec(zc[nb[i]]):
                        k, x = sc_lut[sc[i]]
                        significant(i, dec(k) ^ x, oph)
            elif ptype == 1:                # magnitude refinement
                for i in order:
                    if sig[i] and not vis[i]:
                        v = raw() if is_raw else dec(16 if mu[i] else (15 if nb[i] else 14))
                        x = val[i]
                        val[i] = x + half if v ^ (x < 0) else x - half
                        mu[i] = 1
            else:                           # cleanup, with run-length coding
                for col in cols:
                    if len(col) == 4:
                        i0, i1, i2, i3 = col
                        if not (sig[i0] or sig[i1] or sig[i2] or sig[i3] or vis[i0] or vis[i1]
                                or vis[i2] or vis[i3] or nb[i0] or nb[i1] or nb[i2] or nb[i3]):
                            if not dec(_AGG):
                                continue
                            r = dec(_UNI) << 1
                            r |= dec(_UNI)
                            i = col[r]
                            k, x = sc_lut[sc[i]]
                            significant(i, dec(k) ^ x, oph)
                            col = col[r + 1:]
                    for i in col:
                        if sig[i] or vis[i]:
                            continue
                        if dec(zc[nb[i]]):
                            k, x = sc_lut[sc[i]]
                            significant(i, dec(k) ^ x, oph)
                if style & 0x20:            # SEGSYM: four symbols, not checked
                    for _ in range(4):
                        dec(_UNI)
            if style & 0x02 and not is_raw:
                reset()
            ptype += 1
            if ptype == 3:
                ptype = 0
                bpno1 -= 1
    out = np.asarray(val, np.int64).reshape(h + 2, stride)[1:-1, 1:-1]
    if roishift:
        if roishift >= 31:
            return np.zeros_like(out)
        mag = np.abs(out)
        out = np.where(mag >= 1 << roishift, np.sign(out) * (mag >> roishift), out)
    return out


@functools.lru_cache(maxsize=64)
def _vsc_rows(w: int, h: int):
    """1 at the flat index of each sample not in a stripe's first row (under
    VSC only those mark the row above)."""
    stride = w + 2
    return tuple(int(i // stride - 1 > 0 and (i // stride - 1) % 4 != 0)
                 for i in range((h + 2) * stride))
