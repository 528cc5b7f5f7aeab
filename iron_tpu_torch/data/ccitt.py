"""CCITT bilevel coding (ITU-T T.4 and T.6) on Python strings of bits: the
decoder of TIFF compressions 2, 3 and 4 as libtiff's fax3 codec
(tif_fax3.c) reads them, which is how OpenCV reads such a TIFF.

    decode_ccitt(data, width, rows, compression, t4_options=0, state=None)
        -> (uint8 [rows, ceil(width / 8)], whether libtiff reports an error)

The result is the strip's rows packed 8 pixels a byte, most significant bit
first, as libtiff hands them on: a white run gives 0 bits and a black run 1
bits, whatever the photometric interpretation says (it is applied later, as
for an uncompressed bilevel strip).

- 2, modified Huffman: each row one-dimensional (white and black runs, each
  its make-up codes and a terminating code), no EOL, the next row starting
  on a byte boundary.  (The word-aligned variant, 32771, is not read:
  libtiff misreads the rows after the first few of its own such files, and
  OpenCV returns that.)
- 3, T.4 (Group 3): each row after an EOL (11 or more 0 bits, then a 1;
  T4Options bit 2 pads the zeros so the EOL ends a byte, which the search
  absorbs), with T4Options bit 0 a tag bit after it: 1 for a
  one-dimensional row, 0 for a two-dimensional one.
- 4, T.6 (Group 4): every row two-dimensional, no EOL.

A two-dimensional row codes its changing elements against the row above
(all white above the first row of a strip) in pass, horizontal and
vertical modes; `_row_2d` keeps libtiff's bookkeeping of b1 on the reference
line (it is advanced in pairs only once the row has a run, and moved back
one element by a left vertical mode).  The bytes come most significant bit
first (tiff.py reverses a FillOrder 2 strip's before).

Uncompressed mode is not decoded, as libtiff does not decode it: the
T4Options bit that allows it changes nothing, and an extension code ends
its row as libtiff ends it (Fax3Extension, then CLEANUP_RUNS, which every
row goes through).  The decoder follows libtiff's fax3 macros on its bit
reader (`_Bits`: bytes loaded as codes need them, zero bits once the data
is loaded, the end of data only where no bit at all is left) and its run
arrays (`_Row`): a bad code or an EOL ends its row (an EOL's 11 zeros
taken), a T.4 strip goes on at its next EOL and a modified Huffman one at
its next byte, a T.6 strip after the code; a vertical mode that moves back
past a0 ends the row (libtiff's check on VL); the reference row's b1 walks
the array as libtiff walks it, past the row's changes into what earlier
rows left there; a run array that would overflow stops the strip.  The
data's end keeps the rows decoded (the row it ends in after CLEANUP_RUNS),
an EOL ends a T.6 strip, and a T.4 strip whose EOL search finds the zeros
but no 1 is decoded again from its start without EOLs into the rows left
(RETRY_WITHOUT_EOL); rows not reached are 0 bits, as libtiff's zeroed
buffer leaves them.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

# T.4 Tables 2 and 3: the terminating codes of runs 0-63
_WHITE_TERM = (
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100", "110101",
    "101010", "101011", "0100111", "0001100", "0001000", "0010111", "0000011", "0000100",
    "0101000", "0101011", "0010011", "0100100", "0011000", "00000010", "00000011", "00011010",
    "00011011", "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101", "00000100",
    "00000101", "00001010", "00001011", "01010010", "01010011", "01010100", "01010101",
    "00100100", "00100101", "01011000", "01011001", "01011010", "01011011", "01001010",
    "01001011", "00110010", "00110011", "00110100")
_BLACK_TERM = (
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100", "00000111", "000011000",
    "0000010111", "0000011000", "0000001000", "00001100111", "00001101000", "00001101100",
    "00000110111", "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000", "000001101001",
    "000001101010", "000001101011", "000011010010", "000011010011", "000011010100",
    "000011010101", "000011010110", "000011010111", "000001101100", "000001101101",
    "000011011010", "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010", "000001010011",
    "000000100100", "000000110111", "000000111000", "000000100111", "000000101000",
    "000001011000", "000001011001", "000000101011", "000000101100", "000001011010",
    "000001100110", "000001100111")
# the make-up codes of runs 64, 128, ..., 1728
_WHITE_MAKEUP = (
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000", "010011011")
_BLACK_MAKEUP = (
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101")
# the extended make-up codes of runs 1792, 1856, ..., 2560, shared by both colours
_EXTENDED_MAKEUP = (
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111")
# T.4 Table 4: the two-dimensional modes (vertical modes by a1 - b1)
_MODES: Dict[str, object] = {
    "0001": "pass", "001": "horizontal", "1": 0, "011": 1, "000011": 2, "0000011": 3,
    "010": -1, "000010": -2, "0000010": -3, "0000001": "extension"}


def _run_table(term, makeup) -> Dict[str, int]:
    table = {code: n for n, code in enumerate(term)}
    table.update({code: 64 * (k + 1) for k, code in enumerate(makeup)})
    table.update({code: 1792 + 64 * k for k, code in enumerate(_EXTENDED_MAKEUP)})
    return table


_RUNS = (_run_table(_WHITE_TERM, _WHITE_MAKEUP), _run_table(_BLACK_TERM, _BLACK_MAKEUP))
_LENGTHS = tuple(sorted({len(c) for c in t}) for t in _RUNS)
_MODE_LENGTHS = sorted({len(c) for c in _MODES})
_BITS = tuple(format(b, "08b") for b in range(256))
# byte -> its bits in reverse order (TIFF's FillOrder 2)
BIT_REVERSED = bytes(int(format(b, "08b")[::-1], 2) for b in range(256))


class _EndOfData(Exception):
    """libtiff's bit reader needs bits and has none left (its eof labels)."""


class _NoEOL(Exception):
    """SYNC_EOL found 11 zero bits and then no 1 before the data ends."""


class _Overflow(Exception):
    """libtiff's run-array bound check: the decode stops at once, the row
    unfilled (its "Buffer overflow")."""


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


class _Bits:
    """libtiff's fax3 bit reader over a strip: bytes loaded as codes need
    them (NeedBits8 / NeedBits16); once the data is loaded, a need is met
    with zero bits unless no bit at all is left, which is the end of data."""

    def __init__(self, data: bytes):
        self.s = "".join(_BITS[b] for b in data)
        self.end, self.pos, self.avail = len(self.s), 0, 0

    def need(self, n: int, wide: bool = False) -> None:
        if self.avail - self.pos >= n:
            return
        if self.avail >= self.end:
            if self.avail == self.pos:
                raise _EndOfData
            self.avail = self.pos + n                # padded with zeros
            return
        self.avail += 8
        if wide and self.avail - self.pos < n:
            self.avail = self.pos + n if self.avail >= self.end else self.avail + 8

    def peek(self, n: int) -> str:
        return self.s[self.pos:self.pos + n].ljust(n, "0")

    def lookup(self, table: Dict[str, object], lengths, width: int):
        """LOOKUP8 / LOOKUP16 of `width` bits: (the code's value, "EOL", or
        None for a pattern in no table; the bits it takes are taken)."""
        self.need(width, width > 8)
        bits = self.peek(width)
        for n in lengths:
            v = table.get(bits[:n])
            if v is not None:
                self.pos += n
                return v
        if width > 8 and bits[:11] == "0" * 11:
            self.pos += 11
            return "EOL"
        return None


class _Row:
    """A row being decoded into libtiff's run array (`runs[at:at + n]`):
    pa, a0 and RunLength, SETVALUE and CLEANUP_RUNS."""

    def __init__(self, runs: List[int], at: int, n: int, width: int):
        self.runs, self.at, self.n, self.w = runs, at, n, width
        self.pa = self.a0 = self.run = 0

    def set(self, x: int) -> None:
        if self.pa >= self.n:
            raise _Overflow
        self.runs[self.at + self.pa] = (self.run + x) & 0xFFFFFFFF
        self.pa += 1
        self.a0 = _i32(self.a0 + x)
        self.run = 0

    def cleanup(self) -> None:
        if self.run:
            self.set(0)
        if self.a0 != self.w:
            while self.a0 > self.w and self.pa > 0:
                self.pa -= 1
                self.a0 = _i32(self.a0 - self.runs[self.at + self.pa])
            if self.a0 < self.w:
                self.a0 = max(self.a0, 0)
                if self.pa & 1:
                    self.set(0)
                self.set(self.w - self.a0)
            elif self.a0 > self.w:
                self.set(self.w)
                self.set(0)

    def fill(self, out: np.ndarray) -> None:
        """_TIFFFax3fillruns: the runs white then black from x = 0, each cut
        at the row's end in the array itself."""
        end = self.pa
        if end & 1:
            self.runs[self.at + end] = 0
            end += 1
        x = 0
        for i in range(end):
            run = self.runs[self.at + i]
            if x + run > self.w or run > self.w:
                run = self.runs[self.at + i] = self.w - x
            if run:
                if i & 1:
                    out[x:x + run] = 1
                x += run


def _expand1d(rd: _Bits, row: _Row) -> bool:
    """EXPAND1D: white and black runs to the row's end; an EOL (then
    -> True) or a bad code ends the row early.  CLEANUP_RUNS after."""
    w, eol = row.w, False
    try:
        while True:
            for colour in (0, 1):
                while True:
                    v = rd.lookup(_RUNS[colour], _LENGTHS[colour], 12 + colour)
                    if v is None or v == "EOL":
                        eol = v == "EOL"
                        raise StopIteration
                    if v < 64:
                        row.set(v)
                        break
                    row.a0 = _i32(row.a0 + v)
                    row.run += v
                if row.a0 >= w:
                    raise StopIteration
            if row.runs[row.at + row.pa - 1] == 0 and row.runs[row.at + row.pa - 2] == 0:
                row.pa -= 2
    except StopIteration:
        pass
    except _EndOfData:
        row.cleanup()
        raise
    row.cleanup()
    return eol


def _expand2d(rd: _Bits, row: _Row, ref: int) -> bool:
    """EXPAND2D against the reference row at `runs[ref:]` (b1 walked over
    the array as libtiff walks it, past the reference row's changes into
    what earlier rows left there): -> whether an EOL ended the row.
    CLEANUP_RUNS after; a bad code or an extension code ends the row."""
    runs, n, w = row.runs, row.n, row.w

    def at(k: int) -> int:
        if not 0 <= ref + k < len(runs):
            raise ValueError("CCITT: a two-dimensional code reads outside libtiff's run arrays "
                             "(memory no file holds; not read by the port)")
        return runs[ref + k]

    pb, b1 = 1, _i32(at(0))
    eol = False

    def check_b1():
        nonlocal pb, b1
        if row.pa:
            while b1 <= row.a0 and b1 < w:
                if pb + 1 >= n:
                    raise _Overflow
                b1 = _i32(b1 + at(pb) + at(pb + 1))
                pb += 2

    try:
        while row.a0 < w:
            if row.pa >= n:
                raise _Overflow
            mode = rd.lookup(_MODES, _MODE_LENGTHS, 7)
            if mode == "pass":
                check_b1()
                if pb >= n:
                    raise _Overflow
                b1 = _i32(b1 + at(pb))
                row.run += b1 - row.a0
                row.a0 = b1
                b1 = _i32(b1 + at(pb + 1))
                pb += 2
            elif mode == "horizontal":
                for colour in ((1, 0) if row.pa & 1 else (0, 1)):
                    while True:
                        v = rd.lookup(_RUNS[colour], _LENGTHS[colour], 12 + colour)
                        if v is None or v == "EOL":
                            raise StopIteration
                        if v < 64:
                            row.set(v)
                            break
                        row.a0 = _i32(row.a0 + v)
                        row.run += v
                check_b1()
            elif mode == "extension" or mode is None and rd.peek(7) == "0000000":
                # S_Ext, S_EOL: the run at a0 takes the rest of the row
                if row.pa >= n:
                    raise _Overflow
                runs[row.at + row.pa] = (w - row.a0) & 0xFFFFFFFF
                row.pa += 1
                if mode != "extension":
                    rd.pos += 7
                    rd.need(4)
                    rd.pos += 4
                    eol = True
                raise StopIteration
            elif mode is None:
                raise StopIteration
            elif mode >= 0:
                check_b1()
                row.set(b1 - row.a0 + mode)
                if pb >= n:
                    raise _Overflow
                b1 = _i32(b1 + at(pb))
                pb += 1
            else:
                check_b1()
                if b1 < row.a0 - mode:
                    raise StopIteration
                row.set(b1 - row.a0 + mode)
                pb -= 1
                b1 = _i32(b1 - at(pb))
        if row.run:
            if row.run + row.a0 < w:
                rd.need(1)
                if rd.peek(1) == "0":
                    raise StopIteration
                rd.pos += 1
            row.set(0)
    except StopIteration:
        pass
    except _EndOfData:
        row.cleanup()
        raise
    row.cleanup()
    return eol


def _sync_eol(rd: _Bits, eol_read: bool) -> None:
    """SYNC_EOL: 11 zero bits (unless the row before read its EOL), any
    zero bytes after, then the 1."""
    if not eol_read:
        while True:
            rd.need(11, True)
            if rd.peek(11) == "0" * 11:
                break
            rd.pos += 1
    while True:
        try:
            rd.need(8)
        except _EndOfData:
            raise _NoEOL from None
        if rd.peek(8) != "0" * 8:
            break
        rd.pos += 8
    rd.pos += rd.peek(8).index("1") + 1


def decode_ccitt(data: bytes, width: int, rows: int, compression: int,
                 t4_options: int = 0, state: dict = None):
    """One strip or tile of a CCITT-coded TIFF, decoded as libtiff's fax3
    codec decodes it into its zeroed buffer -> (its rows, packed 8 pixels a
    byte, 1 bits black; whether libtiff reports an error).  The row the
    data ends in holds its runs so far after CLEANUP_RUNS (a T.4 row whose
    EOL is not found: white), an EOL ends a T.6 strip, a run array that
    would overflow stops the strip (that row unfilled), and the rows after
    are 0 bits.  A T.4 strip whose
    EOL search finds the zeros but no 1 before the data ends is decoded
    again from its start without EOLs, into the rows not yet filled, as
    libtiff retries (FAXMODE_NOEOL, kept for the TIFF's later strips).
    `state` holds what a TIFF's strips share in libtiff: its pair of run
    arrays (zeros at first), in which the two-dimensional decoder walks the
    reference row past its changes into what earlier rows left, and that
    mode."""
    if compression not in (2, 3, 4):
        raise ValueError(f"CCITT: compression {compression} is not a CCITT coding")
    two_d_opt = compression == 4 or (compression == 3 and t4_options & 1)
    n = -(-(width + 1) // 32) * 32 * (2 if two_d_opt else 1)
    state = {} if state is None else state
    if len(state.setdefault("runs", [])) != 2 * n:
        state["runs"] = [0] * (2 * n)
    runs = state["runs"]
    cur, ref = 0, n
    runs[n], runs[n + 1] = width, 0                  # Fax3PreDecode: a white reference row
    rd = _Bits(data)
    out = np.zeros((rows, width), np.uint8)
    eol_read, failed = False, False
    y = 0
    while y < rows:
        row = _Row(runs, cur, n, width)
        try:
            try:
                if compression == 3:
                    if not state.get("noeol"):
                        _sync_eol(rd, eol_read)
                    eol_read = False
                    if t4_options & 1:
                        rd.need(1)
                        two_d = rd.peek(1) == "0"
                        rd.pos += 1
                    else:
                        two_d = False
                else:
                    two_d = compression == 4
            except _EndOfData:                       # SYNC_EOL's eof: CLEANUP_RUNS of a0 = 0
                row.cleanup()
                raise
            eol_read = _expand2d(rd, row, ref) if two_d else _expand1d(rd, row)
        except _NoEOL:
            state["noeol"] = True                    # RETRY_WITHOUT_EOL: from the strip's start
            rd, eol_read = _Bits(data), False
            continue
        except _EndOfData:
            row.fill(out[y])
            failed = True
            break
        except _Overflow:
            failed = True
            break
        if compression == 4 and eol_read:            # Fax4Decode: an EOL ends the strip
            row.fill(out[y])
            break
        row.fill(out[y])
        if two_d_opt:
            if compression == 4 or row.pa < n:
                row.set(0)                           # the imaginary change
            cur, ref = ref, cur
        if compression == 2:
            rd.pos = -(-rd.pos // 8) * 8
        y += 1
    return np.packbits(out, axis=1), failed
