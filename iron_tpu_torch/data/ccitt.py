"""CCITT bilevel coding (ITU-T T.4 and T.6) on Python strings of bits: the
decoder of TIFF compressions 2, 3 and 4 as libtiff's fax3 codec
(tif_fax3.c) reads them, which is how OpenCV reads such a TIFF.

    decode_ccitt(data, width, rows, compression, t4_options=0)
        -> uint8 [rows, ceil(width / 8)]

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
row goes through).  In a two-dimensional row the run at a0 takes the rest
of the row; in a T.4 one-dimensional row, whose run tables have no such
code, the code is a bad one, and libtiff ends the row white after any
make-up length pending.  A T.4 strip then goes on at the next EOL, so a bad
run code in a T.4 row ends its row the same way; a T.6 strip goes on
decoding right after the 7-bit extension code, and there a vertical mode
that moves back past a0 ends its row too (libtiff's check on VL), an EOL
where a mode is due ends the strip.  Raised: a stream that ends before its
rows do, a bad run code in a modified Huffman or T.6 strip (`CCITTError`,
a ValueError), an EOL that ends a T.6 strip before its last row, and a
two-dimensional code that reads past the reference row's changes (libtiff
reads what earlier rows left in its run buffer there).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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


class CCITTError(ValueError):
    """A code that is in no table where a run code is due, at bit `at`;
    `pending` holds the make-up lengths read before it in the same run."""

    def __init__(self, msg: str, at: int, pending: int = 0):
        super().__init__(msg)
        self.at, self.pending = at, pending


def _code(bits: str, pos: int, table: Dict[str, object], lengths) -> Tuple[object, int]:
    for n in lengths:
        v = table.get(bits[pos:pos + n])
        if v is not None:
            return v, pos + n
    if pos >= len(bits):
        raise ValueError("CCITT: the strip's data ends before its rows do")
    raise CCITTError(f"CCITT: no code at bit {pos} ({bits[pos:pos + 13]}...)", pos)


def _run(bits: str, pos: int, colour: int) -> Tuple[int, int]:
    """One run of `colour` (0 white, 1 black): its make-up codes and the
    terminating code."""
    total = 0
    while True:
        try:
            n, pos = _code(bits, pos, _RUNS[colour], _LENGTHS[colour])
        except CCITTError as e:
            e.pending = total
            raise
        total += n
        if n < 64:
            return total, pos


def _cleanup(runs: List[int], a0: int, pending: int, width: int) -> List[int]:
    """libtiff's CLEANUP_RUNS on a row that stopped at a0 (`pending` the
    run length not yet set): the pending run set, then the row closed with
    a white run to its end (a black run of 0 first if a white one is due),
    or runs dropped from its end where a0 passed it."""
    if pending:
        runs.append(pending)
    if a0 != width:
        while a0 > width and runs:
            a0 -= runs.pop()
        if a0 < width:
            a0 = max(a0, 0)
            if len(runs) & 1:
                runs.append(0)
            runs.append(width - a0)
        elif a0 > width:
            runs += [width, 0]
    return runs


def _row_1d(bits: str, pos: int, width: int, t4: bool = False) -> Tuple[List[int], int]:
    """A one-dimensional row: its runs (white first) and the next bit.  In
    a T.4 strip (`t4`) a bad code ends the row as libtiff ends it, the next
    bit left at the code (the next EOL is searched for from there)."""
    runs: List[int] = []
    a0 = 0
    while True:
        for colour in (0, 1):
            try:
                n, pos = _run(bits, pos, colour)
            except CCITTError as e:
                if not t4:
                    raise
                return _cleanup(runs, a0 + e.pending, e.pending, width), e.at
            runs.append(n)
            a0 += n
            if a0 >= width:
                return _cleanup(runs, a0, 0, width), pos
        if runs[-1] == 0 and runs[-2] == 0:      # libtiff drops an empty pair
            del runs[-2:]


def _row_2d(bits: str, pos: int, width: int, ref: List[int],
            t4: bool = False) -> Tuple[List[int], int, bool]:
    """A two-dimensional row against the reference row's changing elements
    `ref` ([0, the changes..., width] and the imaginary change, width): its
    runs, the next bit, and whether the row met an EOL.  An extension code
    ends the row (Fax3Extension), as do an EOL and a vertical mode that
    moves back past a0 (libtiff's check on VL); in a T.4 strip a bad run
    code in horizontal mode ends it too."""
    try:
        return _row_2d_on(bits, pos, width, ref, t4)
    except IndexError:
        raise ValueError("CCITT: a two-dimensional code reads past the reference row's changes "
                         "(libtiff reads what earlier rows left in its run buffer; not read by "
                         "the port)") from None


def _row_2d_on(bits: str, pos: int, width: int, ref: List[int], t4: bool):
    runs: List[int] = []
    a0, pending, k = 0, 0, 1                     # b1 is ref[k]
    while a0 < width:
        if bits[pos:pos + 7] == "0000000":
            # an EOL where a mode is due: libtiff gives the run at a0 the rest
            # of the row and takes 11 bits; a T.4 strip goes on after the
            # next 1 bit, a T.6 strip stops
            runs.append(width - a0)
            return _cleanup(runs, a0, pending, width), pos + 11, True
        mode, pos = _code(bits, pos, _MODES, _MODE_LENGTHS)
        if runs and mode != "horizontal":
            while ref[k] <= a0 and ref[k] < width:
                k += 2
        if mode == "pass":
            pending += ref[k + 1] - a0
            a0 = ref[k + 1]
            k += 2
        elif mode == "horizontal":
            colour = len(runs) & 1
            for c in (colour, colour ^ 1):
                try:
                    n, pos = _run(bits, pos, c)
                except CCITTError as e:
                    if not t4:
                        raise
                    # libtiff takes the bad code's bits: an EOL's 11 zeros,
                    # so that the strip goes on at the EOL after it
                    at = e.at + (11 if bits[e.at:e.at + 11] == "0" * 11 else 0)
                    return (_cleanup(runs, a0 + e.pending, pending + e.pending, width), at,
                            False)
                runs.append(pending + n)
                pending = 0
                a0 += n
            while ref[k] <= a0 and ref[k] < width:
                k += 2
        elif mode == "extension":
            # uncompressed mode, which libtiff does not decode: the run at
            # a0 takes the rest of the row, then CLEANUP_RUNS
            runs.append(width - a0)
            return _cleanup(runs, a0, pending, width), pos, False
        else:
            a1 = ref[k] + mode
            if a1 < a0:                          # libtiff: a bad code, the row ends
                return _cleanup(runs, a0, pending, width), pos, False
            runs.append(pending + a1 - a0)
            pending, a0 = 0, a1
            k += 1 if mode >= 0 else -1
    return _cleanup(runs, a0, pending, width), pos, False


def _pixels(runs: List[int], width: int) -> np.ndarray:
    row = np.zeros(width, np.uint8)
    x = 0
    for i, n in enumerate(runs):
        n = min(n, width - x)
        if i & 1:
            row[x:x + n] = 1
        x += n
    return row


def _reference(runs: List[int], width: int) -> List[int]:
    """A row's runs -> its changing elements for the next row (the runs cut
    at the row's end, as libtiff's fill cuts them in place), then libtiff's
    imaginary change.  Past it libtiff's run buffer holds what earlier rows
    left there, which `_row_2d` refuses to read."""
    ref, x = [0], 0
    for n in runs:
        x = min(x + n, width)
        ref.append(x)
    return ref + [width]


def decode_ccitt(data: bytes, width: int, rows: int, compression: int,
                 t4_options: int = 0) -> np.ndarray:
    """One strip or tile of a CCITT-coded TIFF -> its rows, packed 8 pixels
    a byte (1 bits black)."""
    if compression not in (2, 3, 4):
        raise ValueError(f"CCITT: compression {compression} is not a CCITT coding")
    bits = "".join(_BITS[b] for b in data)
    out = np.zeros((rows, width), np.uint8)
    ref = _reference([width], width)
    pos, eol_read = 0, False
    for y in range(rows):
        if compression == 3:
            # libtiff's SYNC_EOL: 11 zeros (unless the last row read them),
            # any zeros after, then the 1
            eol = pos if eol_read else bits.find("0" * 11, pos)
            one = bits.find("1", eol) if eol >= 0 else -1
            if one < 0:
                raise ValueError(f"CCITT: no EOL before row {y} of a T.4 strip")
            pos = one + 1
            two_d = t4_options & 1 and bits[pos:pos + 1] == "0"
            pos += t4_options & 1
        else:
            two_d = compression == 4
        eol_read = False
        if two_d:
            runs, pos, eol_read = _row_2d(bits, pos, width, ref, compression == 3)
        else:
            runs, pos = _row_1d(bits, pos, width, compression == 3)
        if eol_read and compression == 4 and y < rows - 1:
            raise ValueError(f"CCITT: an EOL stops a T.6 strip in row {y} of {rows} (libtiff "
                             f"leaves the rows after it unset; not read by the port)")
        if compression == 2:
            pos = -(-pos // 8) * 8
        out[y] = _pixels(runs, width)
        ref = _reference(runs, width)
    return np.packbits(out, axis=1)
