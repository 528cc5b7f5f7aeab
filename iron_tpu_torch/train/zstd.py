"""A Zstandard decoder (RFC 8878) on numpy, for the orbax checkpoints the
JAX package writes (tensorstore compresses OCDBT nodes and zarr chunks with
zstd), so that the port reads them without the zstandard package.

    decompress(data) -> bytes

Frames: single-segment or windowed, with or without the content size, the
content checksum (the low 32 bits of xxHash64, checked when the frame's
flag is set); skippable frames are skipped; a dictionary ID raises.
Blocks: raw, RLE and compressed.  Literals: raw, RLE, Huffman in 1 or 4
streams, and treeless (the previous table).  Sequences: predefined, RLE,
FSE and repeat modes, with the three repeat offsets.

The Huffman streams carry most of a float checkpoint's bytes (float32
noise compresses to ~0.92 of its size, nearly all of it Huffman-coded
literals), so they are decoded vectorised: one table lookup at every bit
position gives each position's symbol and the position after it; the
chain from the first position is walked in jumps of 2^k symbols (the jump
table built by pointer doubling) and filled in between, vectorised.  Sequences
and the FSE-coded weights are decoded one symbol at a time.
"""
from __future__ import annotations

import numpy as np

_MAGIC = 0xFD2FB528
_BLOCK_MAX = 128 << 10

# the predefined distributions (RFC 8878, 3.1.1.3.2.2) and their accuracy logs
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
                1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# literal-length and match-length codes -> (baseline, extra bits)
_LL_CODES = ([(i, 0) for i in range(16)]
             + [(16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4),
                (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12),
                (8192, 13), (16384, 14), (32768, 15), (65536, 16)])
_ML_CODES = ([(i + 3, 0) for i in range(32)]
             + [(35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4),
                (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11),
                (4099, 12), (8195, 13), (16387, 14), (32771, 15), (65539, 16)])
_MAX_LOG = {"ll": 9, "of": 8, "ml": 9}
_MAX_SYMBOL = {"ll": 35, "of": 31, "ml": 52}


class ZstdError(ValueError):
    """A stream this decoder cannot read: corrupt, truncated, or using a
    feature it refuses (a dictionary)."""


# ---------------------------------------------------------------------------
# xxHash64 (the content checksum)
# ---------------------------------------------------------------------------

_P1, _P2, _P3, _P4, _P5 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
                           0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5)
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    pos = 0
    if n >= 32:
        v1, v2, v3, v4 = ((seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
                          (seed - _P1) & _M64)
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=stripes * 4).reshape(stripes, 4).tolist()
        for a, b, c, d in lanes:
            v1 = (_rotl((v1 + a * _P2) & _M64, 31) * _P1) & _M64
            v2 = (_rotl((v2 + b * _P2) & _M64, 31) * _P1) & _M64
            v3 = (_rotl((v3 + c * _P2) & _M64, 31) * _P1) & _M64
            v4 = (_rotl((v4 + d * _P2) & _M64, 31) * _P1) & _M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        pos = stripes * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        k = _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[pos:pos + 4], "little") * _P1 & _M64), 23) * _P2
             + _P3) & _M64
        pos += 4
    while pos < n:
        h = (_rotl(h ^ (data[pos] * _P5 & _M64), 11) * _P1) & _M64
        pos += 1
    h = ((h ^ (h >> 33)) * _P2) & _M64
    h = ((h ^ (h >> 29)) * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# bit readers
# ---------------------------------------------------------------------------

class _Forward:
    """Little-endian bits, least significant first (FSE table headers)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.bit = data, pos * 8

    def read(self, n: int) -> int:
        b = self.bit >> 3
        v = int.from_bytes(self.data[b:b + 4], "little") >> (self.bit & 7)
        self.bit += n
        return v & ((1 << n) - 1)

    def byte_end(self) -> int:
        if self.bit > len(self.data) * 8:
            raise ZstdError("a truncated FSE table description")
        return (self.bit + 7) >> 3


class _Backward:
    """A backward bitstream: read from its last byte's highest bit down,
    after the padding and the 1 that marks its end.  Reading past its start
    gives zeros (`pos` goes negative), which the FSE weight decoder uses to
    find its end."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("a bitstream without its end marker")
        self.data = bytes(8) + data
        self.pos = len(data) * 8 - 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        start = self.pos + 64
        b = start >> 3
        v = int.from_bytes(self.data[b:b + 8], "little") >> (start & 7)
        return v & ((1 << n) - 1)


# ---------------------------------------------------------------------------
# FSE
# ---------------------------------------------------------------------------

class _FSETable:
    def __init__(self, freqs, log: int):
        size = 1 << log
        symbols = [0] * size
        high = size
        state = {}
        for s, f in enumerate(freqs):
            if f == -1:
                high -= 1
                symbols[high] = s
                state[s] = 1
        step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
        for s, f in enumerate(freqs):
            if f <= 0:
                continue
            state[s] = f
            for _ in range(f):
                symbols[pos] = s
                pos = (pos + step) & mask
                while pos >= high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ZstdError("an FSE distribution that does not fill its table")
        self.symbols, self.nbits, self.base = symbols, [0] * size, [0] * size
        for i, s in enumerate(symbols):
            nxt = state[s]
            state[s] += 1
            nb = log - (nxt.bit_length() - 1)
            self.nbits[i], self.base[i] = nb, (nxt << nb) - size
        self.log = log


class _RLETable:
    """RLE mode: one symbol, no state bits."""

    def __init__(self, symbol: int):
        self.symbols, self.nbits, self.base, self.log = [symbol], [0], [0], 0


def _read_fse_table(data: bytes, pos: int, max_log: int, max_symbol: int):
    r = _Forward(data, pos)
    log = r.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining, freqs = (1 << log) + 1, []
    while remaining > 1 and len(freqs) <= max_symbol:
        bits = remaining.bit_length()
        low = (1 << (bits - 1)) - 1
        threshold = (1 << bits) - 1 - remaining
        val = r.read(bits)
        if (val & low) < threshold:
            val &= low
            r.bit -= 1
        elif val > low:
            val -= threshold
        proba = val - 1
        remaining -= abs(proba)
        freqs.append(proba)
        if proba == 0:
            while True:
                rep = r.read(2)
                freqs.extend([0] * rep)
                if rep != 3:
                    break
    if remaining != 1 or len(freqs) > max_symbol + 1:
        raise ZstdError("a corrupt FSE table description")
    return _FSETable(freqs, log), r.byte_end()


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------

class _HuffTable:
    """weights -> a table of 2^max_bits entries: each symbol's code length
    and the symbol, indexed by the next max_bits bits (RFC 8878, 4.2.1.3:
    codes rise from the lowest weight, symbols in order within a weight)."""

    def __init__(self, weights):
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ZstdError("a Huffman tree of no symbols")
        max_bits = total.bit_length()
        rest = (1 << max_bits) - total
        if rest & (rest - 1):
            raise ZstdError("Huffman weights that do not sum to a power of two")
        weights = list(weights) + [rest.bit_length()]
        if max_bits > 11:
            raise ZstdError(f"a Huffman code of {max_bits} bits")
        w = np.asarray(weights, np.int64)
        order = np.lexsort((np.arange(len(w)), w))
        order = order[w[order] > 0]
        counts = 1 << (w[order] - 1)
        self.symbol = np.repeat(order, counts).astype(np.uint8)
        self.length = np.repeat(max_bits + 1 - w[order], counts).astype(np.int32)
        self.max_bits = max_bits


def _read_huffman_tree(data: bytes, pos: int):
    header = data[pos]
    pos += 1
    if header >= 128:
        n = header - 127
        raw = data[pos:pos + (n + 1) // 2]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return _HuffTable(weights[:n]), pos + (n + 1) // 2
    table, start = _read_fse_table(data, pos, 6, 255)
    end = pos + header
    stream = _Backward(data[start:end])
    s1, s2 = stream.read(table.log), stream.read(table.log)
    weights = []

    def step(state):
        weights.append(table.symbols[state])
        return table.base[state] + stream.read(table.nbits[state])

    while True:           # two interleaved states, until the stream runs out
        s1 = step(s1)
        if stream.pos < 0:
            weights.append(table.symbols[s2])
            break
        s2 = step(s2)
        if stream.pos < 0:
            weights.append(table.symbols[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return _HuffTable(weights), end


def _huffman_stream(data: bytes, n: int, table: _HuffTable) -> np.ndarray:
    """Decode n symbols of one backward Huffman stream, vectorised."""
    if n == 0:
        return np.zeros(0, np.uint8)
    if not data or data[-1] == 0:
        raise ZstdError("a Huffman stream without its end marker")
    L = table.max_bits
    # the stream MSB-first from its last byte; position 0 is the bit after the marker
    rev = np.frombuffer(data[::-1] + bytes(4), np.uint8).astype(np.uint32)
    words = (rev[:-3] << 24) | (rev[1:-2] << 16) | (rev[2:-1] << 8) | rev[3:]
    skip = 8 - data[-1].bit_length() + 1
    M = len(data) * 8 - skip
    at = np.arange(skip, skip + M, dtype=np.int64)
    window = (words[at >> 3] >> (32 - L - (at & 7)).astype(np.uint32)) & ((1 << L) - 1)
    symbol = table.symbol[window]
    nxt = np.minimum(np.arange(M, dtype=np.int32) + table.length[window], M)
    nxt = np.append(nxt, np.int32(M))                     # M: past the end, absorbing
    # the chain from position 0: anchors every 2^k symbols by a Python walk
    # over nxt^(2^k) (k doublings), then the symbols between them vectorised
    k = max(0, (n // 256).bit_length())
    jump = nxt
    for _ in range(k):
        jump = jump[jump]
    anchors = [0]
    for _ in range(((n - 1) >> k)):
        anchors.append(int(jump[anchors[-1]]))
    pos = np.empty((len(anchors), 1 << k), np.int32)
    pos[:, 0] = anchors
    for j in range(1, 1 << k):
        pos[:, j] = nxt[pos[:, j - 1]]
    pos = pos.ravel()[:n]
    if pos[-1] >= M or nxt[pos[-1]] != M:
        raise ZstdError("a Huffman stream that does not end with its last symbol")
    return symbol[pos]


def _literals(data: bytes, pos: int, state: dict):
    """The literals section at `pos` -> (literals, position after it)."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                       # raw, RLE
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), pos + 3
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("truncated raw literals")
            return data[pos:pos + size], pos + size
        return bytes([data[pos]]) * size, pos + 1
    nbytes = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    bits = {0: 10, 1: 10, 2: 14, 3: 18}[fmt]
    head = int.from_bytes(data[pos:pos + nbytes], "little") >> 4
    regen, comp = head & ((1 << bits) - 1), head >> bits
    streams = 1 if fmt == 0 else 4
    pos += nbytes
    end = pos + comp
    if end > len(data):
        raise ZstdError("truncated compressed literals")
    if kind == 2:
        state["huffman"], pos = _read_huffman_tree(data, pos)
    elif state.get("huffman") is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    table = state["huffman"]
    if streams == 1:
        return _huffman_stream(data[pos:end], regen, table).tobytes(), end
    sizes = [int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little") for i in range(3)]
    pos += 6
    sizes.append(end - pos - sum(sizes))
    if sizes[3] < 0:
        raise ZstdError("a literals jump table past its section")
    seg = (regen + 3) // 4
    counts = [seg, seg, seg, regen - 3 * seg]
    out = []
    for size, count in zip(sizes, counts):
        out.append(_huffman_stream(data[pos:pos + size], count, table))
        pos += size
    return np.concatenate(out).tobytes(), end


# ---------------------------------------------------------------------------
# sequences
# ---------------------------------------------------------------------------

_DEFAULTS = {}


def _default_table(kind: str):
    if kind not in _DEFAULTS:
        freqs, log = {"ll": _LL_DEFAULT, "of": _OF_DEFAULT, "ml": _ML_DEFAULT}[kind]
        _DEFAULTS[kind] = _FSETable(freqs, log)
    return _DEFAULTS[kind]


def _sequences(data: bytes, pos: int, end: int, literals: bytes, out: bytearray,
               state: dict) -> None:
    """Execute the sequences section [pos, end) onto `out`."""
    b0 = data[pos]
    if b0 == 0:
        out += literals
        return
    if b0 < 128:
        count, pos = b0, pos + 1
    elif b0 < 255:
        count, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        count, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence compression modes")
    tables = {}
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        mode = (modes >> shift) & 3
        if mode == 0:
            tables[kind] = _default_table(kind)
        elif mode == 1:
            tables[kind] = _RLETable(data[pos])
            pos += 1
        elif mode == 2:
            tables[kind], pos = _read_fse_table(data, pos, _MAX_LOG[kind], _MAX_SYMBOL[kind])
        else:
            if kind not in state:
                raise ZstdError("a repeated sequence table without an earlier one")
            tables[kind] = state[kind]
        state[kind] = tables[kind]
    stream = _Backward(data[pos:end])
    read = stream.read
    ll_t, of_t, ml_t = tables["ll"], tables["of"], tables["ml"]
    ll_s, of_s, ml_s = read(ll_t.log), read(of_t.log), read(ml_t.log)
    reps = state["reps"]
    lit = 0
    for i in range(count):
        of_code = of_t.symbols[of_s]
        ml_code, ll_code = ml_t.symbols[ml_s], ll_t.symbols[ll_s]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ZstdError("a sequence code out of range")
        offset = (1 << of_code) + read(of_code)
        base, nb = _ML_CODES[ml_code]
        ml = base + read(nb)
        base, nb = _LL_CODES[ll_code]
        ll = base + read(nb)
        if offset > 3:
            offset -= 3
            reps = [offset, reps[0], reps[1]]
        else:
            idx = offset - 1 + (ll == 0)
            if idx == 0:
                offset = reps[0]
            elif idx == 1:
                offset = reps[1]
                reps = [offset, reps[0], reps[2]]
            elif idx == 2:
                offset = reps[2]
                reps = [offset, reps[0], reps[1]]
            else:
                offset = reps[0] - 1
                reps = [offset, reps[0], reps[1]]
        if i + 1 < count:
            ll_s = ll_t.base[ll_s] + read(ll_t.nbits[ll_s])
            ml_s = ml_t.base[ml_s] + read(ml_t.nbits[ml_s])
            of_s = of_t.base[of_s] + read(of_t.nbits[of_s])
        if lit + ll > len(literals):
            raise ZstdError("a sequence past the literals")
        out += literals[lit:lit + ll]
        lit += ll
        start = len(out) - offset
        if offset <= 0 or start < state["frame_start"]:
            raise ZstdError("a match offset before the frame's start")
        if offset >= ml:
            out += out[start:start + ml]
        else:                                  # the match overlaps what it writes
            chunk = out[start:]
            out += (chunk * (ml // offset + 1))[:ml]
    if stream.pos != 0:
        raise ZstdError("a sequences bitstream not consumed exactly")
    state["reps"] = reps
    out += literals[lit:]


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the zstd frame at `pos` (after its magic) onto `out`; return
    the position after it."""
    desc = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = desc >> 6, (desc >> 5) & 1, (desc >> 2) & 1, desc & 3
    if desc & 8:
        raise ZstdError("the reserved bit of a frame header is set")
    if not single:
        pos += 1                                # the window descriptor: the output stays whole
    dict_size = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(data[pos:pos + dict_size], "little")
    pos += dict_size
    if dict_id:
        raise ZstdError(f"a frame compressed with dictionary {dict_id}, which this decoder "
                        f"does not have")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = int.from_bytes(data[pos:pos + fcs_size], "little") if fcs_size else None
    if fcs_size == 2:
        content_size += 256
    pos += fcs_size
    start = len(out)
    state = {"reps": [1, 4, 8], "frame_start": start}
    while True:
        if pos + 3 > len(data):
            raise ZstdError("a truncated block header")
        head = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("a truncated raw block")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            out += bytes([data[pos]]) * size
            pos += 1
        elif kind == 2:
            if size > _BLOCK_MAX or pos + size > len(data):
                raise ZstdError("a compressed block past its limits")
            lits, p = _literals(data, pos, state)
            _sequences(data, p, pos + size, lits, out, state)
            pos += size
        else:
            raise ZstdError("a reserved block type")
        if last:
            break
    if content_size is not None and len(out) - start != content_size:
        raise ZstdError(f"a frame of {len(out) - start} bytes where its header says "
                        f"{content_size}")
    if checksum:
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress(data: bytes) -> bytes:
    """Every frame of `data` decoded and concatenated (skippable frames
    skipped)."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("trailing bytes after the last frame")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic == _MAGIC:
            pos = _frame(data, pos + 4, out)
        elif magic & 0xFFFFFFF0 == 0x184D2A50:
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos > len(data):
                raise ZstdError("a truncated skippable frame")
        else:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
    return bytes(out)
