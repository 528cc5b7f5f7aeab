"""WebP on numpy: what cv2.imread(IMREAD_UNCHANGED) gives for a WebP file
(OpenCV decodes it through libwebp), bit for bit, in RGB(A) order.

    decode_webp(data) -> uint8 [H, W, 3], or [H, W, 4] where the file has alpha

The container (RIFF "WEBP"): a "VP8 " chunk (lossy), a "VP8L" chunk
(lossless), or "VP8X" (the extended header) with an "ALPH" chunk beside
"VP8 ", or with "ANIM" / "ANMF" frames, of which the first is composed on
a transparent canvas of the file's size as libwebp's WebPAnimDecoder composes
it; "ICCP", "EXIF", "XMP " and unknown chunks are ignored, as OpenCV ignores
them.  There are 4 channels where the file's features say it has alpha (the
VP8X flag, or the VP8L header's bit), else 3.

VP8L (lossless): the four transforms (predictor with its 14 modes,
cross-colour, subtract-green, colour indexing with pixel bundling), the
colour cache, meta prefix codes through the entropy image, simple and
normal prefix codes, LZ77 with the 120-entry distance map.

VP8 (lossy, key frames): the boolean decoder, segments with their
quantisers and filter levels, the loop-filter deltas, 1-8 token partitions,
coefficient probability updates and the skip probability, the 16x16, 4x4
and chroma intra modes with the 127 / 129 edges, the Walsh-Hadamard
transform and libwebp's integer IDCT (20091 / 35468), the simple and normal
loop filters with sharpness and the hev thresholds; then libwebp's default
output: fancy upsampling of chroma and its 14-bit VP8YUVToR/G/B.

ALPH: raw or VP8L-coded (the green channel), with the none, horizontal,
vertical and gradient filters; the pre-processing flag only asks for
dithering, which libwebp's default decoder does not do.

Damage: the image decoders get every byte after their chunk's header, to
the end of the file, as libwebp hands them over; a VP8 partition that runs
dry, a VP8L stream read past the end, a RIFF size past the file or any
other error libwebp stops at raises WebPError, a NoImage.

The constant tables are those of the VP8 format (RFC 6386: coefficient
probabilities and their update probabilities, the 4x4 mode probabilities in
libwebp's mode order, the quantiser steps) and of VP8L (its distance map).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from iron_tpu_torch.data.io import NoImage

# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

_COEFF_PROBA0 = np.frombuffer(bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080"
    "bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a808080"
    "4e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080"
    "cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae18080808080"
    "5081d3ffc2e080808080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff808080"
    "b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080"
    "175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb8080808080"
    "7c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff808080"
    "2d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080"
    "ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080"
    "452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080"
    "f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff8080808080808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80"
    "184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080"
    "a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb808080"
    "2a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080"),
    np.uint8).reshape(4, 8, 3, 11)
_COEFF_UPDATE_PROBA = np.frombuffer(bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffff"
    "dff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefeffffffffffffffff"
    "fdfffffffffffffffffffffff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffffffffffffffff"
    "fbfefefffffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffffffff"
    "dffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffffffff"
    "fffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefeffffffffffffffff"
    "fdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffffffffffff"
    "feffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffff"
    "ecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffff"
    "fffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffffffffffffffff"
    "fdfffefefffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcffffffffffffffffff"
    "f9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"),
    np.uint8).reshape(4, 8, 3, 11)
# [top mode][left mode][tree node], modes in libwebp's order: DC TM VE HE RD VR LD VL HD HU
_BMODES_PROBA = np.frombuffer(bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150a"
    "ad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d"
    "102486b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a6"
    "31179d412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5"
    "bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab"
    "3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e"
    "5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b"
    "1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd33"
    "3211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206"
    "df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a"
    "2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab013911054766"
    "3935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a66"
    "66d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113"
    "469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808"
    "118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151"
    "bc4020291475978e1415a370130c3dc380300418"), np.uint8).reshape(10, 10, 9).tolist()
_DC_TABLE = list(bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c1d1e1f202122232425252627"
    "28292a2b2c2d2e2e2f303132333435363738393a3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f5051"
    "52535455565758595b5d5f6062646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d"))
_AC_TABLE = [
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
    49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82,
    84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122,
    125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173,
    177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284]
# VP8L: distance codes 1-120 -> (dy << 4) | (8 - dx)
_CODE_TO_PLANE = list(bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c58454b343c035759131d"
    "565a232d444c555b333d68026769121e666a222e545c434d656b323e78017779535d111f646c424e767a212f"
    "757b313f636d525e00747c414f1020626e30737d515f40727e616f50717f6070"))

_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# the 4x4 intra-mode tree (libwebp's kYModesIntra4): node i's children at 2i, 2i + 1,
# a leaf -mode
_YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3
# VP8L: the order of the code-length code's lengths in the bitstream
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


class WebPError(NoImage):
    """A WebP file OpenCV's libwebp reads no image from: a variant it
    refuses, or damage it stops at (a cut file, a RIFF or chunk size past
    the file, corrupt data a decoder meets)."""


# ---------------------------------------------------------------------------
# VP8L: the lossless bitstream
# ---------------------------------------------------------------------------

class _Bits:
    """VP8L's bit reader: least significant bit first, a 64-bit window."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos       # pos: the next byte to load
        self.val, self.n = 0, 0

    def fill(self) -> None:
        while self.n <= 32:
            chunk = self.data[self.pos:self.pos + 4]
            self.val |= int.from_bytes(chunk, "little") << self.n
            self.pos += 4
            self.n += 32
            if len(chunk) < 4 and self.pos > len(self.data) + 8:
                raise WebPError("VP8L: the bitstream ends early")

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.n < n:
            self.fill()
        v = self.val & ((1 << n) - 1)
        self.val >>= n
        self.n -= n
        return v


class _Prefix:
    """A canonical prefix code: `table[peek]` = (length << 16) | symbol for
    the next `bits` bits, codes bit-reversed (read least significant first)."""

    def __init__(self, lengths):
        lengths = np.asarray(lengths, np.int64)
        used = np.flatnonzero(lengths)
        if used.size == 0:
            raise WebPError("VP8L: a prefix code with no symbols")
        if used.size == 1:                  # one symbol: no bits
            self.bits, self.table = 0, [int(used[0])]
            return
        maxlen = int(lengths.max())
        counts = np.bincount(lengths[used], minlength=maxlen + 1)
        if sum(int(counts[l]) << (maxlen - l) for l in range(1, maxlen + 1)) != 1 << maxlen:
            raise WebPError("VP8L: an incomplete or over-subscribed prefix code")
        code, next_code = 0, [0] * (maxlen + 2)
        for l in range(1, maxlen + 1):
            code = (code + int(counts[l - 1])) << 1 if l > 1 else 0
            next_code[l] = code
        table = np.zeros(1 << maxlen, np.int64)
        for l in range(1, maxlen + 1):
            syms = used[lengths[used] == l]
            if syms.size == 0:
                continue
            codes = next_code[l] + np.arange(syms.size)
            rev = np.zeros_like(codes)
            for b in range(l):
                rev |= ((codes >> b) & 1) << (l - 1 - b)
            idx = (rev[:, None] + (np.arange(1 << (maxlen - l)) << l)[None, :]).ravel()
            table[idx] = np.repeat((l << 16) | syms, 1 << (maxlen - l))
        self.bits, self.table = maxlen, table.tolist()


def _read_prefix_code(br: _Bits, alphabet: int) -> _Prefix:
    lengths = [0] * alphabet
    if br.read(1):                          # simple code: one or two symbols
        two = br.read(1)
        first = br.read(8 if br.read(1) else 1)
        if first >= alphabet:
            raise WebPError("VP8L: a symbol past its alphabet")
        lengths[first] = 1
        if two:
            second = br.read(8)
            if second >= alphabet:
                raise WebPError("VP8L: a symbol past its alphabet")
            lengths[second] = 1                 # the same symbol twice: a one-symbol code
        return _Prefix(lengths)
    cl = [0] * 19
    for i in range(4 + br.read(4)):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    clcode = _Prefix(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise WebPError("VP8L: max_symbol past the alphabet")
    else:
        max_symbol = alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        if br.n < 16:
            br.fill()
        e = clcode.table[br.val & ((1 << clcode.bits) - 1)]
        br.val >>= e >> 16
        br.n -= e >> 16
        c = e & 0xFFFF
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
        repeat = br.read(extra) + offset
        if sym + repeat > alphabet:
            raise WebPError("VP8L: code lengths past the alphabet")
        value = prev if c == 16 else 0
        lengths[sym:sym + repeat] = [value] * repeat
        sym += repeat
    return _Prefix(lengths)


def _div(a: int, bits: int) -> int:
    return (a + (1 << bits) - 1) >> bits


def _decode_stream(br: _Bits, xsize: int, ysize: int, level0: bool) -> np.ndarray:
    """One entropy-coded image (the main image when level0, with its
    transforms undone) -> uint32 ARGB [ysize, xsize]."""
    transforms = []
    width = xsize
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise WebPError("VP8L: a transform given twice")
            seen.add(kind)
            if kind in (0, 1):
                bits = br.read(3) + 2
                sub = _decode_stream(br, _div(width, bits), _div(ysize, bits), False)
                transforms.append((kind, width, bits, sub))
            elif kind == 2:
                transforms.append((2, width, 0, None))
            else:
                n = br.read(8) + 1
                bits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
                table = _decode_stream(br, n, 1, False)[0]
                table = np.cumsum(table.view(np.uint8).reshape(n, 4), axis=0,
                                  dtype=np.uint64).astype(np.uint8).view(np.uint32)[:, 0]
                transforms.append((3, width, bits, table))
                width = _div(width, bits)
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise WebPError(f"VP8L: colour cache of {cache_bits} bits")
    meta_bits, meta = 0, None
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta = ((_decode_stream(br, _div(width, meta_bits), _div(ysize, meta_bits), False)
                 >> 8) & 0xFFFF).astype(np.int64)
    groups = []
    for _ in range(int(meta.max()) + 1 if meta is not None else 1):
        groups.append([_read_prefix_code(br, 256 + 24 + ((1 << cache_bits) if cache_bits
                                                          else 0)),
                       _read_prefix_code(br, 256), _read_prefix_code(br, 256),
                       _read_prefix_code(br, 256), _read_prefix_code(br, 40)])
    pixels = _decode_pixels(br, width, ysize, cache_bits, groups, meta, meta_bits)
    for kind, w, bits, sub in reversed(transforms):
        pixels = _inverse_transform(kind, pixels, w, bits, sub)
    return pixels


def _decode_pixels(br, width, height, cache_bits, groups, meta, meta_bits) -> np.ndarray:
    n = width * height
    out = [0] * n
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    meta_w = _div(width, meta_bits) if meta is not None else 0
    meta_list = meta.ravel().tolist() if meta is not None else None
    data, pos, val, nb = br.data, br.pos, br.val, br.n
    i = x = y = 0
    group = groups[0]
    mask = (1 << meta_bits) - 1
    regroup = meta_list is not None         # look the group up at the next pixel
    last = 0                                # pixels before `last` are in the cache
    while i < n:
        if regroup or (meta_list is not None and (x & mask) == 0):
            group = groups[meta_list[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
            regroup = False
        while nb < 64:
            val |= int.from_bytes(data[pos:pos + 4], "little") << nb
            pos += 4
            nb += 32
        code = group[0]
        e = code.table[val & ((1 << code.bits) - 1)]
        val >>= e >> 16
        nb -= e >> 16
        sym = e & 0xFFFF
        if sym < 256:
            code = group[1]
            e = code.table[val & ((1 << code.bits) - 1)]
            val >>= e >> 16
            nb -= e >> 16
            red = e & 0xFFFF
            code = group[2]
            e = code.table[val & ((1 << code.bits) - 1)]
            val >>= e >> 16
            nb -= e >> 16
            blue = e & 0xFFFF
            code = group[3]
            e = code.table[val & ((1 << code.bits) - 1)]
            val >>= e >> 16
            nb -= e >> 16
            out[i] = ((e & 0xFFFF) << 24) | (red << 16) | (sym << 8) | blue
            i += 1
            x += 1
            if x == width:
                x = 0
                y += 1
        elif sym < 280:
            prefix = sym - 256
            if prefix < 4:
                length = prefix + 1
            else:
                extra = (prefix - 2) >> 1
                length = ((2 + (prefix & 1)) << extra) + (val & ((1 << extra) - 1)) + 1
                val >>= extra
                nb -= extra
            code = group[4]
            e = code.table[val & ((1 << code.bits) - 1)]
            val >>= e >> 16
            nb -= e >> 16
            prefix = e & 0xFFFF
            while nb < 32:
                val |= int.from_bytes(data[pos:pos + 4], "little") << nb
                pos += 4
                nb += 32
            if prefix < 4:
                code = prefix + 1
            else:
                extra = (prefix - 2) >> 1
                code = ((2 + (prefix & 1)) << extra) + (val & ((1 << extra) - 1)) + 1
                val >>= extra
                nb -= extra
            if code > 120:
                dist = code - 120
            else:
                plane = _CODE_TO_PLANE[code - 1]
                dist = max(1, (plane >> 4) * width + 8 - (plane & 15))
            if dist > i or i + length > n:
                raise WebPError("VP8L: a backward reference out of the image")
            if dist >= length:
                out[i:i + length] = out[i - dist:i - dist + length]
            else:
                for k in range(i, i + length):
                    out[k] = out[k - dist]
            i += length
            x += length
            while x >= width:
                x -= width
                y += 1
            regroup = meta_list is not None
        else:
            if cache is None:
                raise WebPError("VP8L: a colour-cache symbol without a cache")
            for k in range(last, i):
                a = out[k]
                cache[((a * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = a
            last = i
            out[i] = cache[sym - 280]
            i += 1
            x += 1
            if x == width:
                x = 0
                y += 1
        if pos > len(data) + 16:
            raise WebPError("VP8L: the bitstream ends early")
    br.pos, br.val, br.n = pos, val, nb
    return np.asarray(out, np.uint32).reshape(height, width)


def _inverse_transform(kind, pixels, width, bits, sub) -> np.ndarray:
    height = pixels.shape[0]
    if kind == 2:                                       # subtract green
        g = (pixels >> 8) & 0xFF
        rb = (((pixels & 0x00FF00FF) + ((g << 16) | g)) & 0x00FF00FF)
        return (pixels & 0xFF00FF00) | rb
    if kind == 3:                                       # colour indexing
        table = np.zeros(256, np.uint32)
        table[:sub.size] = sub[:256]
        idx = (pixels >> 8) & 0xFF
        if bits:
            per = 1 << bits
            bpp = 8 >> bits
            cols = np.arange(width)
            packed = idx[:, cols >> bits]
            idx = (packed >> (bpp * (cols & (per - 1)))) & ((1 << bpp) - 1)
        return table[idx]
    ys, xs = np.arange(height)[:, None] >> bits, np.arange(width)[None, :] >> bits
    block = sub[ys, xs]
    if kind == 1:                                       # cross colour
        s8 = lambda v: ((v.astype(np.int32) & 0xFF) ^ 0x80) - 0x80
        g2r, g2b, r2b = s8(block), s8(block >> 8), s8(block >> 16)
        green = s8(pixels >> 8)
        red = ((pixels >> 16) & 0xFF).astype(np.int32)
        blue = (pixels & 0xFF).astype(np.int32)
        red = (red + ((g2r * green) >> 5)) & 0xFF
        blue = (blue + ((g2b * green) >> 5) + ((r2b * s8(red)) >> 5)) & 0xFF
        return ((pixels & 0xFF00FF00) | (red.astype(np.uint32) << 16)
                | blue.astype(np.uint32))
    return _inverse_predictor(pixels, (block >> 8) & 0xF)


def _add(a: int, b: int) -> int:
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clamp_full(a: int, b: int, c: int) -> int:
    out = 0
    for s in (0, 8, 16, 24):
        v = ((a >> s) & 0xFF) + ((b >> s) & 0xFF) - ((c >> s) & 0xFF)
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _clamp_half(a: int, b: int) -> int:
    out = 0
    for s in (0, 8, 16, 24):
        x, y = (a >> s) & 0xFF, (b >> s) & 0xFF
        d = x - y
        v = x + (d // 2 if d >= 0 else -((-d) // 2))
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _select(top: int, left: int, tl: int) -> int:
    pa = 0
    for s in (0, 8, 16, 24):
        c = (tl >> s) & 0xFF
        pa += abs(((left >> s) & 0xFF) - c) - abs(((top >> s) & 0xFF) - c)
    return top if pa <= 0 else left


def _inverse_predictor(pixels: np.ndarray, modes: np.ndarray) -> np.ndarray:
    height, width = pixels.shape
    res = pixels.tolist()
    modes = modes.tolist()
    out = []
    prev = None
    for y in range(height):
        row, mrow = res[y], modes[y]
        cur = [0] * width
        if prev is None:
            left = _add(row[0], 0xFF000000)
            cur[0] = left
            for x in range(1, width):
                left = _add(row[x], left)
                cur[x] = left
        else:
            left = _add(row[0], prev[0])
            cur[0] = left
            for x in range(1, width):
                m = mrow[x]
                t = prev[x]
                if m == 1:
                    p = left
                elif m == 2:
                    p = t
                elif m == 3:
                    p = prev[x + 1] if x + 1 < width else cur[0]
                elif m == 4:
                    p = prev[x - 1]
                elif m == 5:
                    tr = prev[x + 1] if x + 1 < width else cur[0]
                    p = _avg(_avg(left, tr), t)
                elif m == 6:
                    p = _avg(left, prev[x - 1])
                elif m == 7:
                    p = _avg(left, t)
                elif m == 8:
                    p = _avg(prev[x - 1], t)
                elif m == 9:
                    p = _avg(t, prev[x + 1] if x + 1 < width else cur[0])
                elif m == 10:
                    tr = prev[x + 1] if x + 1 < width else cur[0]
                    p = _avg(_avg(left, prev[x - 1]), _avg(t, tr))
                elif m == 11:
                    p = _select(t, left, prev[x - 1])
                elif m == 12:
                    p = _clamp_full(left, t, prev[x - 1])
                elif m == 13:
                    p = _clamp_half(_avg(left, t), prev[x - 1])
                else:                                   # 0, 14, 15
                    p = 0xFF000000
                left = _add(row[x], p)
                cur[x] = left
        out.append(cur)
        prev = cur
    return np.asarray(out, np.uint32)


def _vp8l_header(data: bytes):
    if len(data) < 5 or data[0] != 0x2F:
        raise WebPError("VP8L: no signature")
    bits = int.from_bytes(data[1:5], "little")
    width, height = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    alpha, version = (bits >> 28) & 1, bits >> 29
    if version != 0:
        raise WebPError(f"VP8L: version {version}")
    return width, height, alpha


def decode_vp8l(data: bytes) -> np.ndarray:
    """A VP8L bitstream -> uint32 ARGB [H, W]."""
    width, height, _ = _vp8l_header(data)
    br = _Bits(data, 5)
    return _stream_in_data(br, width, height)


def _stream_in_data(br: _Bits, width: int, height: int) -> np.ndarray:
    """`_decode_stream` of the level-0 image, which must not have read
    past the end of its data: libwebp's VP8L decoder sets its end-of-stream
    flag once it has used more bits than the data holds, and then stops
    with an error."""
    out = _decode_stream(br, width, height, True)
    if 8 * br.pos - br.n > 8 * len(br.data):
        raise WebPError("VP8L: the image reads past the end of its data (libwebp stops)")
    return out


# ---------------------------------------------------------------------------
# VP8: the lossy bitstream
# ---------------------------------------------------------------------------

class _BoolDecoder:
    """VP8's boolean entropy decoder (RFC 6386, 7.3).  `value` keeps
    8 + `count` bits; a decision compares it with split << count."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.value, self.count, self.range = 0, -8, 255
        self.eof = False
        self.load()

    def load(self) -> None:
        """The next bytes, 7 at a time; past the end, 8 zero bits and the
        eof flag, as libwebp's VP8LoadFinalBytes sets it when a decision
        needs bits the partition has not got (libwebp then stops at the
        end of the macroblock or of the row of modes)."""
        chunk = self.data[self.pos:self.pos + 7]
        self.pos += 7
        if not chunk:
            self.eof = True
            self.value <<= 8
            self.count += 8
            return
        self.value = (self.value << (8 * len(chunk))) | int.from_bytes(chunk, "big")
        self.count += 8 * len(chunk)

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.count < 0:
            self.load()
        big = split << self.count
        if self.value >= big:
            self.value -= big
            r = self.range - split
            bit = 1
        else:
            r = split
            bit = 0
        if r < 128:
            s = 8 - r.bit_length()
            r <<= s
            self.count -= s
        self.range = r
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def maybe_signed(self, n: int) -> int:
        return self.signed(n) if self.bit(128) else 0


def _coefficients(br: _BoolDecoder, bands, ctx: int, dq, first: int, out, base: int) -> int:
    """One block's tokens (libwebp's GetCoeffs) into out[base:base + 16],
    dequantised; returns the index after the last non-zero coefficient
    (or `first` when there is none)."""
    bit = br.bit
    n = first
    p = bands[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n
        while not bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[n][0]
        if not bit(p[2]):
            v = 1
            nxt = 1
        else:
            if not bit(p[3]):
                if not bit(p[4]):
                    v = 2
                else:
                    v = 3 + bit(p[5])
            elif not bit(p[6]):
                if not bit(p[7]):
                    v = 5 + bit(159)
                else:
                    v = 7 + 2 * bit(165)
                    v += bit(145)
            else:
                b1 = bit(p[8])
                b0 = bit(p[9 + b1])
                cat = 2 * b1 + b0
                v = 0
                for q in _CAT3456[cat]:
                    v += v + bit(q)
                v += 3 + (8 << cat)
            nxt = 2
        if bit(128):
            v = -v
        out[base + _ZIGZAG[n]] = v * dq[n > 0]
        n += 1
        if n < 16:
            p = bands[n][nxt]
    return 16


def _idct(coeffs: np.ndarray) -> np.ndarray:
    """libwebp's TransformOne without the add: coeffs int [..., 16] (raster
    order) -> the residuals [..., 4, 4] ((v + 4) >> 3 of the second pass)."""
    c = coeffs.reshape(coeffs.shape[:-1] + (4, 4)).astype(np.int64)
    mul1 = lambda a: ((a * 20091) >> 16) + a
    mul2 = lambda a: (a * 35468) >> 16
    i0, i4, i8, i12 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a, b = i0 + i8, i0 - i8
    cc, d = mul2(i4) - mul1(i12), mul1(i4) + mul2(i12)
    t = np.stack([a + d, b + cc, b - cc, a - d], -1)   # [..., column, k]
    t0, t4, t8, t12 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    dc = t0 + 4
    a, b = dc + t8, dc - t8
    cc, d = mul2(t4) - mul1(t12), mul1(t4) + mul2(t12)
    return np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3   # [..., row, x]


def _wht(dc: np.ndarray) -> np.ndarray:
    """libwebp's TransformWHT: 16 DC coefficients -> the 16 blocks' DCs."""
    x = [int(v) for v in dc]
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = x[i] + x[12 + i], x[4 + i] + x[8 + i]
        a2, a3 = x[4 + i] - x[8 + i], x[i] - x[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        out[4 * i:4 * i + 4] = [(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3]
    return out


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top, left, tl):
    """A 4x4 intra prediction (libwebp's VE4 ... HU4) -> 16 values, rows
    first; top = the 8 pixels above (4 and the 4 above-right), left = 4."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == 0:                                           # DC
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [v] * 16
    if mode == 1:                                           # TM
        out = []
        for l in left:
            for t in (A, B, C, D):
                v = t + l - X
                out.append(0 if v < 0 else 255 if v > 255 else v)
        return out
    if mode == 2:                                           # VE
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == 3:                                           # HE
        rows = (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))
        return [r for r in rows for _ in range(4)]
    d = [[0] * 4 for _ in range(4)]                         # d[y][x]
    if mode == 4:                                           # RD
        d[3][0] = _avg3(J, K, L)
        d[3][1] = d[2][0] = _avg3(I, J, K)
        d[3][2] = d[2][1] = d[1][0] = _avg3(X, I, J)
        d[3][3] = d[2][2] = d[1][1] = d[0][0] = _avg3(A, X, I)
        d[2][3] = d[1][2] = d[0][1] = _avg3(B, A, X)
        d[1][3] = d[0][2] = _avg3(C, B, A)
        d[0][3] = _avg3(D, C, B)
    elif mode == 5:                                         # VR
        d[0][0] = d[2][1] = _avg2(X, A)
        d[0][1] = d[2][2] = _avg2(A, B)
        d[0][2] = d[2][3] = _avg2(B, C)
        d[0][3] = _avg2(C, D)
        d[3][0] = _avg3(K, J, I)
        d[2][0] = _avg3(J, I, X)
        d[1][0] = d[3][1] = _avg3(I, X, A)
        d[1][1] = d[3][2] = _avg3(X, A, B)
        d[1][2] = d[3][3] = _avg3(A, B, C)
        d[1][3] = _avg3(B, C, D)
    elif mode == 6:                                         # LD
        d[0][0] = _avg3(A, B, C)
        d[0][1] = d[1][0] = _avg3(B, C, D)
        d[0][2] = d[1][1] = d[2][0] = _avg3(C, D, E)
        d[0][3] = d[1][2] = d[2][1] = d[3][0] = _avg3(D, E, F)
        d[1][3] = d[2][2] = d[3][1] = _avg3(E, F, G)
        d[2][3] = d[3][2] = _avg3(F, G, H)
        d[3][3] = _avg3(G, H, H)
    elif mode == 7:                                         # VL
        d[0][0] = _avg2(A, B)
        d[0][1] = d[2][0] = _avg2(B, C)
        d[0][2] = d[2][1] = _avg2(C, D)
        d[0][3] = d[2][2] = _avg2(D, E)
        d[1][0] = _avg3(A, B, C)
        d[1][1] = d[3][0] = _avg3(B, C, D)
        d[1][2] = d[3][1] = _avg3(C, D, E)
        d[1][3] = d[3][2] = _avg3(D, E, F)
        d[2][3] = _avg3(E, F, G)
        d[3][3] = _avg3(F, G, H)
    elif mode == 8:                                         # HD
        d[0][0] = d[1][2] = _avg2(I, X)
        d[1][0] = d[2][2] = _avg2(J, I)
        d[2][0] = d[3][2] = _avg2(K, J)
        d[3][0] = _avg2(L, K)
        d[0][3] = _avg3(A, B, C)
        d[0][2] = _avg3(X, A, B)
        d[0][1] = d[1][3] = _avg3(I, X, A)
        d[1][1] = d[2][3] = _avg3(J, I, X)
        d[2][1] = d[3][3] = _avg3(K, J, I)
        d[3][1] = _avg3(L, K, J)
    else:                                                   # HU
        d[0][0] = _avg2(I, J)
        d[0][2] = d[1][0] = _avg2(J, K)
        d[1][2] = d[2][0] = _avg2(K, L)
        d[0][1] = _avg3(I, J, K)
        d[0][3] = d[1][1] = _avg3(J, K, L)
        d[1][3] = d[2][1] = _avg3(K, L, L)
        d[2][3] = d[2][2] = d[3][0] = d[3][1] = d[3][2] = d[3][3] = L
    return [v for row in d for v in row]


def _pred_block(mode: int, top: np.ndarray, left: np.ndarray, tl: int, size: int,
                mb_x: int, mb_y: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction (DC with libwebp's edge
    variants, TM, V, H)."""
    if mode == DC_PRED:
        shift = 4 if size == 16 else 3
        if mb_x > 0 and mb_y > 0:
            v = (int(top.sum()) + int(left.sum()) + size) >> (shift + 1)
        elif mb_y > 0:
            v = (int(top.sum()) + (size >> 1)) >> shift
        elif mb_x > 0:
            v = (int(left.sum()) + (size >> 1)) >> shift
        else:
            v = 128
        return np.full((size, size), v, np.int64)
    if mode == TM_PRED:
        return np.clip(top[None, :].astype(np.int64) + left[:, None] - tl, 0, 255)
    if mode == V_PRED:
        return np.repeat(top[None, :].astype(np.int64), size, 0)
    return np.repeat(left[:, None].astype(np.int64), size, 1)


def _filter_params(level: int, sharpness: int):
    ilevel = level
    if sharpness > 0:
        ilevel >>= 2 if sharpness > 4 else 1
        ilevel = min(ilevel, 9 - sharpness)
    ilevel = max(ilevel, 1)
    return ilevel, 2 * level + ilevel, 2 if level >= 40 else 1 if level >= 15 else 0


def _sclip1(v):
    return np.clip(v, -128, 127)


def _edge(plane: np.ndarray, rows, cols, vertical_edge: bool, thresh: int, ithresh: int,
          hev_thresh: int, kind: str) -> None:
    """Filter one edge in place.  For a vertical edge (between columns
    cols - 1 and cols) `rows` is a slice of the rows it spans; for a
    horizontal edge (between rows rows - 1 and rows) `cols` the columns.
    kind: "simple", "mb" (6-tap at macroblock edges) or "inner" (4-tap)."""
    if vertical_edge:
        seg = plane[rows, cols - 4:cols + 4].astype(np.int64)          # [n, 8]
    else:
        seg = plane[rows - 4:rows + 4, cols].astype(np.int64).T        # [n, 8]
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[:, k] for k in range(8))
    t2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind != "simple":
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
            mask &= np.abs(a - b) <= ithresh
        hev = (np.abs(p1 - p0) > hev_thresh) | (np.abs(q1 - q0) > hev_thresh)
    else:
        hev = np.ones_like(mask)
    new = seg.copy()
    # DoFilter2 (simple, or hev)
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
    f2 = mask & hev
    new[:, 3] = np.where(f2, np.clip(p0 + a2, 0, 255), new[:, 3])
    new[:, 4] = np.where(f2, np.clip(q0 - a1, 0, 255), new[:, 4])
    if kind != "simple":
        f = mask & ~hev
        if kind == "mb":                                               # DoFilter6
            a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
            w1, w2, w3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
            for k, v in ((1, p2 + w3), (2, p1 + w2), (3, p0 + w1), (4, q0 - w1),
                         (5, q1 - w2), (6, q2 - w3)):
                new[:, k] = np.where(f, np.clip(v, 0, 255), new[:, k])
        else:                                                          # DoFilter4
            a = 3 * (q0 - p0)
            a1, a2 = np.clip((a + 4) >> 3, -16, 15), np.clip((a + 3) >> 3, -16, 15)
            a3 = (a1 + 1) >> 1
            for k, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
                new[:, k] = np.where(f, np.clip(v, 0, 255), new[:, k])
    if vertical_edge:
        plane[rows, cols - 4:cols + 4] = new
    else:
        plane[rows - 4:rows + 4, cols] = new.T


def decode_vp8(data: bytes, size: Optional[int] = None):
    """A VP8 key frame -> (Y [H, W], U, V [(H + 1) // 2, (W + 1) // 2])
    uint8, after the loop filter.  `data` runs to the end of the file, as
    libwebp reads it (its last token partition takes every byte left);
    `size` is the chunk's (default: all of `data`)."""
    size = len(data) if size is None else size
    if len(data) < 10:
        raise WebPError("VP8: truncated frame header")
    tag = data[0] | (data[1] << 8) | (data[2] << 16)
    if tag & 1:
        raise WebPError("VP8: not a key frame")
    if (tag >> 1) & 7 > 3 or not (tag >> 4) & 1:
        raise WebPError("VP8: a profile past 3 or a frame not shown (libwebp stops)")
    part0 = tag >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise WebPError("VP8: bad start code")
    width = (data[6] | (data[7] << 8)) & 0x3FFF
    height = (data[8] | (data[9] << 8)) & 0x3FFF
    if width == 0 or height == 0:
        raise WebPError("VP8: an empty frame")
    if part0 >= size or 10 + part0 > len(data):
        raise WebPError("VP8: the first partition is truncated")
    br = _BoolDecoder(data[10:10 + part0])
    get = lambda n=1: br.literal(n)
    get()                                   # colour space
    get()                                   # clamping type (the pixels are clamped anyway)
    use_segment = get()
    update_map, absolute = 0, 1
    seg_q, seg_f, seg_probs = [0] * 4, [0] * 4, [255, 255, 255]
    if use_segment:
        update_map = get()
        if get():
            absolute = get()
            seg_q = [br.maybe_signed(7) for _ in range(4)]
            seg_f = [br.maybe_signed(6) for _ in range(4)]
        if update_map:
            seg_probs = [get(8) if get() else 255 for _ in range(3)]
    if br.eof:
        raise WebPError("VP8: cannot parse the segment header (libwebp stops)")
    simple, level, sharpness = get(), get(6), get(3)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    use_lf_delta = get()
    if use_lf_delta and get():
        for d in (ref_delta, mode_delta):
            for i in range(4):
                if get():
                    d[i] = br.signed(6)
    if br.eof:
        raise WebPError("VP8: cannot parse the filter header (libwebp stops)")
    filter_type = 0 if level == 0 else 1 if simple else 2
    num_parts = 1 << get(2)
    rest = data[10 + part0:]
    if len(rest) < 3 * (num_parts - 1):
        raise WebPError("VP8: truncated partition sizes")
    start = 3 * (num_parts - 1)
    left_size = len(rest) - start
    parts = []
    for p in range(num_parts - 1):
        size = min(rest[3 * p] | (rest[3 * p + 1] << 8) | (rest[3 * p + 2] << 16), left_size)
        parts.append(_BoolDecoder(rest[start:start + size]))
        start += size
        left_size -= size
    if start >= len(rest):
        raise WebPError("VP8: the last token partition is empty (libwebp stops)")
    parts.append(_BoolDecoder(rest[start:]))
    base_q = get(7)
    dq_y1_dc, dq_y2_dc, dq_y2_ac, dq_uv_dc, dq_uv_ac = (br.maybe_signed(4) for _ in range(5))
    clip = lambda v, m: 0 if v < 0 else m if v > m else v
    quant = []
    for s in range(4):
        q = (seg_q[s] + (0 if absolute else base_q)) if use_segment else base_q
        y2_ac = (_AC_TABLE[clip(q + dq_y2_ac, 127)] * 101581) >> 16
        quant.append({"y1": (_DC_TABLE[clip(q + dq_y1_dc, 127)], _AC_TABLE[clip(q, 127)]),
                      "y2": (_DC_TABLE[clip(q + dq_y2_dc, 127)] * 2, max(y2_ac, 8)),
                      "uv": (_DC_TABLE[clip(q + dq_uv_dc, 117)],
                             _AC_TABLE[clip(q + dq_uv_ac, 127)])})
    get()                                   # refresh entropy probs: a key frame resets them
    proba = _COEFF_PROBA0.copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(int(_COEFF_UPDATE_PROBA[t, b, c, p])):
                        proba[t, b, c, p] = get(8)
    proba = proba.tolist()
    bands = [[proba[t][_BANDS[n]] for n in range(17)] for t in range(4)]
    use_skip = get()
    skip_p = get(8) if use_skip else 0
    # filter strengths per segment and per (i16, i4x4)
    fstrength = []
    for s in range(4):
        base = (seg_f[s] + (0 if absolute else level)) if use_segment else level
        row = []
        for i4 in (0, 1):
            lv = base
            if use_lf_delta:
                lv += ref_delta[0] + (mode_delta[0] if i4 else 0)
            lv = clip(lv, 63)
            row.append(_filter_params(lv, sharpness) if lv > 0 else None)
        fstrength.append(row)

    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    Y = np.zeros((mb_h * 16, mb_w * 16), np.uint8)
    U = np.zeros((mb_h * 8, mb_w * 8), np.uint8)
    V = np.zeros((mb_h * 8, mb_w * 8), np.uint8)
    intra_t = [0] * (4 * mb_w)
    nz_top = [[0] * 9 for _ in range(mb_w)]     # 4 y, 2 u, 2 v, dc
    filters = []                                # (mb_x, mb_y, params, inner)
    for mb_y in range(mb_h):
        intra_l = [0] * 4
        nz_left = [0] * 9
        tokens = parts[mb_y & (num_parts - 1)]
        for mb_x in range(mb_w):
            # --- modes (first partition)
            segment = 0
            if update_map:
                segment = (2 + br.bit(seg_probs[2])) if br.bit(seg_probs[0]) else \
                    br.bit(seg_probs[1])
            skip = br.bit(skip_p) if use_skip else 0
            is_i4 = not br.bit(145)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if not is_i4:
                ymode = ((TM_PRED if br.bit(128) else H_PRED) if br.bit(156)
                         else (V_PRED if br.bit(163) else DC_PRED))
                intra_t[4 * mb_x:4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
                imodes = None
            else:
                imodes = [0] * 16
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = _BMODES_PROBA[top[x]][ym]
                        i = _YMODES_INTRA4[br.bit(prob[0])]
                        while i > 0:
                            i = _YMODES_INTRA4[2 * i + br.bit(prob[i])]
                        ym = -i
                        top[x] = ym
                        imodes[4 * y + x] = ym
                    intra_l[y] = ym
                intra_t[4 * mb_x:4 * mb_x + 4] = top
            uvmode = (DC_PRED if not br.bit(142) else V_PRED if not br.bit(114)
                      else TM_PRED if br.bit(183) else H_PRED)
            # --- residuals (token partition)
            q = quant[segment]
            coeffs = [0] * 400                  # 16 y, 4 u, 4 v blocks, then y2
            tnz = nz_top[mb_x]
            nonzero = False
            if not skip:
                if not is_i4:
                    ctx = tnz[8] + nz_left[8]
                    nz = _coefficients(tokens, bands[1], ctx, q["y2"], 0, coeffs, 384)
                    tnz[8] = nz_left[8] = int(nz > 0)
                    dcs = _wht(coeffs[384:400])
                    for k in range(16):
                        coeffs[16 * k] = dcs[k]
                    nonzero = any(dcs)
                    first, ac = 1, bands[0]
                else:
                    first, ac = 0, bands[3]
                for y in range(4):
                    for x in range(4):
                        ctx = nz_left[y] + tnz[x]
                        nz = _coefficients(tokens, ac, ctx, q["y1"], first, coeffs,
                                           16 * (4 * y + x))
                        flag = int(nz > first)
                        nz_left[y] = tnz[x] = flag
                        nonzero = nonzero or flag
                for ch, base in ((0, 256), (2, 320)):
                    for y in range(2):
                        for x in range(2):
                            ctx = nz_left[4 + ch + y] + tnz[4 + ch + x]
                            nz = _coefficients(tokens, bands[2], ctx, q["uv"], 0, coeffs,
                                               base + 16 * (2 * y + x))
                            flag = int(nz > 0)
                            nz_left[4 + ch + y] = tnz[4 + ch + x] = flag
                            nonzero = nonzero or nz > 0
            else:
                for k in range(8):
                    tnz[k] = nz_left[k] = 0
                if not is_i4:
                    tnz[8] = nz_left[8] = 0
            if filter_type:
                params = fstrength[segment][int(is_i4)]
                filters.append((mb_x, mb_y, params, is_i4 or nonzero))
            # --- reconstruction (unfiltered neighbours)
            res = _idct(np.asarray(coeffs[:384], np.int64).reshape(24, 16))   # [24, 4, 4]
            _reconstruct(Y, U, V, mb_x, mb_y, mb_w, is_i4, imodes,
                         intra_t[4 * mb_x] if not is_i4 else None, uvmode, res)
    if br.eof or any(t.eof for t in parts):
        # libwebp checks the first partition after each row of modes and a
        # token partition after each macroblock; its flag never clears
        raise WebPError("VP8: a partition ends before its macroblocks (libwebp stops: premature "
                        "end of partition)")
    if filter_type:
        _loop_filter(Y, U, V, filters, filter_type)
    cw, ch = (width + 1) >> 1, (height + 1) >> 1
    return Y[:height, :width], U[:ch, :cw], V[:ch, :cw]


def _reconstruct(Y, U, V, mb_x, mb_y, mb_w, is_i4, imodes, ymode, uvmode, res) -> None:
    y0, x0 = 16 * mb_y, 16 * mb_x
    # the row above (127 on the first row) and the column on the left (129)
    if mb_y > 0:
        top = Y[y0 - 1, x0:x0 + 16].astype(np.int64)
        if mb_x < mb_w - 1:
            top_right = Y[y0 - 1, x0 + 16:x0 + 20].astype(np.int64)
        else:
            top_right = np.repeat(top[15], 4)
        tl = int(Y[y0 - 1, x0 - 1]) if mb_x > 0 else 129
    else:
        top = np.full(16, 127, np.int64)
        top_right = np.full(4, 127, np.int64)
        tl = 127
    left = Y[y0:y0 + 16, x0 - 1].astype(np.int64) if mb_x > 0 else np.full(16, 129, np.int64)
    if not is_i4:
        pred = _pred_block(ymode, top, left, tl, 16, mb_x, mb_y)
        r = res[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + r, 0, 255)
    else:
        # a 21-wide work area: column 0 the left samples, row 0 the samples above
        w = [[0] * 21 for _ in range(17)]
        w[0][0] = tl
        w[0][1:17] = top.tolist()
        w[0][17:21] = top_right.tolist()
        for j in range(16):
            w[j + 1][0] = int(left[j])
        tr = top_right.tolist()
        for j in (4, 8, 12):                    # the top-right replicated below
            w[j][17:21] = tr
        resl = res.tolist()
        for n in range(16):
            by, bx = n >> 2, n & 3
            r0, c0 = 4 * by + 1, 4 * bx + 1
            above = w[r0 - 1][c0:c0 + 8]
            lft = [w[r0 + k][c0 - 1] for k in range(4)]
            pred = _pred4(imodes[n], above, lft, w[r0 - 1][c0 - 1])
            rb = resl[n]
            for k in range(4):
                row = w[r0 + k]
                rr = rb[k]
                for m in range(4):
                    v = pred[4 * k + m] + rr[m]
                    row[c0 + m] = 0 if v < 0 else 255 if v > 255 else v
        Y[y0:y0 + 16, x0:x0 + 16] = np.asarray([row[1:17] for row in w[1:17]], np.uint8)
    c0, r0 = 8 * mb_x, 8 * mb_y
    for plane, blocks in ((U, res[16:20]), (V, res[20:24])):
        if mb_y > 0:
            top = plane[r0 - 1, c0:c0 + 8].astype(np.int64)
            tl = int(plane[r0 - 1, c0 - 1]) if mb_x > 0 else 129
        else:
            top, tl = np.full(8, 127, np.int64), 127
        left = plane[r0:r0 + 8, c0 - 1].astype(np.int64) if mb_x > 0 else \
            np.full(8, 129, np.int64)
        pred = _pred_block(uvmode, top, left, tl, 8, mb_x, mb_y)
        r = blocks.reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
        plane[r0:r0 + 8, c0:c0 + 8] = np.clip(pred + r, 0, 255)


def _loop_filter(Y, U, V, filters, filter_type) -> None:
    for mb_x, mb_y, params, inner in filters:
        if params is None:
            continue
        ilevel, limit, hev_t = params
        y0, x0 = 16 * mb_y, 16 * mb_x
        rows, cols = slice(y0, y0 + 16), slice(x0, x0 + 16)
        if filter_type == 1:
            if mb_x > 0:
                _edge(Y, rows, x0, True, limit + 4, 0, 0, "simple")
            if inner:
                for k in (4, 8, 12):
                    _edge(Y, rows, x0 + k, True, limit, 0, 0, "simple")
            if mb_y > 0:
                _edge(Y, y0, cols, False, limit + 4, 0, 0, "simple")
            if inner:
                for k in (4, 8, 12):
                    _edge(Y, y0 + k, cols, False, limit, 0, 0, "simple")
            continue
        u0, v0 = 8 * mb_y, 8 * mb_x
        urows, ucols = slice(u0, u0 + 8), slice(v0, v0 + 8)
        if mb_x > 0:
            _edge(Y, rows, x0, True, limit + 4, ilevel, hev_t, "mb")
            for P in (U, V):
                _edge(P, urows, v0, True, limit + 4, ilevel, hev_t, "mb")
        if inner:
            for k in (4, 8, 12):
                _edge(Y, rows, x0 + k, True, limit, ilevel, hev_t, "inner")
            for P in (U, V):
                _edge(P, urows, v0 + 4, True, limit, ilevel, hev_t, "inner")
        if mb_y > 0:
            _edge(Y, y0, cols, False, limit + 4, ilevel, hev_t, "mb")
            for P in (U, V):
                _edge(P, u0, ucols, False, limit + 4, ilevel, hev_t, "mb")
        if inner:
            for k in (4, 8, 12):
                _edge(Y, y0 + k, cols, False, limit, ilevel, hev_t, "inner")
            for P in (U, V):
                _edge(P, u0 + 4, ucols, False, limit, ilevel, hev_t, "inner")


def _upsample(C: np.ndarray, height: int, width: int) -> np.ndarray:
    """libwebp's fancy upsampler: chroma [ch, cw] -> [height, width]."""
    def near_far(n: int, m: int):
        i = np.arange(n)
        near = i >> 1
        far = np.where(i & 1, (i + 1) >> 1, (i >> 1) - 1)
        return near, np.clip(far, 0, m - 1)
    rn, rf = near_far(height, C.shape[0])
    cn, cf = near_far(width, C.shape[1])
    c = C.astype(np.int64)
    a, b = c[rn][:, cn], c[rn][:, cf]
    cc, d = c[rf][:, cn], c[rf][:, cf]
    return ((((a + 3 * b + 3 * cc + d + 8) >> 3) + a) >> 1)


def yuv_to_rgb(Y: np.ndarray, U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """libwebp's default conversion: fancy upsampling, then VP8YUVToR/G/B
    (14-bit fixed point) -> uint8 RGB [H, W, 3]."""
    H, W = Y.shape
    y = Y.astype(np.int64)
    u, v = _upsample(U, H, W), _upsample(V, H, W)
    hi = lambda x, k: (x * k) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))
    r = clip8(hi(y, 19077) + hi(v, 26149) - 14234)
    g = clip8(hi(y, 19077) - hi(u, 6419) - hi(v, 13320) + 8708)
    b = clip8(hi(y, 19077) + hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# ALPH
# ---------------------------------------------------------------------------

def decode_alpha(data: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk's payload -> the alpha plane uint8 [height, width]."""
    if not data:
        raise WebPError("ALPH: empty")
    method, filt = data[0] & 3, (data[0] >> 2) & 3
    if method == 0:
        if len(data) - 1 < width * height:
            raise WebPError("ALPH: the raw plane is truncated")
        a = np.frombuffer(data[1:1 + width * height], np.uint8).reshape(height, width)
    elif method == 1:
        a = ((_stream_in_data(_Bits(data, 1), width, height) >> 8) & 0xFF).astype(np.uint8)
    else:
        raise WebPError(f"ALPH: compression method {method}")
    if filt == 0:
        return a.copy()
    a = a.astype(np.int64)
    out = np.zeros_like(a)
    out[0] = np.cumsum(a[0]) & 0xFF                        # the first row: from the left
    if filt == 1:                                           # horizontal
        for y in range(1, height):
            row = a[y].copy()
            row[0] += out[y - 1, 0]
            out[y] = np.cumsum(row) & 0xFF
    elif filt == 2:                                         # vertical
        out[1:] = (np.cumsum(a[1:], axis=0) + out[0]) & 0xFF
    else:                                                   # gradient
        prev = out[0].tolist()
        rows = a.tolist()
        for y in range(1, height):
            cur = [0] * width
            left = top_left = prev[0]
            row = rows[y]
            for x in range(width):
                top = prev[x]
                g = left + top - top_left
                g = 0 if g < 0 else 255 if g > 255 else g
                left = (row[x] + g) & 0xFF
                top_left = top
                cur[x] = left
            out[y] = cur
            prev = cur
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------

def _chunks(data: bytes, pos: int, end: int):
    """(tag, body, the bytes from the body to the end of `data`) of each
    chunk from pos to end: libwebp hands an image's decoder all the bytes
    after the chunk's header, so a decoder that reads past its chunk reads
    the padding byte and whatever follows."""
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        if pos + 8 + size > end:
            raise WebPError(f"WebP: the {tag!r} chunk runs past the file")
        yield tag, data[pos + 8:pos + 8 + size], data[pos + 8:]
        pos += 8 + size + (size & 1)


def _frame(chunks, use_alpha: bool) -> np.ndarray:
    """An image's chunks (ALPH + VP8, or VP8L) -> uint8 RGBA [h, w, 4]; a
    VP8 frame's alpha is its ALPH plane where `use_alpha`, else 255."""
    alph = next((body for tag, body, _ in chunks if tag == b"ALPH"), None)
    for tag, body, tail in chunks:
        if tag == b"VP8L":
            argb = decode_vp8l(tail)
            return np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF, argb & 0xFF,
                             argb >> 24], -1).astype(np.uint8)
        if tag == b"VP8 ":
            Y, U, V = decode_vp8(tail, len(body))
            rgb = yuv_to_rgb(Y, U, V)
            h, w = Y.shape
            if alph is not None and use_alpha:
                a = decode_alpha(alph, w, h)
            else:
                a = np.full((h, w), 255, np.uint8)
            return np.concatenate([rgb, a[..., None]], -1)
    raise WebPError("WebP: no image chunk")


def decode_webp(data: bytes) -> np.ndarray:
    """A WebP file -> what cv2.imread(IMREAD_UNCHANGED) returns, in RGB(A)
    order: uint8 [H, W, 4] where the file's features say it has alpha, else
    [H, W, 3]."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise WebPError("not a WebP file")
    riff = int.from_bytes(data[4:8], "little")
    if riff < 12 or riff > len(data) - 8:
        raise WebPError("WebP: a RIFF size past the end of the file or too small for a chunk "
                        "(libwebp stops)")
    end = 8 + riff
    tag = data[12:16]
    if tag in (b"VP8 ", b"VP8L"):
        # a simple file: libwebp's ParseVP8Header checks the chunk's size
        # against the RIFF size and the file and reads no chunk after it
        size = int.from_bytes(data[16:20], "little")
        if size > riff - 12 or size > len(data) - 20:
            raise WebPError(f"WebP: the {tag!r} chunk runs past the RIFF size or the file "
                            f"(libwebp stops)")
        chunks = [(tag, data[20:20 + size], data[20:])]
        if tag == b"VP8 ":
            return _frame(chunks, False)[..., :3]
        alpha = _vp8l_header(chunks[0][1])[2]
        rgba = _frame(chunks, True)
        return rgba if alpha else rgba[..., :3]
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise WebPError("WebP: no chunks")
    tag, body, _ = chunks[0]
    if tag != b"VP8X" or len(body) < 10:
        raise WebPError(f"WebP: first chunk {tag!r}")
    flags = body[0]
    alpha, animated = bool(flags & 0x10), bool(flags & 0x02)
    cw = int.from_bytes(body[4:7], "little") + 1
    chh = int.from_bytes(body[7:10], "little") + 1
    if animated:
        frame = next((b for t, b, _ in chunks if t == b"ANMF"), None)
        if frame is None or len(frame) < 16:
            raise WebPError("WebP: an animation without frames")
        fx = 2 * int.from_bytes(frame[0:3], "little")
        fy = 2 * int.from_bytes(frame[3:6], "little")
        img = _frame(list(_chunks(frame, 16, len(frame))), True)
        canvas = np.zeros((chh, cw, 4), np.uint8)
        h, w = img.shape[:2]
        if fx + w > cw or fy + h > chh:
            raise WebPError("WebP: a frame outside the canvas")
        canvas[fy:fy + h, fx:fx + w] = img
    else:
        image = [c for c in chunks[1:] if c[0] in (b"ALPH", b"VP8 ", b"VP8L")]
        canvas = _frame(image, alpha)
        if canvas.shape[:2] != (chh, cw):
            raise WebPError("WebP: the image's size differs from the canvas's")
    return canvas if alpha else canvas[..., :3]
