"""JPEG 2000 on numpy: what cv2.imread(IMREAD_UNCHANGED) gives for a .jp2
file or a raw J2K codestream (OpenCV decodes both through OpenJPEG), bit for
bit, with the channels in RGB(A) order.

    decode_jp2(data) -> uint8 / uint16, [H, W] (1 component), [H, W, 3] or
                        [H, W, 4]

The codestream (ISO/IEC 15444-1): the main header (SIZ, COD, COC, QCD,
QCC, RGN, POC, PPM, CRG, COM, TLM, PLM), tile-parts in any order with their
headers (SOT, COD, COC, QCD, QCC, RGN, POC, PPT, PLT, COM), SOP and EPH
markers where COD asks for them.  Tier 2: tag trees, packet headers (from
the tile's data, or from the PPM markers' run, one for every tile, or the
tile's PPT markers, each joined in Z order as OpenJPEG merges them) with
the bit stuffing after 0xFF, code-block inclusion, zero bit-planes, pass
counts, the passes split into codeword segments as the code-block style
asks (opj_t2_init_seg) with a length each, precinct partitions (COD's PPx
/ PPy, else 2^15) with code-blocks clipped to them, the five progression
orders over components whose resolution counts differ, or the POC entries
(a tile-part's added to the main header's) each over its ranges with the
packets an earlier one took skipped, tiles whose grid does not divide the
image.  Tier 1 is `jp2_t1.py`: every code-block style but HT, and RGN's
max-shift.  Then OpenJPEG's reconstruction: reversible coefficients halved
toward zero; irreversible ones times half the step size in float32, the
step sizes derived or expounded with OpenJPEG's sub-band gain of 0 (its
9/7 synthesis scales the high-pass band by 2 / K to match); the inverse 5/3
in integer lifting and the inverse 9/7 in float32 with OpenJPEG 2.5's
constants, in its order, up to the highest resolution a packet of the
component was read at (a lower one lands at its own smaller coordinates,
as opj_j2k_update_image_data copies it); the inverse RCT or ICT; the DC
level shift (the 9/7 path rounds to nearest even first), and the clip to
[0, 2^prec - 1].

The JP2 boxes, read and checked as OpenJPEG's opj_jp2_read_header_procedure
reads them: the signature box first, `ftyp` second (a multiple of 4 bytes),
`jp2h` before `jp2c` with `ihdr` among its boxes (14 bytes, 1 to 16384
components, the size SIZ gives where it gives one), `colr`, `cdef`, `pclr`
and `cmap` as OpenJPEG takes them (a `cmap` with no `pclr` before it
refused), other boxes skipped; `jp2c`'s length is not read, its codestream
runs to the end of the file.  After decoding, opj_jp2_check_color's checks,
the palette (a `pclr` without `cmap` dropped) and `cdef`.  The main header
as opj_j2k_read_header_procedure reads it: SIZ first, an unknown marker
skipped two bytes at a time, a known one out of place refused, SIZ, COD,
COC, QCD, QCC, RGN, POC, PPM, CRG and the other markers' fields checked as
OpenJPEG checks them, COD and QCD required; a quantization style above 2
is read as expounded, a sub-band with no step size gets OpenJPEG's zeroed
one.  Then OpenCV's checks and its size limits (io.check_size), before any
tile-part is read.  In tier 2 a packet header past its tile's data reads
as 0 bits (empty packets, as OpenJPEG's opj_bio reads them), SOP and EPH
markers are taken where present, and a tile the codestream lacks is left
at 0.

OpenCV's output (_opencv_channels): as many channels as the codestream has
components (1, 3 or 4), converted from OpenJPEG's components after the
palette by the `colr` space: sRGB (and an unknown space, an ICC profile or
a raw codestream), gray, or sYCC through cvtColor's YUV2BGR; a largest
precision of 8 bits gives uint8 and of 9-16 bits uint16, the values as
decoded (no scaling).  Where OpenCV gives no image this raises JP2NoImage
naming the variant: two components, signed samples, an image offset other
than 0, sub-sampled components, a precision below 8 or above 16 bits, the
CMYK and e-YCC colour spaces, components the space cannot convert into the
channels, a header OpenJPEG refuses (a Part 2 component transform in COD
among them).  A truncated codestream (a cut file, a missing EOC), a
marker segment too short for its fields or a missing marker raises
JP2NoImage: OpenCV gives no image for them.  What no writer here makes
raises a JP2Error naming it: HT code-blocks (code-block style 0x40) and
the HTJ2K CAP / CPF markers, the Part 2 MCT / MCC / MCO / CBD markers in a
file whose COD takes no Part 2 transform, and a 3-column palette over 4
components (OpenCV reads a fourth channel past the end of OpenJPEG's
array).
"""
from __future__ import annotations

import struct

import numpy as np

from iron_tpu_torch.data.io import NoImage, check_size
from iron_tpu_torch.data.jp2_t1 import decode_block

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SOC_SIZ = b"\xff\x4f\xff\x51"

# markers; any other (TLM, PLM, PLT, COM...) is skipped by its length
_SOT, _SOD, _COD, _COC, _QCD, _QCC = 0xFF90, 0xFF93, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D
_RGN, _POC, _PPM, _PPT = 0xFF5E, 0xFF5F, 0xFF60, 0xFF61
_REFUSED = {0xFF50: "CAP (HTJ2K capabilities)",
            0xFF59: "CPF (corresponding profile)", 0xFF74: "MCT (Part 2 transform)",
            0xFF75: "MCC (Part 2 transform)", 0xFF77: "MCO (Part 2 transform)",
            0xFF78: "CBD (Part 2 component depths)"}
# the markers OpenJPEG 2.5 knows (j2k_memory_marker_handler_tab) -> where it
# takes them: "M" the main header, "T" a tile-part header, "S" only as the
# main header's first; any other is skipped two bytes at a time
_KNOWN = {0xFF90: "MT", 0xFF52: "MT", 0xFF53: "MT", 0xFF5E: "MT", 0xFF5C: "MT", 0xFF5D: "MT",
          0xFF5F: "MT", 0xFF51: "S", 0xFF55: "M", 0xFF57: "M", 0xFF58: "T", 0xFF60: "M",
          0xFF61: "T", 0xFF91: "", 0xFF63: "M", 0xFF64: "MT", 0xFF74: "MT", 0xFF78: "M",
          0xFF50: "M", 0xFF59: "M", 0xFF75: "MT", 0xFF77: "MT"}
_PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
_CBLK_STYLES = ((0x01, "BYPASS"), (0x02, "RESET"), (0x04, "TERMALL"), (0x08, "VSC"),
                (0x10, "PTERM"), (0x20, "SEGSYM"), (0x40, "HT"))

# OpenJPEG 2.5's 9/7 synthesis (dwt.c): the lifting constants of Table F.4,
# K for the low-pass band and 2 / K (its "two_invK") for the high-pass one
_ALPHA = np.float32(-1.586134342)
_BETA = np.float32(-0.052980118)
_GAMMA = np.float32(0.882911075)
_DELTA = np.float32(0.443506852)
_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)


class JP2Error(ValueError):
    """A JPEG 2000 file the port (or OpenCV) does not decode."""


class JP2NoImage(JP2Error, NoImage):
    """A JPEG 2000 file OpenCV gives no image for."""


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# the codestream's headers
# ---------------------------------------------------------------------------

class _Reader:
    """Big-endian fields of a marker segment."""

    def __init__(self, body: bytes, name: str):
        self.body, self.pos, self.name = body, 0, name

    def take(self, fmt: str):
        n = struct.calcsize(">" + fmt)
        if self.pos + n > len(self.body):
            raise JP2NoImage(f"JPEG 2000: the {self.name} marker segment is too short")
        out = struct.unpack_from(">" + fmt, self.body, self.pos)
        self.pos += n
        return out if len(out) > 1 else out[0]


def _coding_style(r: _Reader, with_precincts: bool) -> dict:
    """SPcod / SPcoc: decomposition levels, code-block size and style, the
    wavelet, the precinct sizes (PPx, PPy) of each resolution; checked as
    OpenJPEG's opj_j2k_read_SPCod_SPCoc checks them (no image where it
    fails)."""
    levels, xcb, ycb, style, wavelet = r.take("BBBBB")
    if levels > 32 or xcb > 8 or ycb > 8 or xcb + ycb > 8:
        raise JP2NoImage(f"JPEG 2000: {levels} decomposition levels and code-blocks of "
                         f"2^{xcb + 2} x 2^{ycb + 2} are not a valid {r.name} (OpenJPEG stops)")
    if style & 0x80:
        raise JP2NoImage("JPEG 2000: mixed HT code-blocks (OpenJPEG does not decode them)")
    if wavelet > 1:
        raise JP2NoImage(f"JPEG 2000: wavelet transform {wavelet} (OpenJPEG stops)")
    if with_precincts:
        pp = [r.take("B") for _ in range(levels + 1)]
        if any(not (b & 15 and b >> 4) for b in pp[1:]):
            raise JP2NoImage("JPEG 2000: a precinct of size 1 at a resolution above 0 (OpenJPEG "
                             "stops)")
        precincts = [(b & 15, b >> 4) for b in pp]
    else:
        precincts = [(15, 15)] * (levels + 1)
    if style & 0x40:
        names = [n for bit, n in _CBLK_STYLES if style & bit]
        raise JP2Error(f"JPEG 2000: code-block style {' + '.join(names)}: the port does not "
                       f"decode HT (HTJ2K) code-blocks")
    return {"levels": levels, "cbw": xcb + 2, "cbh": ycb + 2, "reversible": wavelet == 1,
            "precincts": precincts, "style": style}


def _quantization(r: _Reader) -> dict:
    """SQcd / SPqcd (or SQcc / SPqcc): guard bits and the (exponent,
    mantissa) of each sub-band, derived ones as OpenJPEG derives them
    (opj_j2k_read_SQcd_SQcc: a style above 2 is read as expounded), the
    segment's bytes all taken."""
    sq = r.take("B")
    style, guard = sq & 31, sq >> 5
    left = len(r.body) - r.pos
    if style == 0:
        steps = [(r.take("B") >> 3, 0) for _ in range(left)]
    else:
        steps = [(v >> 11, v & 0x7FF) for v in (r.take("H") for _ in range(
            1 if style == 1 else left // 2))]
    if r.pos != len(r.body):
        raise JP2NoImage(f"JPEG 2000: the {r.name} marker segment has bytes its quantization "
                         f"does not take (OpenJPEG stops)")
    if not steps:
        raise JP2Error(f"JPEG 2000: the {r.name} marker segment has no step sizes")
    if style == 1:
        e0, m0 = steps[0]
        steps = [(e0, m0)] + [(max(e0 - (b - 1) // 3, 0), m0) for b in range(1, 97)]
    return {"guard": guard, "steps": steps}


def _component_index(r: _Reader, ncomps: int) -> int:
    c = r.take("B" if ncomps < 257 else "H")
    if c >= ncomps:
        raise JP2NoImage(f"JPEG 2000: {r.name} names component {c} of {ncomps} (OpenJPEG stops)")
    return c


class _Params:
    """The coding and quantization parameters in force: COD / QCD, the
    per-component COC / QCC and RGN shifts, and the POC entries, of the main
    header or of a tile's (a tile starts from the main header's, and its
    POCs are added to the main header's, as OpenJPEG's opj_j2k_read_poc
    adds them)."""

    def __init__(self, base: "_Params | None" = None):
        self.cod = base.cod if base else None
        self.coc = dict(base.coc) if base else {}
        self.qcd = base.qcd if base else None
        self.qcc = dict(base.qcc) if base else {}
        self.rgn = dict(base.rgn) if base else {}
        self.pocs = list(base.pocs) if base else []

    def read(self, marker: int, body: bytes, ncomps: int, name: str) -> None:
        r = _Reader(body, name)
        room = "B" if ncomps <= 256 else "H"
        if marker == _RGN:                  # opj_j2k_read_rgn: Srgn is not read
            c = r.take(room)
            if len(body) != r.pos + 2 or c >= ncomps:
                raise JP2NoImage("JPEG 2000: an RGN marker segment OpenJPEG does not take (it "
                                 "stops; no image)")
            self.rgn[c] = body[-1]
        elif marker == _POC:                # opj_j2k_read_poc
            size = 5 + 2 * struct.calcsize(">" + room)
            if not body or len(body) % size or len(self.pocs) + len(body) // size >= 32:
                raise JP2NoImage("JPEG 2000: a POC marker segment OpenJPEG does not take (it "
                                 "stops; no image)")
            layers = self.cod["layers"] if self.cod else 0
            for _ in range(len(body) // size):
                r0, c0, l1, r1, c1, prg = r.take("B" + room + "HB" + room + "B")
                self.pocs.append((r0, c0, min(l1, layers), r1, min(c1, ncomps), prg))
        elif marker == _COD:
            scod, prog, layers, mct = r.take("BBHB")
            if scod & ~7 or layers == 0 or mct > 1:
                raise JP2NoImage(f"JPEG 2000: a COD of style {scod}, {layers} layers, component "
                                 f"transform {mct} (OpenJPEG stops)")
            if prog > 4:
                raise JP2NoImage(f"JPEG 2000: progression order {prog} (OpenJPEG decodes no "
                                 f"packet of it)")
            cod = _coding_style(r, bool(scod & 1))
            if r.pos != len(r.body):
                raise JP2NoImage("JPEG 2000: a COD longer than its fields (OpenJPEG stops)")
            self.cod = {"sop": bool(scod & 2), "eph": bool(scod & 4), "order": prog,
                        "layers": layers, "mct": mct, **cod}
            self.coc = {}               # a tile's COD overrides the main header's COCs
        elif marker == _COC:
            c = _component_index(r, ncomps)
            self.coc[c] = _coding_style(r, bool(r.take("B") & 1))
            if r.pos != len(r.body):
                raise JP2NoImage("JPEG 2000: a COC longer than its fields (OpenJPEG stops)")
        elif marker == _QCD:
            self.qcd = _quantization(r)
            self.qcc = {}
        else:
            c = _component_index(r, ncomps)
            self.qcc[c] = _quantization(r)

    def component(self, c: int) -> dict:
        if self.cod is None or self.qcd is None:
            raise JP2Error("JPEG 2000: a codestream without COD or QCD")
        return {**self.cod, **self.coc.get(c, {}), **self.qcc.get(c, self.qcd),
                "roishift": self.rgn.get(c, 0)}


def _segments(cs: bytes, pos: int, end: int):
    """(marker, body, position after) of the marker segments from pos up to
    SOT / SOD."""
    while True:
        if pos + 2 > end:
            raise JP2NoImage("JPEG 2000: truncated codestream (a header runs past the end)")
        marker = struct.unpack_from(">H", cs, pos)[0]
        if marker in (_SOT, _SOD):
            yield marker, b"", pos
            return
        if marker >> 8 != 0xFF or pos + 4 > end:
            raise JP2NoImage(f"JPEG 2000: expected a marker at byte {pos}, found "
                             f"0x{marker:04x}")
        n = struct.unpack_from(">H", cs, pos + 2)[0]
        if n < 2 or pos + 2 + n > end:
            raise JP2NoImage(f"JPEG 2000: truncated codestream (marker 0x{marker:04x} at byte "
                             f"{pos} runs past the end)")
        yield marker, cs[pos + 4:pos + 2 + n], pos + 2 + n
        pos += 2 + n


def _check_marker(marker: int, where: str) -> None:
    if marker in _REFUSED:
        raise JP2Error(f"JPEG 2000: {_REFUSED[marker]} marker in the {where}: the port does "
                       f"not decode it")


def _merge_ppm(ppm: dict) -> bytes:
    """The packet headers of the PPM segments (opj_j2k_merge_ppm): the
    segments in Zppm order, each a run of (Nppm, Nppm bytes) whose runs may
    cross into the next segment, joined without their Nppm fields."""
    out, left = [], 0
    for z in sorted(ppm):
        data = ppm[z]
        take = min(left, len(data))
        out.append(data[:take])
        left -= take
        data = data[take:]
        while data:
            if len(data) < 4:
                raise JP2NoImage("JPEG 2000: a PPM marker segment without room for its Nppm "
                                 "(OpenJPEG stops; no image)")
            n = struct.unpack_from(">I", data)[0]
            out.append(data[4:4 + n])
            left = max(0, n - (len(data) - 4))
            data = data[4 + n:]
    if left:
        raise JP2NoImage("JPEG 2000: corrupted PPM markers (OpenJPEG stops; no image)")
    return b"".join(out)


def _siz(body: bytes) -> dict:
    """The SIZ segment, checked as OpenJPEG's opj_j2k_read_siz checks it (no
    image where it fails)."""
    if len(body) < 36 or (len(body) - 36) % 3 or (len(body) - 36) // 3 > 16384:
        raise JP2NoImage(f"JPEG 2000: a SIZ segment of {len(body) + 2} bytes (OpenJPEG stops)")
    r = _Reader(body, "SIZ")
    _, X1, Y1, X0, Y0, TW, TH, TX0, TY0, C = r.take("HIIIIIIIIH")     # Rsiz unread
    comps = [r.take("BBB") for _ in range(C)]
    if C == 0 or C > 16384 or C != (len(body) - 36) // 3 or X0 >= X1 or Y0 >= Y1 or not TW \
            or not TH or TX0 > X0 or TY0 > Y0 or min(TX0 + TW, 2 ** 32 - 1) <= X0 \
            or min(TY0 + TH, 2 ** 32 - 1) <= Y0:
        raise JP2NoImage(f"JPEG 2000: SIZ with image [{X0}, {X1}) x [{Y0}, {Y1}), tiles "
                         f"{TW} x {TH} at ({TX0}, {TY0}) and {C} components (OpenJPEG stops)")
    info = {"X0": X0, "Y0": Y0, "X1": X1, "Y1": Y1, "TW": TW, "TH": TH, "TX0": TX0,
            "TY0": TY0, "prec": [(s & 0x7F) + 1 for s, _, _ in comps],
            "signed": [bool(s & 0x80) for s, _, _ in comps],
            "sub": [(dx, dy) for _, dx, dy in comps]}
    if any(dx == 0 or dy == 0 for dx, dy in info["sub"]) or max(info["prec"]) > 31:
        raise JP2NoImage(f"JPEG 2000: SIZ with components of {info['prec']} bits and "
                         f"sub-sampling {info['sub']} (OpenJPEG stops)")
    ntx, nty = _ceildiv(X1 - TX0, TW), _ceildiv(Y1 - TY0, TH)
    if ntx * nty > 65535:
        raise JP2NoImage(f"JPEG 2000: {ntx} x {nty} tiles (OpenJPEG takes at most 65535)")
    return info


def _marker_check(marker: int, body: bytes, ncomps: int) -> None:
    """The size checks OpenJPEG's readers of the other main-header markers
    make (no image where one fails), then the features the port does not
    decode (a JP2Error naming them)."""
    room = 1 if ncomps <= 256 else 2
    bad = {0xFF60: len(body) < 2, 0xFF63: len(body) != 4 * ncomps,
           0xFF55: len(body) < 2, 0xFF57: len(body) < 1}.get(marker, False)
    if bad:
        name = {0xFF60: "PPM", 0xFF63: "CRG", 0xFF55: "TLM", 0xFF57: "PLM"}[marker]
        raise JP2NoImage(f"JPEG 2000: a {name} marker segment OpenJPEG does not take (it "
                         f"stops; no image)")
    if marker in _REFUSED:
        raise JP2Error(f"JPEG 2000: {_REFUSED[marker]} marker in the main header: the port does "
                       f"not decode it")


def _main_header(cs: bytes):
    """The main header as OpenJPEG's opj_j2k_read_header_procedure reads it:
    SOC, SIZ first, then marker segments to the first SOT; an unknown marker
    is skipped two bytes at a time to the next known one, a known one out of
    place, a length under 2 or a segment past the end gives no image; SIZ,
    COD and QCD are required.  -> (the image and tile geometry with the
    parameters in force, the first SOT's position)."""
    if cs[:4] != J2K_SOC_SIZ:
        raise JP2NoImage("JPEG 2000: the codestream does not start with SOC and SIZ (OpenJPEG "
                         "stops)")
    info, main, seen, ppm = None, _Params(), set(), {}
    pos = 2
    while True:
        if pos + 2 > len(cs):
            raise JP2NoImage("JPEG 2000: truncated codestream (the main header runs past the "
                             "end)")
        marker = struct.unpack_from(">H", cs, pos)[0]
        pos += 2
        if marker not in _KNOWN:                     # opj_j2k_read_unk
            if marker < 0xFF00:
                raise JP2NoImage(f"JPEG 2000: a marker expected at byte {pos - 2}, found "
                                 f"0x{marker:04x} (OpenJPEG stops)")
            while marker not in _KNOWN:
                if pos + 2 > len(cs):
                    raise JP2NoImage("JPEG 2000: truncated codestream (the main header runs "
                                     "past the end)")
                marker = struct.unpack_from(">H", cs, pos)[0]
                pos += 2
        if marker == _SOT:
            if info is None:
                raise JP2NoImage("JPEG 2000: SOT before SIZ (OpenJPEG stops)")
            break
        if ("S" if info is None else "M") not in _KNOWN[marker]:
            raise JP2NoImage(f"JPEG 2000: marker 0x{marker:04x} out of place in the main header "
                             f"(OpenJPEG stops)")
        if pos + 2 > len(cs):
            raise JP2NoImage("JPEG 2000: truncated codestream (the main header runs past the end)")
        n = struct.unpack_from(">H", cs, pos)[0]
        if n < 2 or pos + n > len(cs):
            raise JP2NoImage(f"JPEG 2000: truncated codestream (marker 0x{marker:04x} at byte "
                             f"{pos - 2} runs past the end)")
        body = cs[pos + 2:pos + n]
        pos += n
        seen.add(marker)
        if marker == 0xFF51:
            info = _siz(body)
            continue
        C = len(info["prec"])
        if marker in (_COD, _COC, _QCD, _QCC, _RGN, _POC):
            main.read(marker, body, C, "main header's marker")
        else:
            _marker_check(marker, body, C)
            if marker == _PPM:          # opj_j2k_read_ppm
                if body[0] in ppm:
                    raise JP2NoImage(f"JPEG 2000: Zppm {body[0]} read twice (OpenJPEG stops; "
                                     f"no image)")
                ppm[body[0]] = body[1:]
    if not {_COD, _QCD} <= seen:
        raise JP2NoImage("JPEG 2000: a main header without COD or QCD (OpenJPEG stops)")
    info["main"] = main
    info["ppm"] = _merge_ppm(ppm) if ppm else None
    return info, pos - 2


def parse_codestream(cs: bytes) -> dict:
    """The image and tile geometry, the parameters in force and each tile's
    data (its tile-parts' bytes, joined in order) of a J2K codestream."""
    info, pos = _main_header(cs)
    return _tile_parts(cs, info, pos)


def _tile_parts(cs: bytes, info: dict, pos: int) -> dict:
    """The tile-parts from the first SOT at `pos`: each tile's parameters
    and data (their bytes, joined in order) -> info["tiles"]."""
    X1, Y1, TW, TH, TX0, TY0 = (info[k] for k in ("X1", "Y1", "TW", "TH", "TX0", "TY0"))
    C, main = len(info["prec"]), info["main"]
    ntx, nty = _ceildiv(X1 - TX0, TW), _ceildiv(Y1 - TY0, TH)
    info.update(ntx=ntx, nty=nty)
    tiles, ppt = {}, {}
    while pos + 2 <= len(cs) and struct.unpack_from(">H", cs, pos)[0] == _SOT:
        if pos + 12 > len(cs):
            raise JP2NoImage("JPEG 2000: truncated codestream (in an SOT marker)")
        isot, psot, tpsot, _ = struct.unpack_from(">HIBB", cs, pos + 4)
        if isot >= ntx * nty:
            raise JP2Error(f"JPEG 2000: SOT names tile {isot} of {ntx * nty}")
        start = pos
        end = start + psot if psot else len(cs) - (2 if cs[-2:] == b"\xff\xd9" else 0)
        if end > len(cs):
            raise JP2NoImage(f"JPEG 2000: truncated codestream (tile {isot}'s part {tpsot} "
                             f"ends at byte {end} of {len(cs)})")
        tile = tiles.setdefault(isot, {"params": _Params(main), "data": []})
        for marker, body, p in _segments(cs, pos + 12, end):
            if marker == _SOD:
                pos = p + 2
                break
            if marker == _SOT:
                raise JP2Error("JPEG 2000: SOT inside a tile-part header")
            _check_marker(marker, "tile-part header")
            if marker in (_COD, _COC, _QCD, _QCC, _RGN, _POC):
                tile["params"].read(marker, body, C, f"tile {isot}'s marker")
            elif marker == _PPM:
                raise JP2NoImage("JPEG 2000: a PPM marker in a tile-part header (OpenJPEG "
                                 "stops; no image)")
            elif marker == _PPT:            # opj_j2k_read_ppt
                if len(body) < 2 or info["ppm"] is not None:
                    raise JP2NoImage("JPEG 2000: a PPT marker segment OpenJPEG does not take "
                                     "(it stops; no image)")
                zs = ppt.setdefault(isot, {})
                if body[0] in zs:
                    raise JP2NoImage(f"JPEG 2000: Zppt {body[0]} of tile {isot} read twice "
                                     f"(OpenJPEG stops; no image)")
                zs[body[0]] = body[1:]
        tile["data"].append(cs[pos:end])
        pos = end
    if cs[pos:pos + 2] != b"\xff\xd9":
        raise JP2NoImage(f"JPEG 2000: truncated codestream (no EOC marker after the last "
                         f"tile-part, at byte {pos} of {len(cs)})")
    if not tiles:
        raise JP2NoImage("JPEG 2000: a codestream without tiles (OpenCV returns no image)")
    # a tile the codestream lacks is left as OpenJPEG zeroes the image: 0
    info["tiles"] = {t: (v["params"], b"".join(v["data"])) for t, v in tiles.items()}
    # a tile's PPT segments, joined in Zppt order (opj_j2k_merge_ppt)
    info["ppt"] = {t: b"".join(zs[z] for z in sorted(zs)) for t, zs in ppt.items()}
    return info


# ---------------------------------------------------------------------------
# tier 2
# ---------------------------------------------------------------------------

class _Bits:
    """Packet-header bits, with the stuffed 0 bit after each 0xFF byte; 0
    bits past the end (opj_bio_bytein)."""

    def __init__(self, data: bytes, pos: int, end: int, where: str):
        self.data, self.pos, self.end, self.where = data, pos, end, where
        self.buf = self.ct = 0

    def _byte(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < self.end:
            self.buf |= self.data[self.pos]
            self.pos += 1
            return True
        return False

    def bit(self) -> int:
        if self.ct == 0:
            self._byte()                # past the tile's data, OpenJPEG's opj_bio reads 0 bits
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """The byte after the header."""
        if (self.buf & 0xFF) == 0xFF:
            self._byte()
        self.ct = 0
        return self.pos


class _TagTree:
    """A tag tree over w x h leaves (B.10.2), decoded as OpenJPEG's
    opj_tgt_decode does."""

    def __init__(self, w: int, h: int):
        parent, base = [], 0
        while w * h > 1:
            pw, ph = _ceildiv(w, 2), _ceildiv(h, 2)
            top = base + w * h
            parent += [top + (j // 2) * pw + i // 2 for j in range(h) for i in range(w)]
            base, w, h = top, pw, ph
        parent.append(-1)
        self.parent = parent
        self.value = [999] * len(parent)
        self.low = [0] * len(parent)

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> bool:
        path = [leaf]
        while self.parent[path[-1]] >= 0:
            path.append(self.parent[path[-1]])
        value, lows = self.value, self.low
        low = 0
        for node in reversed(path):
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bits.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
        return value[leaf] < threshold


class _Block:
    """A code-block: its extent, Lblock, bit-plane count and codeword
    segments, [chunks, passes, most passes] each."""
    __slots__ = ("x0", "y0", "x1", "y1", "lenbits", "numbps", "segs")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.lenbits, self.numbps, self.segs = 0, 0, []


def _max_passes(style: int, prev) -> int:
    """The most passes of a code-block's next codeword segment, after one of
    `prev` most passes (None: its first), as OpenJPEG's opj_t2_init_seg
    sets it: one under TERMALL; under BYPASS ten, then 2 (raw) and 1 (MQ
    cleanup) in turn; else 109."""
    if style & 0x04:
        return 1
    if style & 0x01:
        return 10 if prev is None else (2 if prev in (1, 10) else 1)
    return 109


def _passes(bits: _Bits) -> int:
    """The number of coding passes codeword (Table B.4)."""
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.bits(2)
    if n != 3:
        return 3 + n
    n = bits.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bits.bits(7)


def _read_packet(data: bytes, pos: int, end: int, bands, layer: int, cp: dict, where: str,
                 hdr=None) -> int:
    """Read one packet at `pos` into the precinct's code-blocks; returns the
    position after it.  Its header is read from `hdr` ([bytes, position],
    the PPM or PPT headers, advanced past it) where given, else from the
    tile's data; a code-block's new passes are split into codeword segments
    as OpenJPEG's opj_t2_read_packet_header splits them, each with its own
    length of Lblock + floor(log2(passes)) bits."""
    if cp["sop"] and data[pos:pos + 2] == b"\xff\x91" and end - pos >= 6:
        pos += 6
    src = (data, pos, end) if hdr is None else (hdr[0], hdr[1], len(hdr[0]))
    bits = _Bits(*src, where)
    style = cp["style"]
    entries = []
    if bits.bit():
        for band in bands:
            incl, zbp = band["incl"], band["zbp"]
            for k, blk in enumerate(band["blocks"]):
                first = not blk.segs            # not included in an earlier layer
                if first:
                    included = incl.decode(bits, k, layer + 1)
                else:
                    included = bits.bit()
                if not included:
                    continue
                if first:
                    i = 0
                    while not zbp.decode(bits, k, i):
                        i += 1
                        if i > 74:
                            raise JP2Error(f"JPEG 2000: corrupted packet header in {where} "
                                           f"(a zero bit-plane count past 74)")
                    blk.numbps = band["numbps"] + 1 - i
                    blk.lenbits = 3
                n = _passes(bits)
                while bits.bit():
                    blk.lenbits += 1
                if first:
                    new, most, held = True, _max_passes(style, None), 0
                elif blk.segs[-1][1] == blk.segs[-1][2]:
                    new, most, held = True, _max_passes(style, blk.segs[-1][2]), 0
                else:
                    new, most, held = False, blk.segs[-1][2], blk.segs[-1][1]
                while n > 0:
                    take = min(most - held, n)
                    nbits = blk.lenbits + take.bit_length() - 1
                    if nbits > 32:
                        raise JP2NoImage(f"JPEG 2000: corrupted packet header in {where} (a "
                                         f"{nbits}-bit segment length; OpenJPEG stops)")
                    entries.append((blk, new, most, take, bits.bits(nbits)))
                    n -= take
                    new, most, held = True, _max_passes(style, most), 0
    hp = bits.align()
    if cp["eph"] and src[0][hp:hp + 2] == b"\xff\x92" and hp + 2 <= src[2]:
        hp += 2                         # OpenJPEG only warns where the EPH marker is missing
    if hdr is None:
        pos = hp
    else:
        hdr[1] = hp
    for blk, new, most, take, length in entries:
        if pos + length > end:
            raise JP2NoImage(f"JPEG 2000: truncated codestream or corrupted packet header (a "
                             f"code-block's {length} bytes in {where} run past the tile's data)")
        if new:
            blk.segs.append([[], 0, most])
        seg = blk.segs[-1]
        seg[0].append(data[pos:pos + length])
        seg[1] += take
        pos += length
    return pos


# ---------------------------------------------------------------------------
# a tile
# ---------------------------------------------------------------------------

def _resolutions(tc: tuple, cp: dict, prec: int):
    """The resolutions of a tile-component [x0, x1) x [y0, y1): their extents,
    precinct grids and, in each precinct, the non-empty bands with their
    code-blocks and tag trees (B.5-B.7, as OpenJPEG's tcd lays them out)."""
    x0, y0, x1, y1 = tc
    nres = cp["levels"] + 1
    out = []
    for r in range(nres):
        lvl = nres - 1 - r
        rx0, ry0 = _ceildiv(x0, 1 << lvl), _ceildiv(y0, 1 << lvl)
        rx1, ry1 = _ceildiv(x1, 1 << lvl), _ceildiv(y1, 1 << lvl)
        ppx, ppy = cp["precincts"][r]
        if r and (ppx == 0 or ppy == 0):
            raise JP2Error("JPEG 2000: a precinct of size 1 at a resolution above 0")
        px0, py0 = (rx0 >> ppx) << ppx, (ry0 >> ppy) << ppy
        pw = 0 if rx0 == rx1 else (_ceildiv(rx1, 1 << ppx) << ppx) - px0 >> ppx
        ph = 0 if ry0 == ry1 else (_ceildiv(ry1, 1 << ppy) << ppy) - py0 >> ppy
        if r == 0:
            gx0, gy0, gw, gh = px0, py0, ppx, ppy
            bandnos = (0,)
        else:
            gx0, gy0, gw, gh = _ceildiv(px0, 2), _ceildiv(py0, 2), ppx - 1, ppy - 1
            bandnos = (1, 2, 3)
        cbw, cbh = min(cp["cbw"], gw), min(cp["cbh"], gh)
        bands = []
        for b in bandnos:
            if r == 0:
                bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                step_index = 0
            else:
                ox, oy = b & 1, b >> 1
                bx0 = _ceildiv(x0 - (ox << lvl), 1 << (lvl + 1))
                by0 = _ceildiv(y0 - (oy << lvl), 1 << (lvl + 1))
                bx1 = _ceildiv(x1 - (ox << lvl), 1 << (lvl + 1))
                by1 = _ceildiv(y1 - (oy << lvl), 1 << (lvl + 1))
                step_index = 3 * (r - 1) + b
            # a sub-band the quantization marker gives no step size keeps
            # OpenJPEG's zeroed one
            expn, mant = cp["steps"][step_index] if step_index < len(cp["steps"]) else (0, 0)
            bands.append({"bandno": b, "x0": bx0, "y0": by0, "x1": bx1, "y1": by1,
                          "numbps": expn + cp["guard"] - 1,
                          "step": np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec - expn))})
        precincts = []
        for p in range(pw * ph):
            cx0, cy0 = gx0 + (p % pw << gw), gy0 + (p // pw << gh)
            pbands = []
            for band in bands:
                if band["x0"] == band["x1"] or band["y0"] == band["y1"]:
                    continue                        # an empty band has no blocks in packets
                qx0, qy0 = max(cx0, band["x0"]), max(cy0, band["y0"])
                qx1, qy1 = min(cx0 + (1 << gw), band["x1"]), min(cy0 + (1 << gh), band["y1"])
                bx0, by0 = (qx0 >> cbw) << cbw, (qy0 >> cbh) << cbh
                cw = max(0, (_ceildiv(qx1, 1 << cbw) << cbw) - bx0 >> cbw)
                ch = max(0, (_ceildiv(qy1, 1 << cbh) << cbh) - by0 >> cbh)
                blocks = []
                for k in range(cw * ch):
                    ax, ay = bx0 + (k % cw << cbw), by0 + (k // cw << cbh)
                    blocks.append(_Block(max(ax, qx0), max(ay, qy0), min(ax + (1 << cbw), qx1),
                                         min(ay + (1 << cbh), qy1)))
                pbands.append({**band, "blocks": blocks, "cw": cw, "ch": ch,
                               "incl": _TagTree(cw, ch) if blocks else None,
                               "zbp": _TagTree(cw, ch) if blocks else None})
            precincts.append(pbands)
        out.append({"x0": rx0, "y0": ry0, "x1": rx1, "y1": ry1, "ppx": ppx, "ppy": ppy,
                    "pw": pw, "ph": ph, "precincts": precincts, "lvl": lvl})
    return out


def _packet_order(order: int, layers: int, comps, tx0: int, ty0: int, pocs=()):
    """(layer, resolution, component, precinct) of each packet of a tile, in
    its progression order (B.12), or in its POC entries' orders: each
    entry's packets (resolutions r0 to r1 - 1, components c0 to c1 - 1,
    layers below l1) in its order, a packet an earlier entry took skipped,
    an entry of an unknown order or a first component past the last giving
    none, as OpenJPEG's opj_pi_update_decode_poc and opj_pi_next_* run
    them.  The position orders visit a precinct at the reference-grid point
    of its top-left corner, or at the tile's origin for the first row /
    column when the precinct grid starts before it, as OpenJPEG's packet
    iterator does."""
    if pocs:
        out, seen = [], set()
        for r0, c0, l1, r1, c1, prg in pocs:
            if prg > 4 or c0 >= len(comps):
                continue
            for key in _packet_order(prg, min(l1, layers), comps, tx0, ty0):
                lay, r, c, _ = key
                if r0 <= r < r1 and c0 <= c < c1 and key not in seen:
                    seen.add(key)
                    out.append(key)
        return out
    keys = []
    for c, res in enumerate(comps):
        for r, rs in enumerate(res):
            if not rs["pw"] or not rs["ph"]:
                continue
            lvl = rs["lvl"]
            gx0, gy0 = rs["x0"] >> rs["ppx"], rs["y0"] >> rs["ppy"]
            for p in range(rs["pw"] * rs["ph"]):
                i, j = p % rs["pw"], p // rs["pw"]
                x = max(tx0, (gx0 + i) << (rs["ppx"] + lvl))
                y = max(ty0, (gy0 + j) << (rs["ppy"] + lvl))
                keys.append((c, r, p, x, y))
    name = _PROGRESSIONS[order]
    out = []
    if name in ("LRCP", "RLCP"):
        nres = max(len(res) for res in comps)
        for a in range(layers if name == "LRCP" else nres):
            for b in range(nres if name == "LRCP" else layers):
                lay, r = (a, b) if name == "LRCP" else (b, a)
                out += [(lay, r, c, p) for c, rr, p, _, _ in keys if rr == r]
        return out
    sort = {"RPCL": lambda k: (k[1], k[4], k[3], k[0]),
            "PCRL": lambda k: (k[4], k[3], k[0], k[1]),
            "CPRL": lambda k: (k[0], k[4], k[3], k[1])}[name]
    for c, r, p, _, _ in sorted(keys, key=sort):
        out += [(lay, r, c, p) for lay in range(layers)]
    return out


def _half_toward_zero(v: np.ndarray) -> np.ndarray:
    """v / 2 as C's integer division truncates it."""
    return np.where(v < 0, -((-v) >> 1), v >> 1)


def _pair(x: np.ndarray, first: int, count: int):
    """x[..., first + i] and x[..., first + i + 1] for i < count along the
    last axis, an index past either end taken from that end: a band's
    neighbours under the symmetric extension of the whole signal."""
    e = x[..., np.clip(np.arange(first, first + count + 1), 0, x.shape[-1] - 1)]
    return e[..., :-1], e[..., 1:]


def _interleave(s: np.ndarray, d: np.ndarray, cas: int) -> np.ndarray:
    out = np.empty(s.shape[:-1] + (s.shape[-1] + d.shape[-1],), s.dtype)
    out[..., cas::2], out[..., 1 - cas::2] = s, d
    return out


# The low-pass band's sample i sits between the high-pass samples i - 1 and
# i (cas 0: the first coordinate is even) or i and i + 1 (cas 1), and the
# high-pass sample i between the low-pass ones i and i + 1, or i - 1 and i.

def _idwt53(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The inverse 5/3 along the last axis in integer lifting: a[..., :sn]
    the low-pass band, a[..., sn:] the high-pass one, cas the parity of the
    first sample's coordinate.  One sample is kept, or halved toward zero
    where it is high-pass, as OpenJPEG does."""
    n = a.shape[-1]
    if n == 1:
        return _half_toward_zero(a) if cas else a
    s, d = a[..., :sn].copy(), a[..., sn:].copy()
    left, right = _pair(d, cas - 1, sn)
    s -= (left + right + 2) >> 2
    left, right = _pair(s, -cas, n - sn)
    d += (left + right) >> 1
    return _interleave(s, d, cas)


def _idwt97(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The inverse 9/7 along the last axis in float32, as OpenJPEG 2.5's
    opj_v8dwt_decode computes it: the bands scaled by K and 2 / K, then the
    four lifting steps, each x += (left + right) * c (one sample is kept as
    it is)."""
    n = a.shape[-1]
    if n == 1:
        return a
    s, d = a[..., :sn] * _K, a[..., sn:] * _TWO_INV_K
    for low, c in ((True, -_DELTA), (False, -_GAMMA), (True, -_BETA), (False, -_ALPHA)):
        if low:
            left, right = _pair(d, cas - 1, sn)
            s += (left + right) * c
        else:
            left, right = _pair(s, -cas, n - sn)
            d += (left + right) * c
    return _interleave(s, d, cas)


def _tile_component(res, cp: dict, shape, rdec: int) -> np.ndarray:
    """Tier 1, dequantisation and the inverse DWT of one tile-component up to
    resolution `rdec` (left in the top-left corner of the tile's buffer)."""
    rev = cp["reversible"]
    buf = np.zeros(shape, np.int64 if rev else np.float32)
    for r, rs in enumerate(res):
        prev = res[r - 1] if r else None
        for pbands in rs["precincts"]:
            for band in pbands:
                b = band["bandno"]
                ox = prev["x1"] - prev["x0"] if b & 1 else 0
                oy = prev["y1"] - prev["y0"] if b & 2 else 0
                for blk in band["blocks"]:
                    if not blk.segs or blk.x0 >= blk.x1 or blk.y0 >= blk.y1:
                        continue
                    if cp["roishift"] + blk.numbps >= 31:
                        raise JP2NoImage(f"JPEG 2000: a code-block of {blk.numbps} bit-planes "
                                         f"and an ROI shift of {cp['roishift']} (OpenJPEG "
                                         f"stops; no image)")
                    v = decode_block([(b"".join(ch), n) for ch, n, _ in blk.segs],
                                     blk.x1 - blk.x0, blk.y1 - blk.y0, blk.numbps, b,
                                     cp["style"], cp["roishift"])
                    if rev:
                        v = _half_toward_zero(v)
                    else:
                        v = v.astype(np.float32) * (np.float32(0.5) * band["step"])
                    y, x = blk.y0 - band["y0"] + oy, blk.x0 - band["x0"] + ox
                    buf[y:y + v.shape[0], x:x + v.shape[1]] = v
    idwt = _idwt53 if rev else _idwt97
    for r in range(1, rdec + 1):
        rs, prev = res[r], res[r - 1]
        rw, rh = rs["x1"] - rs["x0"], rs["y1"] - rs["y0"]
        if rw and rh:
            buf[:rh, :rw] = idwt(buf[:rh, :rw], prev["x1"] - prev["x0"], rs["x0"] & 1)
            buf[:rh, :rw] = idwt(buf[:rh, :rw].T, prev["y1"] - prev["y0"], rs["y0"] & 1).T
    return buf


def _decode_tile(info: dict, t: int):
    """The components of tile t, after the inverse MCT, the DC level shift
    and the clip: [(int64 array, its origin)].  As OpenJPEG, each component
    is reconstructed up to the highest resolution a packet of it was read
    at in this or an earlier tile (resno_decoded, 0 where none was), and a
    lower one is placed at its own, smaller, coordinates."""
    params, data = info["tiles"][t]
    p, q = t % info["ntx"], t // info["ntx"]
    tx0 = max(info["TX0"] + p * info["TW"], info["X0"])
    ty0 = max(info["TY0"] + q * info["TH"], info["Y0"])
    tx1 = min(info["TX0"] + (p + 1) * info["TW"], info["X1"])
    ty1 = min(info["TY0"] + (q + 1) * info["TH"], info["Y1"])
    cps = [params.component(c) for c in range(len(info["prec"]))]
    comps = [_resolutions((tx0, ty0, tx1, ty1), cp, prec)
             for cp, prec in zip(cps, info["prec"])]
    cod = cps[0]
    # packet headers from PPM (one run for every tile, in decoding order) or
    # this tile's PPT, else in the tile's data
    hdr = info.get("ppm_run")
    if hdr is None and t in info.get("ppt", {}):
        hdr = [info["ppt"][t], 0]
    pos = 0
    rdec = info.setdefault("resno_decoded", [0] * len(comps))
    for lay, r, c, prc in _packet_order(cod["order"], cod["layers"], comps, tx0, ty0,
                                        params.pocs):
        # past the tile's data a packet header reads as 0 bits: an empty packet
        pos = _read_packet(data, pos, len(data), comps[c][r]["precincts"][prc], lay, cps[c],
                           f"tile {t} (layer {lay}, resolution {r}, component {c})", hdr)
        rdec[c] = max(rdec[c], r)
    rdec = [min(rd, len(res) - 1) for rd, res in zip(rdec, comps)]
    out = [_tile_component(res, cp, (ty1 - ty0, tx1 - tx0), rd)
           for res, cp, rd in zip(comps, cps, rdec)]
    if cod["mct"] and len(out) >= 3:
        if cod["mct"] != 1:
            raise JP2Error(f"JPEG 2000: multiple component transform {cod['mct']}")
        if len({rdec[0], rdec[1], rdec[2]}) > 1 or len({len(r) for r in comps[:3]}) > 1:
            raise JP2NoImage("JPEG 2000: the first three components decoded to different "
                             "resolutions under a component transform (OpenJPEG stops; no "
                             "image)")
        if cps[0]["reversible"]:        # RCT (G.2)
            y, u, v = out[:3]
            g = y - ((u + v) >> 2)
            out[:3] = [v + g, g, u + g]
        else:                           # ICT (G.3), OpenJPEG's float32 coefficients
            y, u, v = out[:3]
            out[:3] = [y + v * np.float32(1.402),
                       y - u * np.float32(0.34413) - v * np.float32(0.71414),
                       y + u * np.float32(1.772)]
    shifted = []
    for a, cp, prec, res, rd in zip(out, cps, info["prec"], comps, rdec):
        rs = res[rd]
        a = a[:rs["y1"] - rs["y0"], :rs["x1"] - rs["x0"]]
        if not cp["reversible"]:
            a = np.rint(np.clip(a, -2.0 ** 31, 2.0 ** 31 - 1)).astype(np.int64)
        shifted.append((np.clip(a + (1 << (prec - 1)), 0, (1 << prec) - 1), (rs["x0"], rs["y0"])))
    return shifted


def decode_codestream(cs: bytes, ihdr=None, no_image: str = ""):
    """A J2K codestream -> (its components, int64 [H, W] each; their
    precisions), for 1, 3 or 4 components of unsigned samples of at most 16
    bits, the largest of at least 8, at offset 0 without sub-sampling
    (anything else raises, as OpenCV reads no image from it).  Its main
    header is read first, as opj_read_header reads it within OpenCV's
    readHeader (with a JP2 file's `ihdr` (width, height): SIZ must agree),
    then OpenCV's checks and its size limits (then JP2NoImage(no_image)
    where given: what OpenCV refuses after decoding), then the
    tile-parts."""
    info, pos = _main_header(cs)
    if ihdr is not None and all(ihdr) and \
            ihdr != (info["X1"] - info["X0"], info["Y1"] - info["Y0"]):
        raise JP2NoImage(f"JPEG 2000: the 'ihdr' box gives {ihdr[0]} x {ihdr[1]} pixels and SIZ "
                         f"{info['X1'] - info['X0']} x {info['Y1'] - info['Y0']} (OpenJPEG stops)")
    if len(info["prec"]) not in (1, 2, 3, 4):
        raise JP2NoImage(f"JPEG 2000 with {len(info['prec'])} components: OpenCV reads no image "
                         f"from it (it takes 1, 3 or 4)")
    if any(info["signed"]):
        raise JP2NoImage("JPEG 2000 with signed samples: OpenCV reads no image from it")
    top = max(info["prec"])
    if top < 8:
        raise JP2NoImage(f"JPEG 2000 with {top}-bit samples: OpenCV reads no image from it")
    check_size(info["X1"] - info["X0"], info["Y1"] - info["Y0"], "JPEG 2000")
    if len(info["prec"]) == 2:
        raise JP2NoImage("JPEG 2000 with 2 components: OpenCV reads no image from it (it takes "
                         "1, 3 or 4)")
    if info["X0"] or info["Y0"]:
        raise JP2NoImage(f"JPEG 2000 with an image offset of ({info['X0']}, {info['Y0']}): "
                         f"OpenCV reads no image from it")
    if any(s != (1, 1) for s in info["sub"]):
        raise JP2NoImage(f"JPEG 2000 with sub-sampled components {info['sub']}: OpenCV reads no "
                         f"image from it")
    if top > 16:
        raise JP2NoImage(f"JPEG 2000 with {top}-bit samples: OpenCV reads no image from it")
    if no_image:
        raise JP2NoImage(no_image)
    info = _tile_parts(cs, info, pos)
    if info["ppm"] is not None:
        info["ppm_run"] = [info["ppm"], 0]
    H, W = info["Y1"], info["X1"]
    comps = [np.zeros((H, W), np.int64) for _ in info["prec"]]
    for t in sorted(info["tiles"]):
        for dst, (a, (x0, y0)) in zip(comps, _decode_tile(info, t)):
            dst[y0:y0 + a.shape[0], x0:x0 + a.shape[1]] = a
    return comps, info["prec"]


# ---------------------------------------------------------------------------
# the JP2 file format
# ---------------------------------------------------------------------------

def _read_jp2(data: bytes):
    """The codestream and the colour information of a JP2 file, its boxes
    read as OpenJPEG's opj_jp2_read_header_procedure reads them: the
    signature box first, `ftyp` second, `jp2h` before `jp2c` (whose
    codestream runs to the end of the file, whatever its length says),
    `jp2h`'s boxes each inside it with `ihdr` among them, boxes OpenJPEG
    does not know skipped; what it refuses gives no image (JP2NoImage).
    -> (codestream, the header's boxes: {"colour": colour space, "cdef":
    entries, "ihdr": (width, height), "pclr": palette, "cmap": entries})."""
    def bad(what: str):
        return JP2NoImage(f"JPEG 2000: {what} (OpenJPEG stops; OpenCV returns no image)")

    state, pos = set(), 0
    box = dict.fromkeys(("colour", "cdef", "ihdr", "pclr", "cmap"))
    while True:
        if pos + 8 > len(data):
            raise bad("no codestream ('jp2c' box)")
        n, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if n == 1:
            if pos + 16 > len(data):
                raise bad("a box header past the end of the file")
            hi, n = struct.unpack_from(">II", data, pos + 8)
            if hi:
                raise bad("a box of 2^32 bytes or more")
            head = 16
        elif n == 0:
            n = len(data) - pos
        if kind == b"jp2c":
            if "jp2h" not in state:
                raise bad("a codestream box before the header box")
            return data[pos + head:], box
        if n == 0 or n < head:
            raise bad(f"a '{kind.decode('latin-1')}' box of {n} bytes")
        body = data[pos + head:pos + n]
        if kind in (b"jP  ", b"ftyp", b"jp2h") or kind in _JP2H_BOXES:
            if kind in _JP2H_BOXES:                  # misplaced, outside jp2h
                if "jp2h" not in state:
                    pos += n
                    if pos > len(data):
                        raise bad("a box past the end of the file")
                    continue
            if pos + n > len(data):
                raise bad(f"the '{kind.decode('latin-1')}' box runs past the end of the file")
            if kind == b"jP  ":
                if state or len(body) != 4 or body != b"\r\n\x87\n":
                    raise bad("a bad signature box")
                state.add("jP")
            elif kind == b"ftyp":
                if state != {"jP"} or len(body) < 8 or len(body) % 4:
                    raise bad("the file type box is not the second box, or of a bad size")
                state.add("ftyp")
            elif kind == b"jp2h":
                if "ftyp" not in state:
                    raise bad("the header box before the file type box")
                _jp2h(body, box, bad)
                state.add("jp2h")
            else:
                _jp2h_box(kind, body, box, bad)
        elif "jP" not in state or "ftyp" not in state:
            raise bad("a first box other than the signature or a second other than 'ftyp'")
        elif pos + n > len(data):
            raise bad(f"the '{kind.decode('latin-1')}' box runs past the end of the file")
        pos += n


# the boxes OpenJPEG reads inside 'jp2h' (opj_jp2_img_find_handler)
_JP2H_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


def _jp2h(body: bytes, box: dict, bad) -> None:
    """The header box's boxes (opj_jp2_read_jp2h): each complete, 'ihdr'
    among them."""
    pos, has_ihdr = 0, False
    while pos < len(body):
        if len(body) - pos < 8:
            raise bad("a box of less than 8 bytes in the header box")
        n, kind = struct.unpack_from(">I4s", body, pos)
        head = 8
        if n == 1:
            if len(body) - pos < 16:
                raise bad("an XL box of less than 16 bytes in the header box")
            hi, n = struct.unpack_from(">II", body, pos + 8)
            if hi:
                raise bad("a box of 2^32 bytes or more")
            head = 16
        if n == 0 or n < head or n > len(body) - pos:
            raise bad(f"a '{kind.decode('latin-1')}' box of {n} bytes in the header box")
        if kind in _JP2H_BOXES:
            _jp2h_box(kind, body[pos + head:pos + n], box, bad)
        has_ihdr |= kind == b"ihdr"
        pos += n
    if not has_ihdr:
        raise bad("a header box without 'ihdr'")


def _jp2h_box(kind: bytes, sb: bytes, box: dict, bad) -> None:
    """One of the header's boxes into `box`, checked as OpenJPEG's handler
    checks it (opj_jp2_read_ihdr, _colr, _cdef, _pclr, _cmap)."""
    if kind == b"ihdr" and box["ihdr"] is None:
        if len(sb) != 14:
            raise bad("an 'ihdr' box of a bad size")
        h, w, nc = struct.unpack_from(">IIH", sb)
        if not 1 <= nc <= 16384:
            raise bad(f"an 'ihdr' box of {nc} components")
        box["ihdr"] = (w, h)
    elif kind == b"colr" and box["colour"] is None:
        if len(sb) < 3 or (sb[0] == 1 and len(sb) < 7):
            raise bad("a 'colr' box of a bad size")
        if sb[0] == 1:
            box["colour"] = struct.unpack_from(">I", sb, 3)[0]
        elif sb[0] == 2:
            box["colour"] = 0
    elif kind == b"cdef":
        if box["cdef"] is not None:
            raise bad("a second 'cdef' box")
        n = struct.unpack_from(">H", sb)[0] if len(sb) >= 2 else 0
        if n == 0 or len(sb) < 2 + 6 * n:
            raise bad("a 'cdef' box of no or too few channel descriptions")
        box["cdef"] = [struct.unpack_from(">HHH", sb, 2 + 6 * i) for i in range(n)]
    elif kind == b"pclr":
        if box["pclr"] is not None or len(sb) < 3:
            raise bad("a second 'pclr' box, or one of under 3 bytes")
        ne, nc = struct.unpack_from(">HB", sb)
        if not 1 <= ne <= 1024 or nc == 0 or len(sb) < 3 + nc:
            raise bad(f"a 'pclr' box of {ne} entries and {nc} columns")
        sizes = [(b & 0x7F) + 1 for b in sb[3:3 + nc]]
        widths = [min(4, (z + 7) >> 3) for z in sizes]     # at most 4 bytes an entry read
        if len(sb) < 3 + nc + ne * sum(widths):
            raise bad("a 'pclr' box shorter than its entries")
        entries, pos = [], 3 + nc
        for _ in range(ne):
            row = []
            for w in widths:
                row.append(int.from_bytes(sb[pos:pos + w], "big"))
                pos += w
            entries.append(row)
        box["pclr"] = np.array(entries, np.int64)
    elif kind == b"cmap":
        if box["pclr"] is None:
            raise JP2NoImage("JPEG 2000 with a palette's 'cmap' box and no 'pclr' before it "
                             "(OpenJPEG needs the PCLR box first; OpenCV returns no image)")
        if box["cmap"] is not None or len(sb) < 4 * box["pclr"].shape[1]:
            raise bad("a second 'cmap' box, or one shorter than the palette's columns")
        box["cmap"] = [list(struct.unpack_from(">HBB", sb, 4 * i))
                       for i in range(box["pclr"].shape[1])]


def _check_colour(ncomps: int, box: dict) -> None:
    """opj_jp2_check_color: the 'cdef' channels within the palette's columns
    (else the components), each defined; each 'cmap' entry of an existing
    component, mapping type 0 (direct) or 1 (palette column i at channel
    i), each column once; a one-component image's direct entries turned
    into palette ones ("weird cmap").  No image where it fails."""
    cmap = box["cmap"] if box["pclr"] is not None else None
    n = len(cmap) if cmap is not None else ncomps
    if box["cdef"]:
        cdef = box["cdef"]
        if any(cn >= n or (asoc not in (0, 65535) and asoc - 1 >= n) for cn, _, asoc in cdef) \
                or any(c not in {cn for cn, _, _ in cdef} for c in range(n)):
            raise JP2NoImage("JPEG 2000: a 'cdef' box with channels out of range or missing "
                             "(OpenJPEG stops; OpenCV returns no image)")
    if cmap is None:
        return
    used, sane = [False] * n, all(cmp < ncomps for cmp, _, _ in cmap)
    for i, (_, mtyp, pcol) in enumerate(cmap):
        if mtyp > 1 or pcol >= n or (used[pcol] and mtyp == 1) or (mtyp == 0 and pcol) \
                or (mtyp == 1 and pcol != i):
            sane = False
        else:
            used[pcol] = True
    if any(not used[i] and cmap[i][1] for i in range(n)):
        sane = False
    if sane and ncomps == 1 and not all(used):
        for i, e in enumerate(cmap):
            e[1:] = [1, i]
    if not sane:
        raise JP2NoImage("JPEG 2000: a 'cmap' box OpenJPEG does not take (it stops; OpenCV "
                         "returns no image)")


def _apply_pclr(comps: list, box: dict) -> list:
    """opj_jp2_apply_pclr: channel i is component cmp as it is (mapping type
    0) or palette column i at the component's values clipped to the
    palette's entries (type 1)."""
    pal = box["pclr"]
    out = []
    for i, (cmp, mtyp, _) in enumerate(box["cmap"]):
        src = comps[cmp]
        out.append(src if mtyp == 0 else pal[np.clip(src, 0, len(pal) - 1), i])
    return out


def _apply_cdef(comps: list, cdef) -> list:
    """Swap the colour channels a 'cdef' box associates elsewhere, as
    OpenJPEG's opj_jp2_apply_cdef does."""
    comps, cdef = list(comps), [list(e) for e in cdef]
    for i, (cn, typ, asoc) in enumerate(cdef):
        if cn >= len(comps) or asoc in (0, 65535) or asoc - 1 >= len(comps):
            continue
        acn = asoc - 1
        if cn != acn and typ == 0:
            comps[cn], comps[acn] = comps[acn], comps[cn]
            for e in cdef[i + 1:]:
                if e[0] == cn:
                    e[0] = acn
                elif e[0] == acn:
                    e[0] = cn
    return comps


# 'colr' enumerated colour spaces -> the conversion OpenCV 5 applies
# (Jpeg2KOpjDecoderBase::readData); any other is OpenJPEG's UNKNOWN, read as sRGB
_SPACES = {16: "sRGB", 17: "gray", 18: "sYCC", 12: "CMYK", 24: "e-YCC"}


def _opencv_channels(comps: list, nout: int, space: str, depth: int) -> list:
    """OpenCV's channels (RGB(A) order) from OpenJPEG's components after the
    palette and 'cdef': `nout` is the codestream's component count (OpenCV
    sizes its array from the header), `depth` 8 or 16; each sample is cast
    to the array's type (the low bits kept), then converted as
    decodeSRGBData / decodeGrayscaleData / decodeSYCCData do:
      gray: the first component, once or thrice;
      sYCC: the first component for one channel; three components through
            cvtColor's COLOR_YUV2BGR for three (fixed point, 2^14: B = Y +
            2.032 U, G = Y - 0.395 U - 0.581 V, R = Y + 1.140 V, U and V
            less 128 or 32768, the result saturated);
      sRGB: one channel from 1-2 components the first, from 3-4 cvtColor's
            COLOR_BGR2GRAY ((4899 R + 9617 G + 1868 B + 2^13) >> 14 on 8
            bits, (9798 R + 19235 G + 3735 B + 2^14) >> 15 on 16); three
            from 3-4 the first three; four from 4 all four.
    Any other pairing gives no image, but 3 components into 4 channels
    (a palette's), where OpenCV reads a fourth past the end of OpenJPEG's
    array: that raises a JP2Error naming it."""
    nin, mask = len(comps), (1 << depth) - 1
    c = [a & mask for a in comps]

    def refuse():
        return JP2NoImage(f"JPEG 2000: {nin} components in the {space} colour space into "
                          f"{nout} channels: OpenCV reads no image from it")

    if space == "gray":
        if nout not in (1, 3):
            raise refuse()
        return [c[0]] * nout
    if space == "sYCC":
        if nout == 1:
            return [c[0]]
        if nout != 3 or nin < 3:
            raise refuse()
        delta = 128 if depth == 8 else 32768
        y, u, v = c[0], c[1] - delta, c[2] - delta

        def descale(x):
            return (x + (1 << 13)) >> 14

        return [np.clip(y + descale(v * 18678), 0, mask),
                np.clip(y + descale(u * -6472 + v * -9519), 0, mask),
                np.clip(y + descale(u * 33292), 0, mask)]
    if nout == 1:
        if nin <= 2:
            return [c[0]]
        if depth == 8:
            return [(c[0] * 4899 + c[1] * 9617 + c[2] * 1868 + 8192) >> 14]
        return [(c[0] * 9798 + c[1] * 19235 + c[2] * 3735 + 16384) >> 15]
    if nout == 3 and nin >= 3:
        return c[:3]
    if nout == 4 and nin >= 4:
        return c[:4]
    if nout == 4 and nin == 3:
        raise JP2Error("JPEG 2000: a palette of 3 columns over 4 components: OpenCV reads a "
                       "fourth component past the end of OpenJPEG's array, which no file "
                       "holds")
    raise refuse()


def decode_jp2(data: bytes) -> np.ndarray:
    """A .jp2 file or a raw J2K codestream -> the array
    cv2.imread(IMREAD_UNCHANGED) gives, channels in RGB(A) order (module
    docstring)."""
    if data[:12] == JP2_SIGNATURE:
        cs, box = _read_jp2(data)
    elif data[:4] == J2K_SOC_SIZ:
        cs, box = data, dict.fromkeys(("colour", "cdef", "ihdr", "pclr", "cmap"))
    else:
        raise JP2Error("JPEG 2000: neither a JP2 signature nor a codestream's SOC and SIZ")
    space = _SPACES.get(box["colour"], "sRGB")
    comps, prec = decode_codestream(
        cs, box["ihdr"], f"JPEG 2000 in the {space} colour space: OpenCV reads no image from "
        f"it (it converts only sRGB, gray and sYCC)" if space in ("CMYK", "e-YCC") else "")
    nout = len(comps)
    _check_colour(nout, box)
    if box["pclr"] is not None and box["cmap"] is not None:   # a palette without 'cmap' is dropped
        comps = _apply_pclr(comps, box)
    if box["cdef"]:
        comps = _apply_cdef(comps, box["cdef"])
    depth = 8 if max(prec) == 8 else 16
    out = np.stack(_opencv_channels(comps, nout, space, depth), axis=-1)
    out = out.astype(np.uint8 if depth == 8 else np.uint16)
    return out[..., 0] if out.shape[-1] == 1 else out
