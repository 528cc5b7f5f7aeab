"""The port's JPEG 2000 decoder (iron_tpu_torch/data/jp2.py, jp2_t1.py)
against OpenCV, which the JAX package reads JPEG 2000 through (OpenJPEG):
every file decodes bit-equal to cv2.imdecode(IMREAD_UNCHANGED) (channels in
RGB(A) order), and read_image gives the JAX package's floats bit for bit.

Files come from PIL's JPEG 2000 writer (its OpenJPEG: modes L, RGB, RGBA and
I;16, the 5/3 and 9/7 wavelets, RCT / ICT, .jp2 and raw .j2k, the five
progressions, tiles of odd sizes, 1-6 resolutions, code-blocks from 4 x 4 to
64 x 64, precincts, quality layers, PLT markers) and from OpenCV's own
writer (reversible 5/3 without a colour transform, cut at a rate below
1000); some are then edited: tile-parts split and interleaved, a 'cdef' box
that swaps channels, a gray 'colr' over three components, other sample
precisions.  The variants OpenCV refuses raise in the JAX package (IOError)
and in the port (a ValueError naming the variant); flags set on a stream
coded without them decode as OpenCV decodes them, and only HT code-blocks
raise naming them (the corners themselves: test_torch_jp2_corners.py).
The committed fixtures tests/data_jp2 (scripts/make_jp2_fixtures.py) and
tests/data_jp2_corners decode to their recorded hashes, also in a process
where cv2, PIL, glymur, jax and iron_tpu cannot be imported."""
import hashlib
import io
import json
import os
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

from iron_tpu.data import io as jio
from iron_tpu.data.dataset import load_image_folder as j_load_image_folder

from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.dataset import load_image_folder
from iron_tpu_torch.data.jp2 import decode_jp2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data_jp2")
_SRC = cv2.imread(os.path.join(REPO, "tests", "data_singleview", "12.png"))[..., ::-1]


def _photo(H: int, W: int, seed: int = 0, noise: float = 12.0) -> np.ndarray:
    """The object of tests/data_singleview/12.png shrunk to [H, W] with
    noise (RGB uint8)."""
    crop = np.ascontiguousarray(_SRC[60:466, 109:403])
    img = cv2.resize(crop, (W, H), interpolation=cv2.INTER_AREA).astype(np.float64)
    img += np.random.default_rng(seed).normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _mode(img: np.ndarray, mode: str) -> np.ndarray:
    """The photo as PIL's mode L, RGB, RGBA or I;16."""
    if mode == "L":
        return img[..., 1]
    if mode == "RGBA":
        a = (np.add.outer(np.arange(img.shape[0]) * 5, np.arange(img.shape[1]) * 3) % 256)
        return np.dstack([img, a.astype(np.uint8)])
    if mode == "I;16":
        return img[..., 0].astype(np.uint16) * 257 + np.arange(img.shape[1], dtype=np.uint16)
    return img


def _pil(img: np.ndarray, j2k: bool = False, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(img).save(f, "JPEG2000", no_jp2=j2k, **kw)
    return f.getvalue()


def _cv2(img_rgb: np.ndarray, x1000: int = 1000) -> bytes:
    img = img_rgb[..., ::-1] if img_rgb.ndim == 3 else img_rgb
    ok, buf = cv2.imencode(".jp2", np.ascontiguousarray(img),
                           [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000])
    assert ok
    return buf.tobytes()


def _ref(data: bytes):
    """OpenCV's decode in RGB(A) order (None where it reads no image)."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is not None and img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _check(data: bytes, tmp_path, ext: str = ".jp2") -> np.ndarray:
    """The port's decode_image equals OpenCV's decode, and its read_image
    the JAX package's, bit for bit."""
    ref = _ref(data)
    assert ref is not None
    got = tio.decode_image(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    path = str(tmp_path / ("a" + ext))
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(tio.read_image(path), jio.read_image(path))
    return got


# ---------------------------------------------------------------------------
# the writers' variants
# ---------------------------------------------------------------------------

# name -> (mode, [H, W], PIL's options); every file from PIL's OpenJPEG
CASES = {
    "L 5/3": ("L", (48, 64), {}),
    "RGB 5/3": ("RGB", (48, 64), {}),
    "RGB 5/3 RCT .j2k": ("RGB", (48, 64), {"mct": 1, "j2k": True}),
    "RGB 9/7": ("RGB", (96, 128), {"irreversible": True}),
    "RGB 9/7 ICT .j2k": ("RGB", (96, 128), {"irreversible": True, "mct": 1, "j2k": True}),
    "RGBA 5/3 RCT": ("RGBA", (40, 56), {"mct": 1}),
    "RGBA 9/7 ICT 2 layers": ("RGBA", (64, 80), {"irreversible": True, "mct": 1,
                                                  "quality_layers": [16, 6]}),
    "I;16 5/3 .j2k": ("I;16", (40, 56), {"j2k": True}),
    "I;16 9/7 1 layer": ("I;16", (64, 80), {"irreversible": True, "quality_layers": [10]}),
    **{f"{p} precincts 3 layers {w}": ("RGB", (96, 128), {
        "progression": p, "precinct_size": (32, 32), "codeblock_size": (16, 16),
        "num_resolutions": 4, "quality_layers": [30, 10, 5], "mct": 1,
        "irreversible": w == "9/7"})
       for p, w in (("LRCP", "5/3"), ("RLCP", "9/7"), ("RPCL", "5/3"), ("PCRL", "9/7"),
                    ("CPRL", "5/3"))},
    **{f"{p} odd tiles 9/7": ("RGB", (37, 53), {
        "progression": p, "tile_size": (17, 13), "num_resolutions": 3, "irreversible": True,
        "quality_layers": [15, 5], "mct": 1}) for p in ("LRCP", "RPCL", "CPRL")},
    "odd tiles 5/3 RCT": ("RGB", (31, 29), {"tile_size": (7, 9), "num_resolutions": 3,
                                            "mct": 1}),
    **{f"{n} resolutions {w}": ("RGB", (48, 64) if w == "5/3" else (96, 128), {
        "num_resolutions": n, "irreversible": w == "9/7", "mct": 1,
        "quality_layers": [12] if w == "9/7" else None})
       for n, w in ((1, "5/3"), (2, "9/7"), (3, "5/3"), (4, "9/7"), (5, "5/3"), (6, "9/7"))},
    **{f"code-blocks {w}x{h}": ("RGB", (96, 128), {
        "codeblock_size": (w, h), "irreversible": True, "quality_layers": [12], "mct": 1})
       for w, h in ((4, 4), (4, 64), (64, 4), (8, 32), (32, 8), (64, 64))},
    "precincts 128x128 halved a resolution, 64x32 code-blocks": ("L", (96, 128), {
        "precinct_size": (128, 128), "codeblock_size": (64, 32), "num_resolutions": 4}),
    "3 layers 5/3 truncated": ("RGB", (96, 128), {"quality_layers": [40, 20, 10], "mct": 1}),
    "PLT markers": ("RGB", (96, 128), {"plt": True, "quality_layers": [20, 10, 1],
                                       "irreversible": True, "mct": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pil_variants_match_opencv(case, tmp_path):
    mode, (H, W), kw = CASES[case]
    kw = {k: v for k, v in kw.items() if v is not None}
    j2k = kw.pop("j2k", False)
    img = _mode(_photo(H, W, seed=len(case)), mode)
    data = _pil(img, j2k, **kw)
    assert data[:4] == b"\xff\x4f\xff\x51" if j2k else data[4:8] == b"jP  "
    got = _check(data, tmp_path, ".j2k" if j2k else ".jp2")
    if not kw.get("irreversible") and "quality_layers" not in kw:
        np.testing.assert_array_equal(got, img)          # lossless: the image itself


@pytest.mark.parametrize("kind", ["RGB", "gray", "16-bit", "RGB cut at 25", "gray cut at 50"])
def test_opencv_written_files_match_opencv(kind, tmp_path):
    """OpenCV's own .jp2 (reversible 5/3, no colour transform; lossy only by
    its rate, which cuts code-blocks mid-plane)."""
    img = _photo(64, 80, seed=7)
    if "gray" in kind:
        img = img[..., 0]
    elif kind == "16-bit":
        img = img[..., 0].astype(np.uint16) * 251
    _check(_cv2(img, int(kind.split()[-1]) if "cut" in kind else 1000), tmp_path)


# ---------------------------------------------------------------------------
# edited files: tile-parts, boxes, precisions
# ---------------------------------------------------------------------------

def _codestream_parts(cs: bytes):
    """(main header, [(tile, tile-part header markers, packet lengths from
    PLT, data)]) of a codestream PIL wrote with plt=True."""
    pos = cs.index(b"\xff\x90")
    main, parts = cs[:pos], []
    while cs[pos:pos + 2] == b"\xff\x90":
        isot, psot = struct.unpack_from(">HI", cs, pos + 4)
        end, p = pos + psot, pos + 12
        lengths, markers = [], b""
        while cs[p:p + 2] != b"\xff\x93":
            n = struct.unpack_from(">H", cs, p + 2)[0]
            if cs[p:p + 2] == b"\xff\x58":          # PLT: 7-bit groups, high bit continues
                v = 0
                for b in cs[p + 5:p + 2 + n]:
                    v = (v << 7) | (b & 0x7F)
                    if not b & 0x80:
                        lengths.append(v)
                        v = 0
            else:
                markers += cs[p:p + 2 + n]
            p += 2 + n
        parts.append((isot, markers, lengths, cs[p + 2:end]))
        pos = end
    return main, parts


def _tile_part(tile: int, index: int, count: int, body: bytes) -> bytes:
    return struct.pack(">HHHIBB", 0xFF90, 10, tile, 12 + 2 + len(body), index, count) + \
        b"\xff\x93" + body


def _split_interleaved() -> bytes:
    """A 4-tile codestream whose tiles are each cut in two tile-parts at a
    packet boundary, written tile 3's first part, then 2's, 1's, 0's, then
    the second parts in the same order."""
    cs = _pil(_photo(40, 56, seed=11), True, tile_size=(32, 24), plt=True, num_resolutions=3,
              quality_layers=[20, 5, 1], irreversible=True, mct=1)
    main, parts = _codestream_parts(cs)
    assert len(parts) == 4 and all(len(p[2]) > 2 for p in parts)
    first, second = [], []
    for tile, markers, lengths, data in reversed(parts):
        assert sum(lengths) == len(data)
        cut = sum(lengths[:len(lengths) // 2])
        first.append(_tile_part(tile, 0, 2, data[:cut]))
        second.append(_tile_part(tile, 1, 2, data[cut:]))
    return main + b"".join(first + second) + b"\xff\xd9"


def _packets(cs: bytes):
    """(tile data, [((layer, resolution, component, precinct), start, header
    end, end)]) of a one-tile codestream's packets, read with the port's
    tier-2 parser (the files built from them are judged by OpenCV)."""
    from iron_tpu_torch.data import jp2 as J
    info = J.parse_codestream(cs)
    params, data = info["tiles"][0]
    heads, spans = [], []
    align, read = J._Bits.align, J._read_packet

    def recording_align(bits):
        heads.append(align(bits))
        return heads[-1]

    def recording_read(buf, pos, *a):
        spans.append((pos, read(buf, pos, *a)))
        return spans[-1][1]

    J._Bits.align, J._read_packet = recording_align, recording_read
    try:
        J._decode_tile(info, 0)
    finally:
        J._Bits.align, J._read_packet = align, read
    cps = [params.component(c) for c in range(len(info["prec"]))]
    comps = [J._resolutions((0, 0, info["X1"], info["Y1"]), cp, p)
             for cp, p in zip(cps, info["prec"])]
    order = J._packet_order(cps[0]["order"], cps[0]["layers"], comps, 0, 0)
    return data, [(k, a, h, b) for k, (a, b), h in zip(order, spans, heads)]


def _rebuilt(cs: bytes, main_extra: bytes, scod: int, body: bytes) -> bytes:
    """A one-tile codestream with `main_extra` added to its main header, its
    COD's Scod or-ed with `scod`, and `body` as its tile's data."""
    sot, sod = cs.index(b"\xff\x90"), cs.index(b"\xff\x93")
    main = bytearray(cs[:sot])
    main[main.index(b"\xff\x52") + 4] |= scod
    part = bytearray(cs[sot:sod + 2])
    struct.pack_into(">I", part, 6, len(part) + len(body))
    return bytes(main) + main_extra + bytes(part) + body + b"\xff\xd9"


def _with_sop_eph() -> bytes:
    """A one-tile codestream re-written with an SOP marker before every
    packet and an EPH marker after every packet header (COD's Scod bits 1
    and 2), which PIL's writer does not make."""
    cs = _pil(_photo(40, 56, seed=14), True, quality_layers=[20, 5, 1], irreversible=True,
              mct=1, num_resolutions=3)
    data, packets = _packets(cs)
    body = b"".join(b"\xff\x91\x00\x04" + struct.pack(">H", n) + data[a:h] + b"\xff\x92"
                    + data[h:b] for n, (_, a, h, b) in enumerate(packets))
    return _rebuilt(cs, b"", 6, body)


def _fewer_resolutions(progression: str) -> bytes:
    """An RGB codestream whose blue component has 2 resolutions (a COC) and
    the others 4, in the given progression with 32 x 32 precincts: the red
    and green packets are PIL's, the blue ones empty (so blue decodes to
    128), laid out in the port's packet order, which OpenCV must share to
    decode the same image."""
    from iron_tpu_torch.data import jp2 as J
    cs = _pil(_photo(48, 64, seed=15), True, progression=progression, num_resolutions=4,
              precinct_size=(32, 32), codeblock_size=(16, 16), quality_layers=[20, 6])
    data, packets = _packets(cs)
    bytes_of = {k: data[a:b] for k, a, _, b in packets}
    k = cs.index(b"\xff\x52")
    xcb, ycb, style, wavelet = cs[k + 10:k + 14]
    precincts = cs[k + 16:k + 18]                       # those of the two top resolutions
    coc = b"\x02\x01" + bytes([1, xcb, ycb, style, wavelet]) + precincts
    coc = b"\xff\x53" + struct.pack(">H", 2 + len(coc)) + coc
    info = J.parse_codestream(_rebuilt(cs, coc, 0, b""))
    cps = [info["main"].component(c) for c in range(3)]
    comps = [J._resolutions((0, 0, 64, 48), cp, 8) for cp in cps]
    order = J._packet_order(cps[0]["order"], cps[0]["layers"], comps, 0, 0)
    body = b"".join(bytes_of[key] if key[2] < 2 else b"\x00" for key in order)
    out = _rebuilt(cs, coc, 0, body)
    ref, got = _ref(cs), _ref(out)
    assert np.array_equal(got[..., :2], ref[..., :2]) and (got[..., 2] == 128).all()
    return out


def _box(jp2: bytes, kind: bytes) -> int:
    return jp2.index(kind) - 4


def _with_colour(jp2: bytes, enum: int) -> bytes:
    k = _box(jp2, b"colr")
    return jp2[:k + 11] + struct.pack(">I", enum) + jp2[k + 15:]


def _with_jp2h_box(jp2: bytes, box: bytes) -> bytes:
    """The .jp2 with `box` appended to its header box."""
    h = _box(jp2, b"jp2h")
    n = struct.unpack_from(">I", jp2, h)[0]
    return jp2[:h] + struct.pack(">I", n + len(box)) + jp2[h + 4:h + n] + box + jp2[h + n:]


def _cdef_swap() -> bytes:
    """An RGB .jp2 whose 'cdef' box says component 0 is blue and 2 red."""
    body = b"\x00\x03" + b"".join(struct.pack(">HHH", c, 0, a) for c, a in ((0, 3), (1, 2), (2, 1)))
    return _with_jp2h_box(_pil(_photo(32, 40, seed=12)),
                          struct.pack(">I", 8 + len(body)) + b"cdef" + body)


def _precisions(cs: bytes, precs) -> bytes:
    """A codestream whose SIZ gives its components other precisions (the
    coefficients stay valid: only the DC shift and the clip change)."""
    cs = bytearray(cs)
    for i, p in enumerate(precs):
        cs[42 + 3 * i] = p - 1
    return bytes(cs)


EDITED = {
    "tile-parts split and interleaved": _split_interleaved,
    "SOP and EPH markers": _with_sop_eph,
    **{f"{p}, blue with fewer resolutions": (lambda p=p: _fewer_resolutions(p))
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    "cdef swapping red and blue": _cdef_swap,
    "gray colour space over RGB": lambda: _with_colour(_pil(_photo(32, 40, seed=13)), 17),
    "unknown colour space": lambda: _with_colour(_pil(_photo(32, 40, seed=13)), 3),
    "sRGB colour space over gray": lambda: _with_colour(_pil(_photo(32, 40)[..., 0]), 16),
    "12-bit gray": lambda: _precisions(_pil(_photo(32, 40)[..., 0], True), [12]),
    "9-bit gray": lambda: _precisions(_pil(_photo(32, 40)[..., 0], True), [9]),
    "8, 8 and 12 bits": lambda: _precisions(_pil(_photo(32, 40), True), [8, 8, 12]),
    "7, 8 and 8 bits": lambda: _precisions(_pil(_photo(32, 40), True), [7, 8, 8]),
}


@pytest.mark.parametrize("case", sorted(EDITED))
def test_edited_files_match_opencv(case, tmp_path):
    """Tile-parts in any order, SOP / EPH markers, components whose
    resolution counts differ in each progression, the 'cdef' and 'colr'
    boxes as OpenJPEG and OpenCV apply them (OpenCV repeats a gray image's
    first component over three), and precisions other than 8 and 16 bits
    (the largest decides: 8 gives uint8, 9-16 uint16, the values kept as
    decoded)."""
    data = EDITED[case]()
    _check(data, tmp_path, ".j2k" if data[:2] == b"\xff\x4f" else ".jp2")


# ---------------------------------------------------------------------------
# what OpenCV refuses, and what the port does not decode
# ---------------------------------------------------------------------------

def _cod_style(cs: bytes, style: int) -> bytes:
    k = cs.index(b"\xff\x52")
    return cs[:k + 12] + bytes([style]) + cs[k + 13:]


def _insert_main(cs: bytes, segment: bytes) -> bytes:
    k = cs.index(b"\xff\x90")
    return cs[:k] + segment + cs[k:]


def _gray_j2k() -> bytes:
    return _pil(_photo(32, 40)[..., 0], True)


REFUSED = {
    # OpenCV reads no image: the JAX package raises IOError, the port ValueError
    "two components (LA)": (lambda: _pil(_photo(32, 40)[..., :2]), "2 components"),
    "signed samples": (lambda: _pil(_photo(32, 40), signed=True), "signed"),
    "image offset": (lambda: _pil(_photo(32, 40), offset=(4, 6), tile_offset=(3, 5),
                                  tile_size=(16, 16)), "image offset"),
    "4-bit samples": (lambda: _precisions(_gray_j2k(), [4]), "4-bit"),
    "20-bit samples": (lambda: _precisions(_gray_j2k(), [20]), "20-bit"),
    "gray colour space over RGBA": (lambda: _with_colour(_pil(_mode(_photo(32, 40), "RGBA")),
                                                         17), "gray colour space"),
    "sub-sampled component": (lambda: _gray_j2k()[:44] + b"\x02" + _gray_j2k()[45:],
                              "sub-sampled"),
    "truncated codestream": (lambda: _gray_j2k()[:len(_gray_j2k()) // 2], "truncated"),
    "codestream without EOC": (lambda: _gray_j2k()[:-2], "truncated"),
    "corrupted packet header": (
        lambda: (lambda cs, k: cs[:k + 2] + b"\xff\x7f" * 4 + cs[k + 10:])(
            _gray_j2k(), _gray_j2k().index(b"\xff\x93")), "corrupted packet header"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_files_opencv_refuses_raise_in_both(case, tmp_path):
    make, what = REFUSED[case]
    data = make()
    path = str(tmp_path / "a.jp2")
    with open(path, "wb") as f:
        f.write(data)
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(IOError):
        jio.read_image(path)
    with pytest.raises(ValueError, match=what):
        tio.read_image(path)


UNDECODED = {
    # flags set on a stream coded without them, and features added by hand:
    # OpenCV decodes some (the port gives its image bit for bit) and not
    # others (the TERMALL, PPM marker and 'cmap' without 'pclr' files: the
    # port raises NoImage).  Only HT code-blocks, which no writer here makes,
    # raise a JP2Error naming them.
    **{f"code-block style {name}": (lambda bit=bit: _cod_style(_gray_j2k(), bit), None)
       for bit, name in ((0x01, "BYPASS"), (0x02, "RESET"), (0x04, "TERMALL"), (0x08, "VSC"),
                         (0x10, "PTERM"), (0x20, "SEGSYM"))},
    "code-block style HT": (lambda: _cod_style(_gray_j2k(), 0x40), "HT"),
    "POC marker": (lambda: _insert_main(_gray_j2k(), b"\xff\x5f\x00\x09\x00\x00\x00\x01\x03\x00"
                                        b"\x00"), None),
    "PPM marker": (lambda: _insert_main(_gray_j2k(), b"\xff\x60\x00\x03\x00"), None),
    "RGN marker": (lambda: _insert_main(_gray_j2k(), b"\xff\x5e\x00\x05\x00\x00\x02"), None),
    "palette": (lambda: _with_jp2h_box(_pil(_photo(32, 40)[..., 0]),
                                       b"\x00\x00\x00\x0ccmap\x00\x00\x01\x00"), None),
    "sYCC colour space": (lambda: _with_colour(_pil(_photo(32, 40, seed=13)), 18), None),
}


@pytest.mark.parametrize("case", sorted(UNDECODED))
def test_undecoded_features_raise_naming_them(case, tmp_path):
    """Each file decodes to OpenCV's image (read_image to the JAX package's
    floats) or raises NoImage where OpenCV gives none; HT code-blocks raise
    a JP2Error naming them."""
    make, what = UNDECODED[case]
    data = make()
    if what:
        with pytest.raises(ValueError, match=what):
            decode_jp2(data)
    elif _ref(data) is None:
        with pytest.raises(tio.NoImage):
            decode_jp2(data)
    else:
        _check(data, tmp_path, ".j2k" if data[:2] == b"\xff\x4f" else ".jp2")


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

def _sha(img: np.ndarray) -> dict:
    img = np.ascontiguousarray(img)
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def test_fixture_decodes_to_its_recorded_hashes():
    """tests/data_jp2: OpenCV and the port decode each file to the hash
    recorded beside it (what chip_smoke.py phase 8k holds on the card), the
    views are JPEG 2000 under .jpg / .png names, the lossless masks are equal
    and binary, and the port's load_image_folder (masks found by stem) gives
    the JAX package's arrays."""
    with open(os.path.join(FIXTURE, "opencv_sha256.json")) as f:
        expected = json.load(f)
    assert sorted(expected) == ["image/view0.jpg", "image/view1.png", "image/view2.png",
                                "mask/view0.jp2", "mask/view1.j2k", "mask/view2.jp2"]
    for key, want in expected.items():
        with open(os.path.join(FIXTURE, key), "rb") as f:
            data = f.read()
        assert tio.sniff(data) == "JPEG 2000", key
        assert _sha(_ref(data)) == want, key
        assert _sha(tio.decode_image(data, key)) == want, key
    masks = [tio.read_image(os.path.join(FIXTURE, "mask", n)) for n in ("view0.jp2", "view1.j2k")]
    np.testing.assert_array_equal(masks[0], masks[1])
    assert set(np.unique(masks[0]).tolist()) == {0.0, 1.0}
    got = load_image_folder(FIXTURE, mask_dir=os.path.join(FIXTURE, "mask"))
    ref = j_load_image_folder(FIXTURE, mask_dir=os.path.join(FIXTURE, "mask"))
    assert [os.path.basename(p) for p in got[0]] == ["view0.jpg", "view1.png", "view2.png"]
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_decoder_runs_without_opencv_pil_jax_or_the_jax_package():
    """Where cv2, PIL, glymur, jax and iron_tpu cannot be imported, as on the
    card's machine, decode_jp2 and read_image decode both fixtures
    (tests/data_jp2, tests/data_jp2_corners) to their recorded hashes, and
    the writer (jp2_enc.py) writes a mask that decodes back exactly."""
    code = f"""
import sys, json, hashlib
for m in ('cv2', 'PIL', 'glymur', 'jax', 'iron_tpu'):
    sys.modules[m] = None
import numpy as np
from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.jp2 import decode_jp2
ok = {{}}
for root in ({FIXTURE!r}, {FIXTURE + "_corners"!r}):
    expected = json.load(open(root + "/opencv_sha256.json"))
    for key, want in expected.items():
        img = np.ascontiguousarray(decode_jp2(open(root + "/" + key, "rb").read()))
        ok[root + key] = [list(img.shape), str(img.dtype),
                          hashlib.sha256(img.tobytes()).hexdigest()] == [
            want["shape"], want["dtype"], want["sha256"]]
        ok[root + key] &= tio.read_image(root + "/" + key).shape == (256, 256, 3)
root = {FIXTURE!r}
from iron_tpu_torch.data.jp2_enc import encode_jp2
mask = decode_jp2(open(root + "/mask/view0.jp2", "rb").read())
ok["encoder"] = bool(np.array_equal(decode_jp2(encode_jp2(mask)), mask))
ok["blocked"] = [m for m in ('cv2', 'PIL', 'glymur', 'jax', 'iron_tpu')
                 if sys.modules.get(m) is not None]
print(json.dumps(ok))
"""
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got.pop("blocked") == [] and len(got) == 13 and all(got.values()), got
