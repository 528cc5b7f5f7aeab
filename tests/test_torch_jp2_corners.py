"""The JPEG 2000 corners of the port's decoder (iron_tpu_torch/data/jp2.py,
jp2_t1.py) against OpenCV, which the JAX package reads JPEG 2000 through:
every file decodes bit-equal to cv2.imdecode(IMREAD_UNCHANGED) (channels in
RGB(A) order) with read_image giving the JAX package's floats, or raises
NoImage where OpenCV gives None.

Files come from the system's OpenJPEG through ctypes
(image_format_writers.openjpeg_encode): the six code-block styles and their
combinations on 5/3 and 9/7, POC split by resolution and by layer, tile-parts,
RGN, sYCC, CMYK / e-YCC colour spaces and Part 2 transforms; then edited by
hand: a POC moved into the main header, a CRG marker, packet headers moved
into PPM or PPT markers, palettes ('pclr' + 'cmap') under each 'colr'.  The
committed fixture tests/data_jp2_corners (scripts/make_jp2_corner_fixtures.py)
decodes to its recorded hashes (without cv2, PIL, glymur, jax and iron_tpu:
test_torch_jp2.py::test_decoder_runs_without_opencv_pil_jax_or_the_jax_package)."""
import ctypes
import hashlib
import json
import os
import struct

import cv2
import numpy as np
import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

import image_format_writers as W
from iron_tpu.data import io as jio
from iron_tpu.data.dataset import load_image_folder as j_load_image_folder

from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data import jp2 as J
from iron_tpu_torch.data.dataset import load_image_folder
from iron_tpu_torch.data.jp2 import JP2NoImage, decode_jp2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data_jp2_corners")


def _image(H: int, W_: int, C: int = 3, seed: int = 0, top: int = 256) -> np.ndarray:
    """A blurred noise image of values below `top`, [H, W_] or [H, W_, C]."""
    g = np.random.default_rng(seed)
    img = cv2.GaussianBlur(g.integers(0, 256, (H, W_, C)).astype(np.uint8), (5, 5), 1.5)
    img = img.reshape(H, W_, C)
    img = img.astype(np.int64) * (top // 256) + g.integers(0, max(1, top // 256), img.shape)
    return img[..., 0] if C == 1 else img


def _ref(data: bytes):
    """OpenCV's decode in RGB(A) order (None where it reads no image)."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is not None and img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _check(data: bytes, tmp_path) -> np.ndarray:
    """The port's decode equals OpenCV's, and its read_image the JAX
    package's, bit for bit; or both refuse (NoImage / IOError)."""
    ref = _ref(data)
    path = str(tmp_path / ("a.j2k" if data[:2] == b"\xff\x4f" else "a.jp2"))
    with open(path, "wb") as f:
        f.write(data)
    if ref is None:
        with pytest.raises(JP2NoImage):
            decode_jp2(data)
        with pytest.raises(IOError):
            jio.read_image(path)
        with pytest.raises(tio.NoImage):
            tio.read_image(path)
        return None
    got = tio.decode_image(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tio.read_image(path), jio.read_image(path))
    return got


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def test_openjpeg_parameter_layout():
    """opj_set_default_encoder_parameters writes its defaults where
    openjpeg_encode puts its fields: 6 resolutions, 64 x 64 code-blocks, no
    ROI component (-1), sub-sampling 1, everything else of those fields 0."""
    buf = ctypes.create_string_buffer(b"\xa5" * W.OPJ_CPARAMETERS_SIZE,
                                      W.OPJ_CPARAMETERS_SIZE)
    W.libopenjp2().opj_set_default_encoder_parameters(buf)

    def field(name, fmt="i", at=0):
        return struct.unpack_from("<" + fmt, buf, W.OPJ_CP[name] + at)[0]

    assert (field("numresolution"), field("cblockw_init"), field("cblockh_init")) == (6, 64, 64)
    assert (field("roi_compno"), field("subsampling_dx"), field("subsampling_dy")) == (-1, 1, 1)
    for name in ("tile_size_on", "cp_disto_alloc", "csty", "prog_order", "numpocs",
                 "tcp_numlayers", "mode", "irreversible", "roi_shift", "res_spec"):
        assert field(name) == 0, name
    assert (field("tp_on", "b"), field("tp_flag", "b"), field("tcp_mct", "b")) == (0, 0, 0)
    assert field("tcp_rates", "f") == 0.0 and field("POC", "I") == 0


# ---------------------------------------------------------------------------
# code-block styles, POC, tile-parts, RGN
# ---------------------------------------------------------------------------

_STYLES = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x05, 0x33, 0x3F)


@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
@pytest.mark.parametrize("style", _STYLES, ids=[f"0x{s:02x}" for s in _STYLES])
def test_code_block_styles(style, irreversible, tmp_path):
    """Each style alone and BYPASS + TERMALL, the header damage's 0x33 and
    all six, on RGB with RCT / ICT in three layers (segments that span
    packets) and one lossless layer (a 5/3 file decodes to its input)."""
    img = _image(48, 64, seed=style)
    for rates in ((20, 5, 1), (0,)):
        data = W.openjpeg_encode(img, mode=style, irreversible=irreversible, mct=1,
                                 rates=rates, resolutions=4, cblk=(16, 16))
        got = _check(data, tmp_path)
        if rates == (0,) and not irreversible:
            np.testing.assert_array_equal(got, img)


def _move_poc_to_main(cs: bytes) -> bytes:
    """A one-tile-part-header POC moved into the main header (before the
    first SOT), the tile-part's Psot shortened by its length."""
    sot = cs.index(b"\xff\x90")
    k = cs.index(b"\xff\x5f", sot)
    seg = cs[k:k + 2 + struct.unpack_from(">H", cs, k + 2)[0]]
    part = bytearray(cs[sot:k] + cs[k + len(seg):])
    struct.pack_into(">I", part, 6, struct.unpack_from(">I", part, 6)[0] - len(seg))
    return cs[:sot] + seg + bytes(part)


_POCS = {
    # (resno0, compno0, layno1, resno1, compno1, order, tile) each, and the
    # tile-part split OpenJPEG's encoder takes with them: the low
    # resolutions first, then the rest
    "by resolution": ([(0, 0, 3, 2, 3, "LRCP", 1), (2, 0, 3, 5, 3, "RLCP", 1)], "L"),
    # the first layer, then all
    "by layer": ([(0, 0, 1, 5, 3, "RPCL", 1), (0, 0, 3, 5, 3, "CPRL", 1)], "C"),
    "by component": ([(0, 1, 3, 5, 3, "LRCP", 1), (0, 0, 3, 5, 1, "PCRL", 1)], ""),
}


@pytest.mark.parametrize("where", ["tile-part header", "main header"])
@pytest.mark.parametrize("split", sorted(_POCS))
def test_poc(split, where, tmp_path):
    """POC in a tile-part header (as OpenJPEG writes it) and moved into the
    main header, split by resolution, layer or component, in tile-parts
    split by layer or component."""
    img = _image(40, 56, seed=3)
    pocs, parts = _POCS[split]
    data = W.openjpeg_encode(img, j2k=True, mct=1, rates=(20, 5, 1), resolutions=5,
                             cblk=(16, 16), pocs=pocs, tile_parts=parts)
    assert b"\xff\x5f" in data
    if where == "main header":
        data = _move_poc_to_main(data)
        assert data.index(b"\xff\x5f") < data.index(b"\xff\x90")
    _check(data, tmp_path)


@pytest.mark.parametrize("parts", ["R", "L", "C"])
def test_tile_parts_with_poc_and_tiles(parts, tmp_path):
    """Four tiles, each split into tile-parts by resolution, layer or
    component, with a POC per tile."""
    img = _image(48, 64, seed=4)
    pocs = [(0, 0, 2, 4, 3, "RLCP", t) for t in range(1, 5)]
    data = W.openjpeg_encode(img, j2k=True, rates=(10, 1), resolutions=4, cblk=(16, 16),
                             tile=(32, 24), tile_parts=parts, pocs=pocs)
    _check(data, tmp_path)


@pytest.mark.parametrize("irreversible", [False, True], ids=["5-3", "9-7"])
@pytest.mark.parametrize("shift", [3, 7, 12])
def test_rgn(shift, irreversible, tmp_path):
    """OpenJPEG's RGN max-shift (in the tile-part header) on component 0 of
    an RGB image and of a gray one, with BYPASS in one of them."""
    img = _image(40, 56, seed=shift)
    _check(W.openjpeg_encode(img, irreversible=irreversible, mct=1, rates=(8, 1),
                             resolutions=4, roi=(0, shift)), tmp_path)
    _check(W.openjpeg_encode(img[..., 1], irreversible=irreversible, mode=1, rates=(8, 1),
                             resolutions=4, roi=(0, shift)), tmp_path)


def test_crg(tmp_path):
    """A CRG marker in the main header is read and checked (4 bytes a
    component), then ignored; one of the wrong length gives no image."""
    cs = W.openjpeg_encode(_image(40, 56, seed=8), j2k=True, resolutions=4)
    k = cs.index(b"\xff\x90")
    for body in (b"\x00\x00\x80\x00" * 3, b"\x00\x00\x80\x00" * 2):
        data = cs[:k] + b"\xff\x63" + struct.pack(">H", 2 + len(body)) + body + cs[k:]
        got = _check(data, tmp_path)
        assert (got is None) == (len(body) != 12)


# ---------------------------------------------------------------------------
# packed packet headers
# ---------------------------------------------------------------------------

_PACKED = {
    "gray 5/3": dict(comps=_image(40, 56, C=1, seed=9), resolutions=4, rates=(10, 1)),
    "RGB 9/7 BYPASS": dict(comps=_image(48, 64, seed=10), irreversible=True, mct=1, mode=1,
                           rates=(20, 5, 1), resolutions=4, cblk=(16, 16)),
    "RGB 4 tiles": dict(comps=_image(48, 64, seed=11), mct=1, rates=(10, 1), resolutions=3,
                        tile=(32, 24)),
}


@pytest.mark.parametrize("chunk", [0, 7], ids=["one marker", "7-byte markers"])
@pytest.mark.parametrize("kind", ["PPM", "PPT"])
@pytest.mark.parametrize("case", sorted(_PACKED))
def test_ppm_ppt(case, kind, chunk, tmp_path):
    """Packet headers read from PPM or PPT markers (one, or many short ones
    whose Nppm runs cross markers) give OpenCV's image, which is that of
    the same stream with the headers in place."""
    kw = dict(_PACKED[case])
    cs = W.openjpeg_encode(kw.pop("comps"), j2k=True, **kw)
    data = W.pack_packet_headers(cs, kind, chunk)
    assert np.array_equal(_ref(data), _ref(cs))
    _check(data, tmp_path)


def test_ppm_and_ppt_refused(tmp_path):
    """OpenJPEG stops (OpenCV gives no image) on a PPT beside a PPM, a Zppt
    read twice, and PPM markers whose Nppm runs past their end."""
    cs = W.openjpeg_encode(_image(40, 56, C=1, seed=12), j2k=True, resolutions=3)
    ppm, ppt = W.pack_packet_headers(cs, "PPM"), W.pack_packet_headers(cs, "PPT")
    sod = ppt.index(b"\xff\x93")
    k = ppt.index(b"\xff\x61")
    n = struct.unpack_from(">H", ppt, k + 2)[0]
    seg = ppt[k:k + 2 + n]
    both = ppm[:ppm.index(b"\xff\x90") + 12] + seg + ppm[ppm.index(b"\xff\x90") + 12:]
    twice = ppt[:sod] + seg + ppt[sod:]
    p = ppm.index(b"\xff\x60")
    short = ppm[:p + 5] + struct.pack(">I", struct.unpack_from(">I", ppm, p + 5)[0] + 9) + \
        ppm[p + 9:]
    for data in (both, twice, short):
        data = bytearray(data)
        s = data.index(b"\xff\x90")
        struct.pack_into(">I", data, s + 6, len(data) - s - 2)
        assert _check(bytes(data), tmp_path) is None


# ---------------------------------------------------------------------------
# palettes and colour spaces
# ---------------------------------------------------------------------------

def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _with_jp2h(jp2: bytes, boxes: bytes) -> bytes:
    h = jp2.index(b"jp2h") - 4
    n = struct.unpack_from(">I", jp2, h)[0]
    return jp2[:h] + struct.pack(">I", n + len(boxes)) + jp2[h + 4:h + n] + boxes + jp2[h + n:]


def _colr(jp2: bytes, enum) -> bytes:
    """The 'colr' box set to an enumerated space, or to an ICC profile
    (method 2) where `enum` is None, the 'jp2h' box's length kept true."""
    k = jp2.index(b"colr") - 4
    n = struct.unpack_from(">I", jp2, k)[0]
    body = b"\x01\x00\x00" + struct.pack(">I", enum) if enum is not None else \
        b"\x02\x00\x00" + b"\x00" * 16
    out = jp2[:k] + _box(b"colr", body) + jp2[k + n:]
    h = out.index(b"jp2h") - 4
    size = struct.unpack_from(">I", out, h)[0] + 8 + len(body) - n
    return out[:h] + struct.pack(">I", size) + out[h + 4:]


def pclr(entries: np.ndarray, sizes) -> bytes:
    """A 'pclr' box: entries [N, columns], each column of `sizes` bits."""
    body = struct.pack(">HB", *entries.shape) + bytes(s - 1 for s in sizes)
    for row in entries:
        body += b"".join(int(v).to_bytes((s + 7) // 8, "big") for v, s in zip(row, sizes))
    return _box(b"pclr", body)


def cmap(entries) -> bytes:
    return _box(b"cmap", b"".join(struct.pack(">HBB", *e) for e in entries))


def _palette_file(C: int, K: int, sizes, prec: int = 8, n: int = 20, seed: int = 13,
                  top: int = 24, entries=None):
    """An index image of C components (component 0 the index, up to `top`,
    past the palette's n entries) with a K-column palette over it."""
    g = np.random.default_rng(seed)
    idx = g.integers(0, top, (40, 56))
    comps = [idx] + [g.integers(0, 1 << prec, (40, 56)) for _ in range(C - 1)]
    base = W.openjpeg_encode(np.dstack(comps), prec=prec, resolutions=3,
                             space="gray" if C == 1 else "srgb")
    pal = g.integers(0, 1 << max(sizes), (n, K)) >> (max(sizes) - np.array(sizes))
    return _with_jp2h(base, pclr(pal, sizes) + cmap(entries or [(0, 1, i) for i in range(K)]))


_PALETTES = {
    "1 component, 3 columns": dict(C=1, K=3, sizes=[8, 8, 8]),
    "1 component, 4 columns": dict(C=1, K=4, sizes=[8, 8, 8, 8]),
    "1 component, 1 column": dict(C=1, K=1, sizes=[8]),
    "1 component, 16-bit columns": dict(C=1, K=3, sizes=[16, 16, 16]),
    "1 component, 1- to 12-bit columns": dict(C=1, K=3, sizes=[1, 5, 12]),
    "12-bit index, 3 columns": dict(C=1, K=3, sizes=[16, 10, 3], prec=12, top=1100,
                                    n=1024),
    "3 components, 3 columns": dict(C=3, K=3, sizes=[8, 8, 8]),
    "3 components, 2 columns": dict(C=3, K=2, sizes=[8, 8]),
    "4 components, 3 columns": dict(C=4, K=3, sizes=[8, 8, 8]),
    "4 components, 4 columns": dict(C=4, K=4, sizes=[8, 8, 8, 8]),
    "direct use of component 2": dict(C=3, K=3, sizes=[8, 8, 8],
                                      entries=[(0, 1, 0), (2, 0, 0), (0, 1, 2)]),
    "weird cmap, corrected": dict(C=1, K=3, sizes=[8, 8, 8],
                                  entries=[(0, 0, 0), (0, 0, 0), (0, 0, 0)]),
    "column mapped twice": dict(C=3, K=2, sizes=[8, 8], entries=[(0, 1, 0), (0, 1, 0)]),
    "component out of range": dict(C=1, K=2, sizes=[8, 8], entries=[(0, 1, 0), (1, 1, 1)]),
}


@pytest.mark.parametrize("colour", [16, 17, 18, 3, None],
                         ids=["sRGB", "gray", "sYCC", "unknown", "ICC"])
@pytest.mark.parametrize("case", sorted(_PALETTES))
def test_palettes(case, colour, tmp_path):
    """'pclr' + 'cmap' as OpenJPEG applies them (indices past the end
    clipped, columns of 1-16 bits, direct use, its checks and its "weird
    cmap" correction), then OpenCV's rule for its channels under the
    'colr' space, with as many channels as the codestream has components."""
    data = _colr(_palette_file(**_PALETTES[case]), colour)
    if case == "4 components, 3 columns" and colour not in (17, 18):
        # OpenCV reads a fourth component past the end of OpenJPEG's array
        with pytest.raises(J.JP2Error, match="past the end"):
            decode_jp2(data)
        return
    _check(data, tmp_path)


def test_palette_without_cmap_is_dropped(tmp_path):
    """A 'pclr' with no 'cmap' is dropped (Part 1, I.5.3.4): the index
    image as it is."""
    g = np.random.default_rng(14)
    base = W.openjpeg_encode(g.integers(0, 40, (40, 56)), space="gray", resolutions=3)
    data = _with_jp2h(base, pclr(g.integers(0, 256, (20, 3)), [8, 8, 8]))
    np.testing.assert_array_equal(_check(data, tmp_path), _ref(base))


_SPACES = {
    "sYCC 8-bit": dict(comps=_image(40, 56, seed=15), space="sycc"),
    "sYCC 12-bit": dict(comps=_image(40, 56, seed=16, top=4096), prec=12, space="sycc"),
    "sYCC 16-bit": dict(comps=_image(40, 56, seed=17, top=65536), prec=16, space="sycc"),
    "sYCC 9/7": dict(comps=_image(40, 56, seed=18), space="sycc", irreversible=True,
                     rates=(12,)),
    "sYCC gray": dict(comps=_image(40, 56, C=1, seed=19), space="sycc"),
    "sYCC 4 components": dict(comps=_image(40, 56, C=4, seed=20), space="sycc"),
    "sYCC sub-sampled chroma": dict(comps=[_image(40, 56, C=1, seed=21),
                                           _image(20, 28, C=1, seed=22),
                                           _image(20, 28, C=1, seed=23)],
                                    sub=[(1, 1), (2, 2), (2, 2)], space="sycc"),
    "CMYK": dict(comps=_image(40, 56, C=4, seed=24), enum=12),
    "CMYK of 3 components": dict(comps=_image(40, 56, seed=25), enum=12),
    "e-YCC": dict(comps=_image(40, 56, seed=26), enum=24),
    "e-YCC 16-bit": dict(comps=_image(40, 56, seed=27, top=65536), prec=16, enum=24),
    "Part 2 transform": dict(comps=_image(40, 56, seed=28),
                             mct_matrix=[[1, 0, 0], [0, 1, 0], [0, 0, 1]]),
}


@pytest.mark.parametrize("case", sorted(_SPACES))
def test_colour_spaces(case, tmp_path):
    """sYCC as OpenCV converts it (cvtColor's YUV2BGR in fixed point, on
    8- or 16-bit samples), one channel for one component, none for four
    components or sub-sampled chroma; CMYK and e-YCC (OpenJPEG writes
    enumerated space 0, set here) and Part 2 transforms (opj_set_MCT) give
    no image."""
    kw = dict(_SPACES[case])
    enum = kw.pop("enum", None)
    data = W.openjpeg_encode(kw.pop("comps"), resolutions=3, **kw)
    if enum is not None:
        data = _colr(data, enum)
    got = _check(data, tmp_path)
    assert (got is None) == (case.startswith(("CMYK", "e-YCC", "Part 2"))
                             or case in ("sYCC 4 components", "sYCC sub-sampled chroma"))


def test_refused_colour_spaces_name_what_opencv_does():
    data = _colr(W.openjpeg_encode(_image(40, 56, C=4, seed=29), resolutions=3), 12)
    with pytest.raises(JP2NoImage, match="OpenCV reads no image"):
        decode_jp2(data)


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

def _sha(img: np.ndarray) -> dict:
    img = np.ascontiguousarray(img)
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


_FIXTURE_KEYS = ["image/view0.png", "image/view1.jpg", "image/view2.png",
                 "mask/view0.png", "mask/view1.png", "mask/view2.png"]


def test_fixture_decodes_to_its_recorded_hashes():
    """tests/data_jp2_corners: OpenCV and the port decode each file to the
    hash recorded beside it (what chip_smoke.py phase 8r holds on the card),
    every file is JPEG 2000 under a .png / .jpg name and uses its corner,
    the masks are binary, and load_image_folder gives the JAX package's
    arrays."""
    with open(os.path.join(FIXTURE, "opencv_sha256.json")) as f:
        expected = json.load(f)
    assert sorted(expected) == _FIXTURE_KEYS
    for key, want in expected.items():
        with open(os.path.join(FIXTURE, key), "rb") as f:
            data = f.read()
        assert tio.sniff(data) == "JPEG 2000", key
        assert _sha(_ref(data)) == want, key
        assert _sha(tio.decode_image(data, key)) == want, key
    for key, marker in (("image/view0.png", b"\xff\x5f"), ("image/view1.jpg", b"\xff\x5e"),
                        ("image/view1.jpg", b"\xff\x60"), ("mask/view2.png", b"\xff\x61")):
        with open(os.path.join(FIXTURE, key), "rb") as f:
            assert marker in f.read(), (key, marker)
    masks = [tio.read_image(os.path.join(FIXTURE, "mask", f"view{i}.png")) for i in range(3)]
    for m in masks:
        assert set(np.unique(m).tolist()) <= {0.0, 1.0}
    got = load_image_folder(FIXTURE, mask_dir=os.path.join(FIXTURE, "mask"))
    ref = j_load_image_folder(FIXTURE, mask_dir=os.path.join(FIXTURE, "mask"))
    assert [os.path.basename(p) for p in got[0]] == ["view0.png", "view1.jpg", "view2.png"]
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
