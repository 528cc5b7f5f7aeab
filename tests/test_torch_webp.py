"""The port's WebP and PAM decoders (iron_tpu_torch/data/webp.py,
formats.py::read_pam) against OpenCV, which the JAX package reads them
through: every file decodes bit-equal to cv2.imdecode(IMREAD_UNCHANGED)
(channels in RGB(A) order), and read_image gives the JAX package's floats.

WebP files come from OpenCV, PIL and the system's libwebp with its
encoder's options (tests/image_format_writers.py::encode_webp), from VP8
frames re-coded with several token partitions and loop-filter deltas
(vp8_recode: libwebp's encoder writes neither), and by hand: ALPH chunks
with each filter, raw and VP8L-coded, and animations whose first frame
lies inside the canvas.  The committed fixture tests/data_webp (written by
scripts/make_webp_fixtures.py) decodes to its recorded hashes through both."""
import hashlib
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

import image_format_writers as W
from iron_tpu.data import io as jio
from iron_tpu.data.dataset import load_image_folder as j_load_image_folder

from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.dataset import load_image_folder
from iron_tpu_torch.data.formats import read_pam
from iron_tpu_torch.data.webp import decode_webp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data_webp")
_SRC = cv2.imread(os.path.join(REPO, "tests", "data_singleview", "12.png"))[..., ::-1]


def _photo(H: int, W: int, seed: int = 0, noise: float = 12.0) -> np.ndarray:
    """The object of tests/data_singleview/12.png shrunk to [H, W] with
    noise (RGB uint8)."""
    crop = np.ascontiguousarray(_SRC[60:466, 109:403])
    img = cv2.resize(crop, (W, H), interpolation=cv2.INTER_AREA).astype(np.float64)
    img += np.random.default_rng(seed).normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _alpha(H: int, W: int) -> np.ndarray:
    a = (np.add.outer(np.arange(H) * 5, np.arange(W) * 3) % 256).astype(np.uint8)
    a[H // 4:H // 2, W // 5:W // 2] = 0
    a[-H // 4:, :W // 3] = 255
    return a


def _ref(data: bytes) -> np.ndarray:
    """OpenCV's decode in RGB(A) order (None where it reads no image)."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is not None and img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _check(data: bytes) -> np.ndarray:
    ref = _ref(data)
    assert ref is not None
    got = tio.decode_image(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def _cv2(img_rgb: np.ndarray, quality: int) -> bytes:
    ok, buf = cv2.imencode(".webp", np.ascontiguousarray(img_rgb[..., ::-1]),
                           [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return buf.tobytes()


def _pil(img: np.ndarray, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(img).save(f, "WEBP", **kw)
    return f.getvalue()


# ---------------------------------------------------------------------------
# lossless (VP8L)
# ---------------------------------------------------------------------------

def _palette(H, W, colors):
    idx = (np.add.outer(np.arange(H) // 3, np.arange(W) // 5) % colors).astype(np.uint8)
    table = np.random.default_rng(colors).integers(0, 256, (colors, 3), dtype=np.uint8)
    return table[idx]


LOSSLESS = {
    "cv2 q101": lambda: _cv2(_photo(40, 52), 101),
    "PIL method 0": lambda: _pil(_photo(40, 52), lossless=True, method=0),
    "PIL method 3": lambda: _pil(_photo(40, 52), lossless=True, method=3, quality=40),
    "PIL method 6 q100": lambda: _pil(_photo(40, 52), lossless=True, method=6, quality=100),
    "PIL RGBA exact": lambda: _pil(np.dstack([_photo(40, 52), _alpha(40, 52)]), lossless=True,
                                   exact=True),
    "PIL RGBA not exact": lambda: _pil(np.dstack([_photo(24, 30), _alpha(24, 30)]),
                                       lossless=True),
    "palette 2 colours (8 a byte)": lambda: _pil(_palette(21, 35, 2), lossless=True),
    "palette 4 colours (4 a byte)": lambda: _pil(_palette(21, 35, 4), lossless=True),
    "palette 11 colours (2 a byte)": lambda: _pil(_palette(21, 35, 11), lossless=True),
    "palette 200 colours": lambda: _pil(_palette(30, 30, 200), lossless=True),
    "libwebp near-lossless": lambda: W.encode_webp(_photo(30, 41), lossless=1, near_lossless=40),
    "libwebp delta palette": lambda: W.encode_webp(_photo(30, 41) // 64 * 64, lossless=1,
                                                   use_delta_palette=1),
    "1x1": lambda: _pil(_photo(1, 1), lossless=True),
    "odd 13x7": lambda: _pil(_photo(13, 7), lossless=True),
}


@pytest.mark.parametrize("case", sorted(LOSSLESS))
def test_lossless_matches_opencv(case):
    data = LOSSLESS[case]()
    assert data[12:16] in (b"VP8L", b"VP8X")
    _check(data)


# ---------------------------------------------------------------------------
# lossy (VP8)
# ---------------------------------------------------------------------------

LOSSY = {
    **{f"cv2 q{q} 64x48": (lambda q=q: _cv2(_photo(48, 64), q)) for q in (95, 75, 30, 1)},
    **{f"cv2 q80 {w}x{h}": (lambda w=w, h=h: _cv2(_photo(h, w), 80))
       for w, h in ((1, 1), (17, 5), (33, 31), (7, 40))},
    "PIL method 0": lambda: _pil(_photo(40, 50), quality=70, method=0),
    "PIL method 6": lambda: _pil(_photo(40, 50), quality=70, method=6),
    **{f"simple filter sharpness {s}": (lambda s=s: W.encode_webp(
        _photo(48, 56), quality=50, filter_type=0, filter_strength=70, filter_sharpness=s))
       for s in (0, 3, 7)},
    **{f"normal filter sharpness {s}": (lambda s=s: W.encode_webp(
        _photo(48, 56), quality=50, filter_type=1, filter_strength=90, filter_sharpness=s))
       for s in (0, 5)},
    "no filter": lambda: W.encode_webp(_photo(48, 56), quality=50, filter_strength=0),
    "autofilter": lambda: W.encode_webp(_photo(48, 56), quality=50, autofilter=1),
    "one segment": lambda: W.encode_webp(_photo(48, 56), quality=40, segments=1),
    "four segments, strong sns": lambda: W.encode_webp(_photo(48, 56), quality=40, segments=4,
                                                       sns_strength=100),
    "sharp yuv": lambda: W.encode_webp(_photo(48, 56), quality=60, use_sharp_yuv=1),
    "gray content": lambda: _cv2(np.repeat(_photo(40, 44)[..., :1], 3, -1), 85),
}


@pytest.mark.parametrize("case", sorted(LOSSY))
def test_lossy_matches_opencv(case):
    data = LOSSY[case]()
    assert data[12:16] == b"VP8 "
    _check(data)


def test_gray_lossless_matches_opencv():
    _check(_pil(np.repeat(_photo(33, 29)[..., :1], 3, -1), lossless=True))


@pytest.mark.parametrize("partitions", [1, 2, 3])
def test_token_partitions_match_opencv(partitions):
    """A frame re-coded into 2, 4 and 8 token partitions (the same
    decisions; libwebp's encoder always writes one)."""
    base = W.encode_webp(_photo(80, 40, seed=2), quality=60)
    data = W.vp8_recode(base, partitions_log2=partitions)
    assert len(data) > len(base)
    np.testing.assert_array_equal(_check(data), _ref(base))


@pytest.mark.parametrize("deltas,filter_type", [
    ([5, 0, 0, 0, -7, 0, 0, 0], 1), ([-20, 3, 1, 2, 30, -4, 0, 9], 1),
    ([63, 0, 0, 0, -40, 0, 0, 0], 1), ([12, 0, 0, 0, -5, 0, 0, 0], 0)])
def test_loop_filter_deltas_match_opencv(deltas, filter_type):
    """The reference and mode loop-filter deltas (the first of each applies
    to a key frame: the reference delta to every macroblock, the mode delta
    to the 4x4-predicted ones), re-coded into a frame of four segments; the
    decode differs from the frame's without them."""
    base = W.encode_webp(_photo(64, 48, seed=3), quality=50, segments=4, sns_strength=90,
                         filter_type=filter_type, filter_strength=60)
    data = W.vp8_recode(base, partitions_log2=1, lf_deltas=deltas)
    got = _check(data)
    assert not np.array_equal(got, _ref(base))


# ---------------------------------------------------------------------------
# alpha (ALPH), animation
# ---------------------------------------------------------------------------

def _alpha_filter(a: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward alpha filters (none, horizontal, vertical,
    gradient), mod 256."""
    a = a.astype(np.int64)
    out = a.copy()
    out[0, 1:] = a[0, 1:] - a[0, :-1]
    if method == 1:
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        out[1:, 1:] = a[1:, 1:] - a[1:, :-1]
    elif method == 2:
        out[1:] = a[1:] - a[:-1]
    elif method == 3:
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        pred = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
        out[1:, 1:] = a[1:, 1:] - pred
    return (out if method else a) & 0xFF


def _with_alph(rgb: np.ndarray, alpha: np.ndarray, compression: int, method: int,
               preprocessing: int = 0) -> bytes:
    """VP8X + ALPH (built here: `compression` 0 raw or 1 VP8L, filter
    `method`) + the VP8 frame libwebp encodes of `rgb`."""
    H, Wd = alpha.shape
    filtered = _alpha_filter(alpha, method).astype(np.uint8)
    if compression == 0:
        payload = filtered.tobytes()
    else:
        green = np.dstack([np.zeros_like(filtered), filtered, np.zeros_like(filtered)])
        vp8l = W.encode_webp(green, lossless=1, exact=1)
        assert vp8l[12:16] == b"VP8L"
        payload = vp8l[20 + 5:20 + struct.unpack("<I", vp8l[16:20])[0]]
    alph = bytes([compression | (method << 2) | (preprocessing << 4)]) + payload
    vp8 = W.encode_webp(rgb, quality=70)
    assert vp8[12:16] == b"VP8 "
    vp8x = bytes([0x10, 0, 0, 0]) + struct.pack("<I", Wd - 1)[:3] + struct.pack("<I", H - 1)[:3]
    return W._riff_webp([W.webp_chunk(b"VP8X", vp8x), W.webp_chunk(b"ALPH", alph), vp8[12:]])


@pytest.mark.parametrize("method", [0, 1, 2, 3])
@pytest.mark.parametrize("compression", [0, 1])
def test_alpha_filters_match_opencv(compression, method):
    """ALPH raw and VP8L-coded (the green channel), with the none,
    horizontal, vertical and gradient filters."""
    rgb, a = _photo(37, 43), _alpha(37, 43)
    got = _check(_with_alph(rgb, a, compression, method, preprocessing=method & 1))
    np.testing.assert_array_equal(got[..., 3], a)


@pytest.mark.parametrize("alpha_quality,filtering", [(100, 0), (100, 2), (40, 1)])
def test_libwebp_alpha_matches_opencv(alpha_quality, filtering):
    """Alpha as libwebp's encoder writes it (its choice of filter, lossy
    alpha with the pre-processing flag below quality 100)."""
    img = np.dstack([_photo(44, 36), _alpha(44, 36)])
    _check(W.encode_webp(img, quality=75, alpha_quality=alpha_quality,
                         alpha_filtering=filtering, preprocessing=4 * (alpha_quality < 100)))
    _check(_pil(img, quality=80))


def _animation(first: np.ndarray, offset, canvas, alpha: bool, lossless: bool) -> bytes:
    """VP8X (animation) + ANIM + one ANMF: `first` at `offset` (even) of a
    `canvas` (width, height)."""
    H, Wd = first.shape[:2]
    img = np.dstack([first, np.full((H, Wd), 180, np.uint8)]) if alpha else first
    coded = W.encode_webp(img, lossless=int(lossless), quality=80)[12:]
    if coded[:4] == b"VP8X":
        coded = coded[18:]
    u24 = lambda v: struct.pack("<I", v)[:3]
    anmf = (u24(offset[0] // 2) + u24(offset[1] // 2) + u24(Wd - 1) + u24(H - 1) + u24(100)
            + bytes([0]))
    vp8x = bytes([0x02 | (0x10 if alpha else 0), 0, 0, 0]) + u24(canvas[0] - 1) + u24(
        canvas[1] - 1)
    return W._riff_webp([W.webp_chunk(b"VP8X", vp8x),
                         W.webp_chunk(b"ANIM", struct.pack("<IH", 0xFF336699, 0)),
                         W.webp_chunk(b"ANMF", anmf + coded)])


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("alpha", [False, True])
def test_animation_first_frame_matches_opencv(alpha, lossless):
    """An animation gives its first frame, composed on a transparent canvas
    (a frame inside it, from a hand-made ANMF; 3 channels without the alpha
    flag), and PIL's two-frame animations."""
    got = _check(_animation(_photo(10, 20), (6, 4), (40, 30), alpha, lossless))
    assert got.shape == (30, 40, 4 if alpha else 3)
    assert not got[:4].any()
    frames = [np.dstack([_photo(30, 40, s), _alpha(30, 40)]) if alpha else _photo(30, 40, s)
              for s in (4, 5)]
    f = io.BytesIO()
    Image.fromarray(frames[0]).save(f, "WEBP", save_all=True,
                                    append_images=[Image.fromarray(frames[1])],
                                    duration=100, lossless=lossless, quality=80)
    _check(f.getvalue())


def test_read_image_matches_the_jax_package(tmp_path):
    """read_image of WebP (lossy, lossless, alpha) and PAM files gives the
    JAX package's float arrays bit for bit, the 2-channel PAM (gray +
    alpha) included."""
    rgb = _photo(30, 26)
    files = {"a.webp": _cv2(rgb, 80), "b.png": _cv2(rgb, 101),
             "c.jpg": _pil(np.dstack([rgb, _alpha(30, 26)]), quality=70),
             "d.pam": _pam(26, 30, 3, 255, b"RGB", 1),
             "e.pam": _pam(26, 30, 2, 65535, b"GRAYSCALE_ALPHA", 2),
             "f.pam": _pam(26, 30, 1, 255, b"GRAYSCALE", 3)}
    for name, data in files.items():
        path = tmp_path / name
        path.write_bytes(data)
        a, b = tio.read_image(str(path)), jio.read_image(str(path))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_corrupt_webp_raises():
    data = bytearray(_cv2(_photo(16, 16), 80))
    with pytest.raises(ValueError):
        decode_webp(bytes(data[:30]))
    data[12:16] = b"VP9 "
    assert _ref(bytes(data)) is None
    with pytest.raises(ValueError):
        tio.decode_image(bytes(data))


# ---------------------------------------------------------------------------
# PAM
# ---------------------------------------------------------------------------

def _pam(W_: int, H: int, depth: int, maxval: int, tupltype, seed: int, extra: bytes = b"",
         sep: bytes = b"\n") -> bytes:
    rng = np.random.default_rng(seed)
    n = W_ * H * depth
    if maxval > 255:
        data = rng.integers(0, maxval + 1, n).astype(">u2").tobytes()
    else:
        data = rng.integers(0, maxval + 1, n).astype(np.uint8).tobytes()
    fields = [b"WIDTH %d" % W_, b"HEIGHT %d" % H, b"DEPTH %d" % depth, b"MAXVAL %d" % maxval]
    if tupltype is not None:
        fields.append(b"TUPLTYPE " + tupltype)
    return b"P7" + sep + extra + sep.join(fields) + sep + b"ENDHDR" + sep[-1:] + data


PAMS = {
    **{f"depth {d} {bits}-bit {'with' if tt else 'without'} TUPLTYPE": (d, m, tt)
       for d, tt_name in ((1, b"GRAYSCALE"), (2, b"GRAYSCALE_ALPHA"), (3, b"RGB"),
                          (4, b"RGB_ALPHA"))
       for bits, m in ((8, 255), (16, 65535))
       for tt in (tt_name, None)},
    "gray MAXVAL 15": (1, 15, b"GRAYSCALE"),
    "gray MAXVAL 1000": (1, 1000, b"GRAYSCALE"),
    "BLACKANDWHITE": (1, 1, b"BLACKANDWHITE"),
    "MAXVAL 1 without TUPLTYPE": (1, 1, None),
    "RGB MAXVAL 1": (3, 1, b"RGB"),
    "RGB_ALPHA MAXVAL 1": (4, 1, b"RGB_ALPHA"),
    "TUPLTYPE against DEPTH": (3, 255, b"GRAYSCALE"),
    "unknown TUPLTYPE": (1, 255, b"CMYK"),
    "MAXVAL 70000": (1, 70000, b"GRAYSCALE"),
}


@pytest.mark.parametrize("case", sorted(PAMS))
def test_pam_matches_opencv(case):
    """Each DEPTH at 8 and 16 bits, with and without TUPLTYPE: the port
    reads what OpenCV reads (samples as stored, the file's channel order)
    and refuses what it refuses."""
    depth, maxval, tt = PAMS[case]
    data = _pam(11, 6, depth, maxval, tt, seed=depth + maxval)
    ref = _ref(data)
    if ref is None:
        with pytest.raises(ValueError, match="PAM"):
            tio.decode_image(data)
        return
    got = tio.decode_image(data)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(read_pam(data), got)


@pytest.mark.parametrize("variant", ["comment", "crlf", "padded values", "extra data",
                                     "truncated", "no ENDHDR", "P7 then a space"])
def test_pam_header_variants_match_opencv(variant):
    data = {"comment": _pam(9, 4, 3, 255, b"RGB", 1, extra=b"# a comment\n"),
            "crlf": _pam(9, 4, 1, 255, b"GRAYSCALE", 2, sep=b"\r\n"),
            "padded values": _pam(9, 4, 1, 255, b"GRAYSCALE", 3).replace(b"WIDTH 9",
                                                                          b"  WIDTH   9  "),
            "extra data": _pam(9, 4, 1, 255, None, 4) + b"\x01\x02",
            "truncated": _pam(9, 4, 3, 255, b"RGB", 5)[:-3],
            "no ENDHDR": _pam(9, 4, 1, 255, None, 6).replace(b"ENDHDR\n", b""),
            "P7 then a space": _pam(9, 4, 1, 255, None, 7).replace(b"P7\n", b"P7 ")}[variant]
    ref = _ref(data)
    if ref is None:
        with pytest.raises(ValueError):
            tio.decode_image(data)
    else:
        np.testing.assert_array_equal(tio.decode_image(data), ref)


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

def _sha(img: np.ndarray) -> dict:
    img = np.ascontiguousarray(img)
    return {"shape": list(img.shape), "dtype": str(img.dtype),
            "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def test_fixture_decodes_to_its_recorded_hashes():
    """tests/data_webp: OpenCV and the port decode each file to the hash
    recorded beside it (what chip_smoke.py phase 8j holds on the card),
    and the port's load_image_folder gives the JAX package's arrays."""
    with open(os.path.join(FIXTURE, "opencv_sha256.json")) as f:
        expected = json.load(f)
    assert sorted(expected) == ["image/view0.jpg", "image/view1.png", "image/view2.png",
                                "mask/view0.webp", "mask/view1.pam", "mask/view2.webp"]
    for key, want in expected.items():
        with open(os.path.join(FIXTURE, key), "rb") as f:
            data = f.read()
        assert _sha(_ref(data)) == want, key
        assert _sha(tio.decode_image(data, key)) == want, key
    kinds = {k: open(os.path.join(FIXTURE, k), "rb").read()[12:16] for k in expected
             if not k.endswith(".pam")}
    assert kinds == {"image/view0.jpg": b"VP8 ", "image/view1.png": b"VP8X",
                     "image/view2.png": b"VP8L", "mask/view0.webp": b"VP8L",
                     "mask/view2.webp": b"VP8 "}
    got = load_image_folder(FIXTURE, mask_dir=os.path.join(FIXTURE, "mask"))
    ref = j_load_image_folder(FIXTURE, mask_dir=os.path.join(FIXTURE, "mask"))
    assert [os.path.basename(p) for p in got[0]] == ["view0.jpg", "view1.png", "view2.png"]
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
