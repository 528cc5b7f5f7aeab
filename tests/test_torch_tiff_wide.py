"""The port's TIFF reader (iron_tpu_torch/data/tiff.py, ccitt.py) on the
corners OpenCV reads beyond 8-, 16-, 32- and 64-bit samples: 10-, 12- and
14-bit gray, RGB and RGB + alpha (shifted up to 16 bits), 16-bit (and 10-
to 14-bit) gray files of 3 or 4 samples (weighed to one channel), SGILOG
LogLuv (32-bit RLE, 34676, and 24-bit, 34677, to float32 RGB), and CCITT
strips that hold an uncompressed-mode extension code, which libtiff does
not decode.

Each file is written by the system's libtiff (ctypes,
tests/image_format_writers.py) or by hand; cv2.imread(IMREAD_UNCHANGED)
is the reference decoder and iron_tpu.data.io.read_image the reference
loader: the port's decode is OpenCV's array bit for bit (channels
reversed to RGB(A)), its read_image the JAX package's.  What OpenCV
misreads raises a plain ValueError naming it (what OpenCV refuses is held
in tests/test_torch_tiff.py's REFUSED).  Also: libtiff's LogLuv24 chroma
table as recovered into the package, and tests/data_tiff_wide/."""
import hashlib
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

import image_format_writers as W
from test_torch_image_formats import IMG, _assert_loaders_agree, _assert_reads_as_jax, _write
from test_torch_tiff import _strips, _tiles, _with_short

from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data import tiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, Wd = IMG.shape[:2]                     # 29 x 37: rows end mid-byte, W % 4 == 1
RNG = np.random.default_rng(16)
EXTRA_ALPHA = (338, 1, np.array([2], np.uint16))    # one unassociated alpha sample


def _deep(bps: int, spp: int) -> np.ndarray:
    """`bps`-bit samples [H, W, spp]: the photograph's high bits, noise
    below."""
    img = np.dstack([IMG, IMG[..., :1] // 2 + 40])[..., :spp] if spp != 3 else IMG
    if spp == 1:
        img = IMG[..., :1]
    low = RNG.integers(0, 1 << (bps - 8), img.shape)
    return ((img.astype(np.int64) << (bps - 8)) | low).astype(np.uint16)


def _lt(a: np.ndarray, bps: int, comp: int = 1, photo: int = None, rows: int = None,
        tile: int = None, extra=(), mode: str = "w") -> bytes:
    """`a` [H, W, spp] at `bps` bits a sample written by the system's
    libtiff in strips of `rows` rows or `tile`-square tiles."""
    spp = a.shape[2]
    photo = (1 if spp < 3 else 2) if photo is None else photo
    fields = [(256, a.shape[1]), (257, a.shape[0]), (258, bps), (277, spp), (259, comp),
              (262, photo)] + ([EXTRA_ALPHA] if spp in (2, 4) else [])
    if tile:
        chunks = _tiles(a, tile)
        fields += [(322, tile), (323, tile)]
    else:
        chunks = _strips(a, rows or a.shape[0])
        fields.append((278, rows or a.shape[0]))
    packed = [W.pack_samples(c, bps).tobytes() if bps % 8 else c for c in chunks]
    return W.libtiff_encode(packed, fields + list(extra), mode=mode, tiled=bool(tile))


DEEP = {}
for _b in (10, 12, 14):
    DEEP.update({
        f"{_b}-bit gray, none": (lambda b=_b: _lt(_deep(b, 1), b)),
        f"{_b}-bit gray, min-is-white, PackBits strips of 5": (
            lambda b=_b: _lt(_deep(b, 1), b, 32773, 0, rows=5)),
        f"{_b}-bit RGB, LZW strips of 8": (lambda b=_b: _lt(_deep(b, 3), b, 5, rows=8)),
        f"{_b}-bit RGB + alpha, Deflate": (lambda b=_b: _lt(_deep(b, 4), b, 8)),
        f"{_b}-bit RGB, big-endian Deflate tiles": (
            lambda b=_b: _lt(_deep(b, 3), b, 8, tile=16, mode="wb")),
        f"{_b}-bit gray, LZW tiles, FillOrder 2": (
            lambda b=_b: _lt(_deep(b, 1), b, 5, tile=16, extra=[(266, 2)])),
        f"{_b}-bit RGB + alpha, PackBits, FillOrder 2, big-endian": (
            lambda b=_b: _lt(_deep(b, 4), b, 32773, extra=[(266, 2)], mode="wb")),
        f"{_b}-bit signed gray": (lambda b=_b: _lt(_deep(b, 1), b, extra=[(339, 2)])),
        f"{_b}-bit gray of 3 samples, LZW": (lambda b=_b: _lt(_deep(b, 3), b, 5, 1)),
        f"{_b}-bit gray of 4 samples, Deflate strips of 8": (
            lambda b=_b: _lt(_deep(b, 4), b, 8, 1, rows=8)),
    })
DEEP.update({
    "16-bit gray of 3 samples, none": lambda: _lt(_deep(16, 3), 16, 1, 1),
    "16-bit gray of 4 samples, LZW predictor": lambda: _lt(_deep(16, 4), 16, 5, 1,
                                                           extra=[(317, 2)]),
    "16-bit min-is-white gray of 3 samples, big-endian Deflate tiles": lambda: _lt(
        _deep(16, 3), 16, 8, 0, tile=16, mode="wb"),
    "int16 gray of 3 samples": lambda: _lt(_deep(16, 3), 16, 1, 1, extra=[(339, 2)]),
    "16-bit gray of 3 samples, PackBits, FillOrder 2": lambda: _lt(
        _deep(16, 3), 16, 32773, 1, extra=[(266, 2)]),
})


@pytest.mark.parametrize("case", sorted(DEEP))
def test_deep_samples_read_as_opencv(case, tmp_path):
    """10- to 14-bit samples (uint16, shifted up to 16 bits; a signed file
    saturated to int16) and 3 or 4 gray samples (one uint16 channel of
    OpenCV's 14-bit fixed-point weights): the port's decode is cv2.imread's
    array, its read_image the JAX package's, bit for bit."""
    _assert_reads_as_jax(_write(tmp_path, "a.tif", DEEP[case]()))


def test_deep_samples_are_the_stored_bits_shifted():
    """The rule itself, on a file whose samples are known: 10-bit 871 reads
    as 871 << 6, and gray samples (49273, 34303, 20090) weigh to 37159."""
    a = np.zeros((2, 3, 1), np.uint16)
    a[0, 0] = 871
    assert tio.decode_image(_lt(a, 10))[0, 0] == 871 << 6
    g = np.zeros((2, 3, 3), np.uint16)
    g[0, 0] = (49273, 34303, 20090)
    assert tio.decode_image(_lt(g, 16, photo=1))[0, 0] == 37159


# ---------------------------------------------------------------------------
# SGILOG LogLuv
# ---------------------------------------------------------------------------

def _xyz(h: int = H, w: int = Wd) -> np.ndarray:
    """float32 XYZ [h, w, 3] from the photograph's linear RGB (OpenCV's
    sRGB matrix), scaled over decades, a few pixels black and a few of
    negative luminance."""
    rgb = (IMG.astype(np.float32) / 255) ** 2.2
    rgb = np.tile(rgb, (-(-h // H), -(-w // Wd), 1))[:h, :w]
    m = np.array([[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]], np.float32)
    xyz = rgb @ m.T * np.float32(10.0) ** RNG.uniform(-3, 3, (h, w, 1)).astype(np.float32)
    xyz[0, :3] = 0
    xyz[1, :3] *= -1
    return xyz.astype(np.float32)


def _luv(xyz: np.ndarray, comp: int = 34676, rows: int = None, tile: int = None,
         extra=(), mode: str = "w", data_format: int = 0, data=None) -> bytes:
    """LogLuv written by the system's libtiff from float XYZ (SGILOGDATAFMT
    `data_format` 0) or `data` in another of its formats, with no dither
    (SGILOGENCODE 0), so that the file is the same every time."""
    h, w = xyz.shape[:2]
    fields = [(256, w), (257, h), (277, 3), (262, 32845), (259, comp), (65560, data_format),
              (65561, 0)]
    src = xyz if data is None else data
    if tile:
        chunks = _tiles(src, tile)
        fields += [(322, tile), (323, tile)]
    else:
        chunks = _strips(src, rows or h)
        fields.append((278, rows or h))
    return W.libtiff_encode(chunks, fields + list(extra), mode=mode, tiled=bool(tile))


LUV = {
    "LogLuv32, one strip": lambda: _luv(_xyz()),
    "LogLuv32, strips of 7": lambda: _luv(_xyz(), rows=7),
    "LogLuv32, 16x16 tiles": lambda: _luv(_xyz(), tile=16),
    "LogLuv32, big-endian, 64 wide": lambda: _luv(_xyz(20, 64), mode="wb"),
    "LogLuv32, written from 16-bit Luv": lambda: _luv(_xyz(), data_format=1, data=np.dstack([
        RNG.integers(0, 32768, (H, Wd)), RNG.integers(4000, 20000, (H, Wd)),
        RNG.integers(4000, 20000, (H, Wd))]).astype(np.int16)),
    "LogLuv32, orientation 2": lambda: _luv(_xyz(), extra=[(274, 2)]),
    "LogLuv32, FillOrder 2": lambda: _luv(_xyz(), extra=[(266, 2)]),
    "LogLuv24, FillOrder 2": lambda: _luv(_xyz(), 34677, extra=[(266, 2)]),
    "LogLuv32, orientation 3": lambda: _luv(_xyz(), extra=[(274, 3)]),
    "LogLuv32 of one sample (libtiff's raw data format)": lambda: W.libtiff_encode(
        [RNG.integers(0, 2 ** 31, (H, Wd)).astype(np.uint32) | 0x40000000],
        [(256, Wd), (257, H), (277, 3), (262, 32845), (259, 34676), (65560, 2), (278, H)]),
    "LogLuv24, one strip": lambda: _luv(_xyz(), 34677),
    "LogLuv24, strips of 4": lambda: _luv(_xyz(), 34677, rows=4),
    "LogLuv24, 16x16 tiles": lambda: _luv(_xyz(), 34677, tile=16),
    "LogLuv24, every chroma index": lambda: W.libtiff_encode(
        [np.stack([c >> 16, c >> 8, c], -1).astype(np.uint8).tobytes() for c in
         [(np.uint32(700) << 14) | np.arange(1 << 14, dtype=np.uint32)]],
        [(256, 128), (257, 128), (277, 3), (262, 32845), (259, 34677), (65560, 0),
         (278, 128)], raw=True),
}


@pytest.mark.parametrize("case", sorted(LUV))
def test_logluv_reads_as_opencv(case, tmp_path):
    """SGILOG LogLuv (32-bit RLE and 24-bit with libtiff's chroma table) to
    libtiff's float XYZ, then OpenCV's XYZ -> BGR (float32 in its order:
    vectors of 4, the row's tail one by one): bit-equal to cv2.imread, and
    read_image to the JAX package's."""
    _assert_reads_as_jax(_write(tmp_path, "a.tif", LUV[case]()))


def _probe_script():
    spec = importlib.util.spec_from_file_location(
        "probe_logluv_uv_table", os.path.join(REPO, "scripts", "probe_logluv_uv_table.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_logluv24_uv_table_is_libtiffs():
    """The package's LogLuv24 chroma table (iron_tpu_torch/data/
    logluv24_uv.json, written by scripts/probe_logluv_uv_table.py): every
    14-bit index at two luminances decodes to the system libtiff's XYZ bit
    for bit, and the table recovered again from libtiff is the one in the
    package."""
    probe = _probe_script()
    with open(os.path.join(REPO, "iron_tpu_torch", "data", "logluv24_uv.json")) as f:
        rec = json.load(f)
    assert len(rec["ncum"]) == len(rec["ustart"]) == 163 and rec["ndivs"] == 16289
    for luma in (probe.LUMA, 301):
        codes = (np.uint32(luma) << 14) | np.arange(1 << 14, dtype=np.uint32)
        want = probe.libtiff_xyz(codes)
        assert np.array_equal(tiff.logluv24_to_xyz(codes).view(np.uint32), want.view(np.uint32))
    again = probe.recover(probe.libtiff_xyz(
        (np.uint32(probe.LUMA) << 14) | np.arange(1 << 14, dtype=np.uint32)))
    assert again["ncum"] == rec["ncum"] and again["ndivs"] == rec["ndivs"]
    assert [str(u) for u in again["ustart"]] == rec["ustart"]


# ---------------------------------------------------------------------------
# what OpenCV misreads
# ---------------------------------------------------------------------------

PLANAR12 = _deep(12, 3)
MISREAD = {
    "12-bit planar RGB": (lambda: W.libtiff_encode(
        [W.pack_samples(PLANAR12[..., i], 12).tobytes() for i in range(3)],
        [(256, Wd), (257, H), (258, 12), (277, 3), (259, 1), (262, 2), (278, H), (284, 2)]),
        "planar", lambda ref: not np.array_equal(ref[..., ::-1], PLANAR12 << 4)),
    "LogL": (lambda: W.libtiff_encode(
        [np.abs(_xyz()[..., 1])], [(256, Wd), (257, H), (277, 1), (262, 32844), (259, 34676),
                                   (65560, 0), (65561, 0), (278, H)]),
        "LogL", lambda ref: ref.dtype == np.int8 and (ref < 0).any()),
}


@pytest.mark.parametrize("case", sorted(MISREAD))
def test_variants_opencv_misreads_raise(case, tmp_path):
    """Files OpenCV returns a wrong image for (12-bit planar samples taken
    as chunky, LogL's 8-bit gray typed int8): the port raises a ValueError
    naming them, not NoImage."""
    make, what, misread = MISREAD[case]
    path = _write(tmp_path, "a.tif", make())
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ref is not None and misread(ref)
    with pytest.raises(ValueError, match=what) as e:
        tio.read_image(path)
    assert not isinstance(e.value, tio.NoImage)


# ---------------------------------------------------------------------------
# CCITT: uncompressed-mode extension codes
# ---------------------------------------------------------------------------

FAX_MASK = (RNG.random((12, 40)) < 0.3).astype(np.uint8)
FAX_MASK[:, :5] = 0


def _fax(compression: int, t4: int, two_d, extension) -> bytes:
    strip = W.encode_fax(FAX_MASK, compression, two_d, extension)
    fields = [(256, 40), (257, 12), (258, 1), (277, 1), (259, compression), (262, 0),
              (278, 12)] + ([(292, t4)] if compression == 3 else [])
    return W.libtiff_encode([strip], fields, raw=True)


FAX = {
    "T.4 1D, bit 1, no extension code": (3, 2, None, None),
    "T.4 1D, extension code before a white run": (3, 2, None, (3, 4)),
    "T.4 1D, extension code before a black run": (3, 2, None, (5, 3)),
    "T.4 1D-tagged rows, extension code in the first run": (3, 3, False, (0, 0)),
    "T.4 2D, extension code where a mode is due": (3, 3, True, (6, 2)),
    "T.4 2D, extension code in a horizontal black run": (3, 3, True, (7, 5)),
    "T.4 2D, EOLs byte-aligned, extension code in the last row": (3, 7, True, (11, 4)),
    "T.6, extension code in the last row": (4, 0, None, (11, 2)),
    "T.6, extension code in row 6": (4, 0, None, (6, 0)),
}


@pytest.mark.parametrize("case", sorted(FAX))
def test_ccitt_extension_code_reads_as_opencv(case, tmp_path):
    """A T.4 or T.6 strip with an uncompressed-mode extension code, which
    libtiff does not decode: the row ends as libtiff ends it (2D: the run
    at a0 to the row's end; a 1D bad code: white after any pending make-up
    length), a T.4 strip goes on at the next EOL, a T.6 one after the
    7-bit code.  The port's decode is cv2.imread's array and read_image the
    JAX package's; the rows before the code are the image's."""
    compression, t4, two_d, extension = FAX[case]
    path = _write(tmp_path, "a.tif", _fax(compression, t4, two_d, extension))
    _assert_reads_as_jax(path)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    upto = 12 if extension is None else extension[0]
    assert np.array_equal(ref[:upto] == 0, FAX_MASK[:upto] == 1)


@pytest.mark.parametrize("seed", range(9))
def test_corrupt_t4_strip_reads_as_opencv(seed, tmp_path):
    """A T.4 strip (1D, 1D-tagged or 2D rows) with one to three bits
    flipped: libtiff ends a row at a bad code or an EOL where a code is
    due (the row's runs closed by CLEANUP_RUNS, the EOL's bits taken) and
    goes on at the next EOL; the port's decode is cv2.imread's array."""
    rng = np.random.default_rng(100 + seed)
    mask = (rng.random((12, 40)) < rng.uniform(0.05, 0.6)).astype(np.uint8)
    two_d = (None, False, True)[seed % 3]
    strip = bytearray(W.encode_fax(mask, 3, two_d))
    for _ in range(1 + seed % 3):
        strip[int(rng.integers(0, len(strip) - 4))] ^= 1 << int(rng.integers(0, 8))
    fields = [(256, 40), (257, 12), (258, 1), (277, 1), (259, 3), (262, 0), (278, 12),
              (292, 0 if two_d is None else 1)]
    _assert_reads_as_jax(_write(tmp_path, "a.tif", W.libtiff_encode([bytes(strip)], fields,
                                                                    raw=True)))


# ---------------------------------------------------------------------------
# JPEG: arithmetic-coded lossless (SOF11)
# ---------------------------------------------------------------------------

def _with_scan(data: bytes, scan: bytes) -> bytes:
    """`data` (one scan) with its entropy-coded bytes replaced by `scan`."""
    i = data.index(b"\xff\xda")
    start = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return data[:start] + scan + b"\xff\xd9"


def test_arithmetic_lossless_jpeg_gives_no_image_as_in_opencv(tmp_path):
    """SOF11: OpenCV's libjpeg-turbo decodes any arithmetic-coded scan of a
    sequential frame (SOF9) and any Huffman-coded lossless one (SOF3), even
    of random bytes, but no SOF11 frame, whatever its scan: it has no
    arithmetic decoder of lossless scans.  The port raises NoImage, the JAX
    package IOError."""
    from iron_tpu.data import io as jio
    junk = bytes(np.random.default_rng(11).integers(1, 255, 400, dtype=np.uint8))
    sof9 = _with_scan(W.libjpeg_encode(IMG[..., 0], "gray", arith=True), junk)
    sof3 = W.encode_lossless_jpeg(IMG[..., 0], predictor=1)
    assert cv2.imread(_write(tmp_path, "9.jpg", sof9), cv2.IMREAD_UNCHANGED) is not None
    assert cv2.imread(_write(tmp_path, "3.jpg", _with_scan(sof3, junk)),
                      cv2.IMREAD_UNCHANGED) is not None
    i = sof3.index(b"\xff\xc4")                      # no Huffman table in an SOF11 file
    sof11 = sof3[:i] + sof3[i + 2 + int.from_bytes(sof3[i + 2:i + 4], "big"):]
    sof11 = sof11.replace(b"\xff\xc3", b"\xff\xcb", 1)
    for scan in (junk, b"\x00" * 64):
        path = _write(tmp_path, "11.jpg", _with_scan(sof11, scan))
        assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(IOError):
            jio.read_image(path)
        with pytest.raises(tio.NoImage, match="arithmetic-coded lossless"):
            tio.read_image(path)


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

def test_committed_tiff_wide_fixture_matches_the_jax_loader():
    """tests/data_tiff_wide/ (scripts/make_tiff_wide_fixtures.py: a 12-bit
    RGB LZW view in strips, a big-endian 10-bit RGB Deflate view in 64^2
    tiles, a LogLuv32 view; masks 16-bit gray of 3 samples, 14-bit gray
    PackBits, 12-bit gray FillOrder 2), which chip_smoke.py trains stage 1
    on, loads in the port as in the JAX package, and each file decodes to
    the OpenCV hash recorded beside it.  The 14- and 12-bit masks' ones
    read as 65532 and 65520 of 65535 (OpenCV shifts them to 16 bits)."""
    root = os.path.join(REPO, "tests", "data_tiff_wide")
    _assert_loaders_agree(root, 3, (0.0, 1.0, 65532 / 65535, 65520 / 65535))
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        expected = json.load(f)
    assert len(expected) == 6
    for key, want in expected.items():
        with open(os.path.join(root, key), "rb") as f:
            raw = np.ascontiguousarray(tio.decode_image(f.read(), key))
        got = {"shape": list(raw.shape), "dtype": str(raw.dtype),
               "sha256": hashlib.sha256(raw.tobytes()).hexdigest()}
        assert got == want, key
        assert np.array_equal(raw.view(np.uint8), _cv2_rgb(os.path.join(root, key)).view(np.uint8))


def _cv2_rgb(path: str) -> np.ndarray:
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return np.ascontiguousarray(ref[..., ::-1] if ref.ndim == 3 else ref)
