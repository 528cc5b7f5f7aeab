"""Damaged headers in the port's readers (iron_tpu_torch/data/tiff.py,
ccitt.py, jp2.py, formats.py, webp.py, io.py) against cv2.imread, which
the JAX package reads every image through.

One test for each header fault the port had: a TIFF directory read as
libtiff's TIFFReadDirectory reads it (an ImageLength past the strips, a
RowsPerStrip of 0, a missing ImageLength or StripOffsets, a single
uncompressed strip whose byte count is short, an unknown compression), a
T.4 strip that loses an EOL, the JP2 boxes and the main header as OpenJPEG
checks them, the BMP, WebP and PFM fields OpenCV tolerates, the header
damage each format's OpenCV decoder refuses, and OpenCV's size limits,
which cv2.imread asserts outside its try: there the port raises
io.ImageSizeError, which `preprocess` does not skip.  Then the cases
damage_cases.UNREPRODUCIBLE names, and the committed fixture
tests/data_header/ (scripts/make_header_fixtures.py) against its hashes
and in RayDataset.from_folder against the JAX package's."""
import hashlib
import io
import json
import os
import shutil
import struct

import cv2
import numpy as np
import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

import damage_cases as D
from iron_tpu.cli import preprocess as j_preprocess
from iron_tpu.data.dataset import load_image_folder as j_load_image_folder

from iron_tpu_torch.cli import preprocess as t_preprocess
from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.dataset import RayDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = D.image(21)


def _check(tmp_path, data: bytes, ext: str, want: str):
    """cv2.imread's outcome for `data` and the port's: `want` ("equal",
    "refused" or "too large") for both."""
    ref, got = D.outcome(str(tmp_path / ("f" + ext)), data)
    assert D.verdict(ref, got) == want, D.verdict(ref, got)
    return ref, got


# ---------------------------------------------------------------------------
# TIFF directories
# ---------------------------------------------------------------------------

def _pil_tiff(img: np.ndarray, mode: str = None, **opts) -> bytes:
    from PIL import Image
    f = io.BytesIO()
    Image.fromarray(img, mode).save(f, "TIFF", **opts)
    return f.getvalue()


def _entry(data: bytes, tag: int) -> int:
    """The position of `tag`'s entry in a little-endian TIFF's first
    directory."""
    (off,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[off:off + 2])
    for i in range(n):
        e = off + 2 + 12 * i
        if struct.unpack("<H", data[e:e + 2])[0] == tag:
            return e
    raise KeyError(tag)


def _with_field(data: bytes, tag: int, value: int) -> bytes:
    """The TIFF with the one-value SHORT or LONG field `tag` set to `value`."""
    e = _entry(data, tag)
    typ = struct.unpack("<H", data[e + 2:e + 4])[0]
    body = struct.pack("<HH", value, 0) if typ == 3 else struct.pack("<I", value)
    return data[:e + 8] + body + data[e + 12:]


def _without_field(data: bytes, tag: int) -> bytes:
    """The TIFF with `tag`'s entry renamed to a private tag libtiff does not
    know (the entries then out of order, which libtiff only warns of)."""
    e = _entry(data, tag)
    return data[:e] + struct.pack("<H", 65000) + data[e + 2:]


@pytest.mark.parametrize("height", [41, 60])
def test_tiff_image_length_past_the_strips_gives_no_image(height, tmp_path):
    """A 40-row file of one strip of 40 rows whose ImageLength is raised:
    libtiff counts two strips, pads the offsets and byte counts it reads
    with zeros, and a strip of no bytes stops OpenCV's read (TIFFFillStrip);
    the port used to return the taller image."""
    data = _with_field(_pil_tiff(IMG[..., ::-1].copy()), 257, height)
    _check(tmp_path, data, ".tif", "refused")


@pytest.mark.parametrize("case", ["RowsPerStrip 0", "no ImageLength", "no StripOffsets",
                                  "no ImageWidth", "no Photometric", "no StripByteCounts"])
def test_tiff_directory_fields_missing_or_zero(case, tmp_path):
    """libtiff's checks of the directory: RowsPerStrip 0 and a missing
    StripOffsets fail it, a missing ImageLength leaves 0 rows (no strips),
    OpenCV asserts a Photometric field; a missing ImageWidth gives a
    scanline of 0 bytes; a missing StripByteCounts is estimated for one
    strip.  The port used to raise ZeroDivisionError or KeyError."""
    base = _pil_tiff(IMG[..., ::-1].copy())
    data = {"RowsPerStrip 0": lambda: _with_field(base, 278, 0),
            "no ImageLength": lambda: _without_field(base, 257),
            "no StripOffsets": lambda: _without_field(base, 273),
            "no ImageWidth": lambda: _without_field(base, 256),
            "no Photometric": lambda: _without_field(base, 262),
            "no StripByteCounts": lambda: _without_field(base, 279)}[case]()
    _check(tmp_path, data, ".tif", "equal" if case == "no StripByteCounts" else "refused")


@pytest.mark.parametrize("short", [1, 3, 50])
@pytest.mark.parametrize("mode", ["1", "L", "I;16", "RGB"])
def test_tiff_short_single_strip_is_read_whole(mode, short, tmp_path):
    """A single uncompressed strip whose StripByteCounts is short: libtiff
    takes the count as bogus (BYTECOUNTLOOKSBAD) and recomputes it from the
    image size (EstimateStripByteCounts), so OpenCV reads the whole image;
    the port used to give zeros, or no image at 16 bits."""
    img = {"1": IMG[..., 0] > 128, "L": IMG[..., 0], "RGB": IMG[..., ::-1].copy(),
           "I;16": IMG[..., 0].astype(np.uint16) * 257}[mode]
    base = _pil_tiff(img, "I;16" if mode == "I;16" else None)
    (count,) = struct.unpack("<I", base[_entry(base, 279) + 8:_entry(base, 279) + 12])
    ref, got = _check(tmp_path, _with_field(base, 279, count - short), ".tif", "equal")
    whole = cv2.imread(str(tmp_path / "f.tif"), cv2.IMREAD_UNCHANGED)
    assert ref.any() and whole is not None


@pytest.mark.parametrize("comp", [9216, 99])
def test_tiff_unknown_compression_reads_as_zeros(comp, tmp_path):
    """A compression libtiff does not know decodes nothing: its RGBA
    interface goes on, and OpenCV returns an all-zero 8-bit image (no image
    at 16 bits)."""
    ref, _ = _check(tmp_path, _with_field(_pil_tiff(IMG[..., ::-1].copy()), 259, comp), ".tif",
                    "equal")
    assert not ref.any()
    wide = _pil_tiff(IMG[..., 0].astype(np.uint16) * 257, "I;16")
    _check(tmp_path, _with_field(wide, 259, comp), ".tif", "refused")


@pytest.mark.parametrize("seed", [3, 5, 7, 9])
def test_tiff_group3_strip_that_loses_an_eol(seed, tmp_path):
    """PIL's group3 files (libtiff's encoder) with one strip byte set: where
    the data runs out while the decoder looks for a row's EOL, libtiff
    keeps the rows it has, and where the zeros of an EOL have no 1 after
    them before the data ends it decodes the strip again from its start
    without EOLs into the rows left (RETRY_WITHOUT_EOL); the port used to
    raise "no EOL before row 39"."""
    _check(tmp_path, D.damaged("tiff g3", "byte", seed), ".tif", "equal")


# ---------------------------------------------------------------------------
# JPEG 2000 boxes and main headers
# ---------------------------------------------------------------------------

def _jp2() -> bytes:
    from PIL import Image
    f = io.BytesIO()
    Image.fromarray(IMG[..., ::-1].copy()).save(f, "JPEG2000")
    return f.getvalue()


def _box_at(data: bytes, kind: bytes) -> int:
    return data.index(kind) - 4


def _jp2_case(case: str) -> bytes:
    d = _jp2()
    ftyp, ihdr, jp2c = _box_at(d, b"ftyp"), _box_at(d, b"ihdr"), _box_at(d, b"jp2c")
    k = d.index(b"\xff\x52")
    return {
        "ftyp renamed": lambda: d[:ftyp + 4] + b"ftyq" + d[ftyp + 8:],
        "ftyp of an odd size": lambda: d[:ftyp] + struct.pack(">I", struct.unpack_from(
            ">I", d, ftyp)[0] + 1) + d[ftyp + 4:],
        "ihdr height other than SIZ's": lambda: d[:ihdr + 8] + struct.pack(">I", 41)
        + d[ihdr + 12:],
        "ihdr of 0 components": lambda: d[:ihdr + 16] + b"\x00\x00" + d[ihdr + 18:],
        "jp2c length short": lambda: d[:jp2c] + struct.pack(">I", 100) + d[jp2c + 4:],
        "COD with 9 decomposition levels, past QCD's step sizes": lambda: d[:k + 9] + b"\x09"
        + d[k + 10:],
        "COD with 33 decomposition levels": lambda: d[:k + 9] + b"\x21" + d[k + 10:],
        "COD component transform 2": lambda: d[:k + 8] + b"\x02" + d[k + 9:],
        "SIZ tile offset past the image": lambda: (lambda s: d[:s + 36] + struct.pack(">I", 9)
                                                   + d[s + 40:])(d.index(b"\xff\x51")),
    }[case]()


@pytest.mark.parametrize("case", ["ftyp renamed", "ftyp of an odd size",
                                  "ihdr height other than SIZ's", "ihdr of 0 components",
                                  "jp2c length short",
                                  "COD with 9 decomposition levels, past QCD's step sizes",
                                  "COD with 33 decomposition levels",
                                  "COD component transform 2", "SIZ tile offset past the image"])
def test_jp2_boxes_and_main_header_as_openjpeg_checks_them(case, tmp_path):
    """OpenJPEG's opj_jp2_read_header_procedure and main-header readers:
    `ftyp` second and a multiple of 4 bytes, `ihdr` of 1 to 16384
    components and the size SIZ gives, COD and SIZ fields in range; the
    `jp2c` box's length is not read (its codestream runs to the end of the
    file), and a sub-band QCD gives no step size keeps OpenJPEG's zeroed
    one.  The port used to ignore the boxes or raise a plain JP2Error."""
    _check(tmp_path, _jp2_case(case), ".jp2",
           "equal" if case in ("jp2c length short",
                               "COD with 9 decomposition levels, past QCD's step sizes")
           else "refused")


def test_jp2_cmap_without_pclr_gives_no_image(tmp_path):
    """A `cmap` box with no `pclr` before it: OpenJPEG needs the palette
    first, so OpenCV gives no image; the port's NoImage still names the
    palette."""
    d = _jp2()
    h = _box_at(d, b"jp2h")
    n = struct.unpack_from(">I", d, h)[0]
    cmap = b"\x00\x00\x00\x0ccmap\x00\x00\x01\x00"
    data = d[:h] + struct.pack(">I", n + len(cmap)) + d[h + 4:h + n] + cmap + d[h + n:]
    _, got = _check(tmp_path, data, ".jp2", "refused")
    assert "palette" in str(got)


# ---------------------------------------------------------------------------
# BMP, WebP, PFM fields OpenCV tolerates; what each decoder refuses
# ---------------------------------------------------------------------------

def test_webp_lossless_chunk_size_lowered_reads(tmp_path):
    """libwebp reads a simple file's first chunk only and hands its decoder
    the bytes to the end: a VP8L chunk size lowered below its data still
    decodes (the port used to parse the rest as a chunk)."""
    d = bytearray(D._cv2(".webp", IMG, cv2.IMWRITE_WEBP_QUALITY, 101))
    assert d[12:16] == b"VP8L"
    d[16] = max(d[16] - 40, 0) if d[17] or d[18] else d[16] // 2
    _check(tmp_path, bytes(d), ".webp", "equal")


def test_bmp_info_header_size_byte_16(tmp_path):
    """A BMP whose DIB header size reads 0x7f0028: OpenCV reads the fields
    it needs and skips the rest of the header without reading it (the port
    used to say the file ends in its header)."""
    d = bytearray(D._cv2(".bmp", IMG))
    d[16] = 0x7F
    _check(tmp_path, bytes(d), ".bmp", "equal")


def test_pfm_width_read_by_atoi(tmp_path):
    """A PFM width of "5f": OpenCV's atoi reads 5, and a 40 x 5 image."""
    d = D._cv2(".pfm", IMG.astype(np.float32) / 255)
    ref, _ = _check(tmp_path, d.replace(b"\n56 40\n", b"\n5f 40\n", 1), ".pfm", "equal")
    assert ref.shape == (40, 5, 3)


REFUSED = {
    "BMP of 52 bits a pixel": (".bmp", lambda: (lambda d: d[:28] + b"\x34" + d[29:])(
        D._cv2(".bmp", IMG))),
    "BMP compression 0xe1000000": (".bmp", lambda: (lambda d: d[:33] + b"\xe1" + d[34:])(
        D._cv2(".bmp", IMG[..., 0]))),
    "BMP of 300 palette entries": (".bmp", lambda: (lambda d: d[:46] + struct.pack("<I", 300)
                                                    + d[50:])(D._cv2(".bmp", IMG[..., 0]))),
    "PPM width starting with a letter": (".ppm", lambda: D._cv2(".ppm", IMG).replace(b"56", b"x6",
                                                                                   1)),
    "PGM maxval 70000": (".pgm", lambda: D._cv2(".pgm", IMG[..., 0]).replace(b"255", b"70000",
                                                                             1)),
    "PAM field misspelt": (".pam", lambda: D._cv2(".pam", IMG).replace(b"DEPTH", b"DEP4H")),
    "PAM width 0x38": (".pam", lambda: D._cv2(".pam", IMG).replace(b"WIDTH 56", b"WIDTH 0x38")),
    "PFM scale 0": (".pfm", lambda: D._cv2(".pfm", IMG.astype(np.float32) / 255).replace(
        b"\n-1\n", b"\n-0\n", 1)),
    "PFM without its line break": (".pfm", lambda: b"PF " + D._cv2(
        ".pfm", IMG.astype(np.float32) / 255)[3:]),
    "HDR size line broken": (".hdr", lambda: D._cv2(".hdr", IMG.astype(np.float32) / 255)
                             .replace(b"+X", b"+\xb1", 1)),
    "HDR width 0": (".hdr", lambda: D._cv2(".hdr", IMG.astype(np.float32) / 255).replace(
        b"+X 56", b"+X 0", 1)),
    "Sun raster map type 40": (".ras", lambda: (lambda d: d[:27] + b"\x28" + d[28:])(
        D._cv2(".ras", IMG))),
    "Sun raster width negative": (".ras", lambda: (lambda d: d[:4] + b"\xff" + d[5:])(
        D._cv2(".ras", IMG))),
    "GIF disposal method 4": (".gif", lambda: (lambda d: d[:d.index(b"!\xf9") + 3] + b"\x10"
                                               + d[d.index(b"!\xf9") + 4:])(
        D.FORMATS["gif"][0](26))),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_header_damage_opencv_refuses_gives_no_image(case, tmp_path):
    """Header damage each OpenCV decoder stops at (its header check, a
    failed parse or assertion inside its try): NoImage, where the port
    used to raise a plain ValueError naming what it met."""
    ext, make = REFUSED[case]
    _check(tmp_path, make(), ext, "refused")


def _sized(kind: str, w: int, h: int) -> bytes:
    """A file of `kind` whose header gives a w x h image (the data as
    written for the seeded image)."""
    if kind == "jpeg":
        d = D._cv2(".jpg", IMG)
        i = d.find(b"\xff\xc0")
        return d[:i + 5] + struct.pack(">HH", h, w) + d[i + 9:]
    if kind == "png":
        d = D._cv2(".png", IMG)
        body = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
        return d[:16] + body + struct.pack(">I", __import__("zlib").crc32(b"IHDR" + body)) \
            + d[33:]
    if kind == "tiff":
        d = _pil_tiff(IMG[..., ::-1].copy())
        for tag, v in ((256, w), (257, h), (278, h)):
            e = _entry(d, tag)
            d = d[:e + 2] + struct.pack("<HII", 4, 1, v) + d[e + 12:]
        return d
    if kind == "bmp":
        d = D._cv2(".bmp", IMG)
        return d[:18] + struct.pack("<ii", w, h) + d[26:]
    if kind in ("ppm", "pgm 16-bit"):
        return (b"P6\n%d %d\n255\n" if kind == "ppm" else b"P5\n%d %d\n65535\n") % (w, h) \
            + bytes(64)
    if kind == "pam":
        return b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 3\nMAXVAL 255\nENDHDR\n" % (w, h) + bytes(64)
    if kind == "pfm":
        return b"PF\n%d %d\n-1\n" % (w, h) + bytes(64)
    if kind == "hdr":
        return b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w) + bytes(64)
    if kind == "sun raster":
        return b"\x59\xa6\x6a\x95" + struct.pack(">7I", w, h, 24, 0, 1, 0, 0) + bytes(64)
    if kind == "gif":
        d = D._cv2(".gif", IMG)
        return d[:6] + struct.pack("<HH", w, h) + d[10:]
    d = D.FORMATS["j2k 9/7"][0](0)                   # a raw codestream: SIZ's Xsiz, Ysiz
    return d[:8] + struct.pack(">II", w, h) + d[16:]


@pytest.mark.parametrize("kind", ["jpeg", "png", "tiff", "bmp", "ppm", "pgm 16-bit", "pam",
                                  "pfm", "hdr", "sun raster", "gif", "j2k"])
def test_header_past_opencvs_size_limits_raises_the_size_error(kind, tmp_path):
    """A header whose size passes OpenCV's limits (2^20 a side, 2^30
    pixels) once the decoder's own header checks pass: cv2.imread raises
    cv2.error, and the port ImageSizeError, not NoImage."""
    w, h = {"jpeg": (40000, 40000), "png": (40000, 40000), "gif": (40000, 40000),
            "j2k": (2000000, 1)}.get(kind, (2000000, 1))
    ext = {"jpeg": ".jpg", "pgm 16-bit": ".pgm", "sun raster": ".ras", "j2k": ".j2k"}.get(
        kind, "." + kind)
    _, got = _check(tmp_path, _sized(kind, w, h), ext, "too large")
    assert not isinstance(got, tio.NoImage) and "2^20" in str(got)


def test_preprocess_stops_on_an_oversize_file_and_skips_a_refused_one(tmp_path):
    """`preprocess make-masks` over a folder with a header OpenCV refuses
    (skipped by both packages, as cv2.imread's None) and one past its size
    limits: the JAX package stops with cv2.error, the port with
    ImageSizeError."""
    good = D._cv2(".png", np.dstack([IMG, D.image(22, C=1)]))
    refused = REFUSED["PAM field misspelt"][1]()
    for pkg, lib, error in (("j", j_preprocess, cv2.error), ("t", t_preprocess,
                                                             tio.ImageSizeError)):
        folder = tmp_path / pkg / "image"
        os.makedirs(folder)
        (folder / "a.png").write_bytes(good)
        (folder / "b.png").write_bytes(refused)
        lib.main(["make-masks", "--image_dir", str(folder)])
        assert sorted(os.listdir(tmp_path / pkg / "masks")) == ["a.png"]
        (folder / "c.png").write_bytes(_sized("ppm", 2000000, 1))
        with pytest.raises(error):
            lib.main(["make-masks", "--image_dir", str(folder)])
    shutil.rmtree(tmp_path)


def test_unreproducible_cases_are_named(tmp_path):
    """The cases damage_cases.UNREPRODUCIBLE lists, where OpenCV's library
    reads memory no file holds: OpenCV returns an image, the port a plain
    ValueError naming the case (and the sweep counts them apart)."""
    assert D.UNREPRODUCIBLE
    for (fmt, kind, seed), what in sorted(D.UNREPRODUCIBLE.items()):
        ref, got = D.outcome(str(tmp_path / ("f" + D.FORMATS[fmt][1])),
                             D.damaged(fmt, kind, seed))
        assert isinstance(ref, np.ndarray) and type(got) is ValueError and what in str(got)
        assert D.classify(fmt, kind, seed, ref, got) == "unreproducible"


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

def _sha(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def test_header_fixture_matches_its_manifest():
    """tests/data_header/, which chip_smoke.py's phase 8q holds on the card:
    the three header-damaged views and their masks decode to the arrays
    recorded from cv2.imread (still OpenCV's here), and every refused file,
    where cv2.imread gives None, raises NoImage."""
    root = os.path.join(REPO, "tests", "data_header")
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        want = json.load(f)
    assert len([k for k, v in want.items() if v is None]) >= 10
    for key, w in sorted(want.items()):
        path = os.path.join(root, key)
        data = open(path, "rb").read()
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if w is None:
            assert ref is None, key
            with pytest.raises(tio.NoImage):
                tio.decode_image(data, key)
        else:
            ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]] if ref.ndim == 3 else ref
            assert _sha(tio.decode_image(data, key)) == w == _sha(ref), key


def test_header_fixture_loads_as_in_the_jax_package():
    """RayDataset.from_folder on tests/data_header/ and the JAX package's
    load_image_folder on its images and masks: the same arrays, bit for
    bit."""
    root = os.path.join(REPO, "tests", "data_header")
    mask_dir = os.path.join(root, "mask")
    ds = RayDataset.from_folder(root, mask_dir=mask_dir, device="cpu")
    fpaths, images, Ks, W2Cs, masks = j_load_image_folder(root, mask_dir=mask_dir)
    names = [os.path.basename(p) for p in ds.fpaths]
    assert names == [os.path.basename(p) for p in fpaths] == ["view0.png", "view1.png",
                                                               "view2.png"]
    assert np.array_equal(ds.images.numpy(), np.asarray(images, np.float32))
    assert np.array_equal(ds.masks.numpy(), np.asarray(masks, np.float32)[..., :1])
    assert np.array_equal(ds.Ks.numpy(), np.asarray(Ks, np.float32))
