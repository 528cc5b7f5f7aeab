"""Damaged image files in the port's readers (iron_tpu_torch/data/jpeg.py,
io.py, webp.py, tiff.py, formats.py, jp2.py) against cv2.imread, which the
JAX package reads every image through (by its path: OpenCV's libjpeg reads a
file through its stdio source, which ends a cut file with fake EOI markers,
while cv2.imdecode's buffer source gives no image).

A seeded sweep over the formats and damage classes of tests/damage_cases.py
(a cut, one byte of the coded data set, the end marker dropped, bytes after
the end): each file is OpenCV's array in the port or, where cv2.imread
gives None, NoImage.  Then libjpeg's recovery rules one by one, the PNG
without IEND that the port used to read, the committed fixture
tests/data_damaged/ (scripts/make_damaged_fixtures.py) against its hashes
and in RayDataset.from_folder against the JAX package's, and `preprocess`
on a folder with damaged files against the JAX package's."""
import hashlib
import json
import os
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

import damage_cases as D
import image_format_writers as W
from iron_tpu.cli import preprocess as j_preprocess
from iron_tpu.data.dataset import RayDataset as JRayDataset

from iron_tpu_torch.cli import preprocess as t_preprocess
from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.dataset import RayDataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = {"cut": (0, 1, 2, 3), "byte": (0, 1, 2, 3), "end": (0, 1), "trail": (0, 1),
         "header": (0, 1, 2, 3)}


@pytest.mark.parametrize("kind", D.DAMAGE)
@pytest.mark.parametrize("fmt", sorted(D.FORMATS))
def test_damaged_file_reads_as_opencv_reads_it(fmt, kind, tmp_path):
    """The sweep: each seeded case gives cv2.imread's array exactly,
    NoImage where cv2.imread gives None, or ImageSizeError where it raises
    cv2.error; a case of damage_cases.UNREPRODUCIBLE raises the ValueError
    that names it."""
    for seed in SEEDS[kind][:None if D.seeded(fmt, kind) else 1]:
        data = D.damaged(fmt, kind, seed)
        ref, got = D.outcome(str(tmp_path / ("f" + D.FORMATS[fmt][1])), data)
        v = D.classify(fmt, kind, seed, ref, got)
        assert v in D.OUTCOMES + ("unreproducible",), (fmt, kind, seed, D.verdict(ref, got))


def _cut_baseline():
    img = D.image(5, 48, 64)
    data = D._cv2(".jpg", img, cv2.IMWRITE_JPEG_QUALITY, 90)
    lo, hi = D._jpeg_span(data)
    return data[:lo + (hi - lo) // 2]


def test_cut_baseline_jpeg_decodes_its_tail_as_gray_128(tmp_path):
    """libjpeg decodes the MCUs after the data runs out from zero
    coefficients: gray 128, as OpenCV gives it; cv2.imdecode, whose buffer
    source suspends at the end instead, gives no image (the JAX package
    reads files, so imread is the target)."""
    data = _cut_baseline()
    ref, got = D.outcome(str(tmp_path / "a.jpg"), data)
    assert D.verdict(ref, got) == "equal"
    gray = np.where((got == 128).all(axis=(1, 2)))[0]
    assert len(gray) >= 8 and gray[-1] == got.shape[0] - 1
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED) is None
    rows = tio.read_image(str(tmp_path / "a.jpg"))[gray[0]:]
    assert (rows == np.float32(128 / 255)).all()


def _restart_jpeg():
    return bytearray(D._cv2(".jpg", D.image(6, 48, 64), cv2.IMWRITE_JPEG_RST_INTERVAL, 1))


def _markers(data, lo=0xD0, hi=0xD7):
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and lo <= data[i + 1] <= hi]


def _rule_cases():
    base = bytes(_restart_jpeg())
    rst = _markers(base)
    k = len(rst) // 2
    wrong = bytearray(base)
    wrong[rst[k] + 1] = 0xD0 + ((base[rst[k] + 1] - 0xD0 + 3) & 7)
    ahead = bytearray(base)
    ahead[rst[k] + 1] = 0xD0 + ((base[rst[k] + 1] - 0xD0 + 1) & 7)
    behind = bytearray(base)
    behind[rst[k] + 1] = 0xD0 + ((base[rst[k] + 1] - 0xD0 - 1) & 7)
    lo, hi = D._jpeg_span(base)
    seq = D._cv2(".jpg", D.image(7, 48, 64))
    slo, shi = D._jpeg_span(seq)
    eoi_in = seq[:(slo + shi) // 2] + b"\xff\xd9" + seq[(slo + shi) // 2:]
    dht = seq.find(b"\xff\xc4")
    prog = D._cv2(".jpg", D.image(7, 48, 64), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    lossless = W.encode_lossless_jpeg(D.image(7, 48, 64), predictor=1)
    return {
        # a restart marker three ahead: taken, the segments after resynchronise
        "restart marker out of place": bytes(wrong),
        # one of the next two restarts: left unread, the interval has no data
        "restart marker one ahead": bytes(ahead),
        # a restart one back: skipped to the next marker
        "restart marker one back": bytes(behind),
        "restart marker missing": base[:rst[k]] + base[rst[k] + 2:],
        "bytes before a marker": base[:rst[k]] + b"\x12\x34\x56" + base[rst[k]:],
        "an unknown marker in the scan": base[:rst[k]] + b"\xff\x3a" + base[rst[k]:],
        "an unknown marker after a one-scan file": seq[:-2] + b"\xff\x3a\xff\xd9",
        "EOI inside the scan": eoi_in,
        "fill bytes before a marker": base[:rst[k]] + b"\xff\xff\xff" + base[rst[k]:],
        "bad Huffman codes": base[:lo + 40] + b"\xff\x00" * 8 + base[lo + 56:],
        "a scan before the frame": seq.replace(b"\xff\xc0", b"\xff\xc8", 1),
        "a DHT of a bad length": seq[:dht + 3] + bytes([seq[dht + 3] + 1]) + seq[dht + 4:],
        "no Huffman tables (libjpeg's standard ones)": _without_dht(seq),
        # jdphuff.c and jdlhuff.c have no standard tables: libjpeg stops
        "no Huffman tables in a progressive file": _without_dht(prog),
        "no Huffman tables in a lossless file": _without_dht(lossless),
        "a cut before the first scan": seq[:slo - 20],
    }


def _without_dht(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while True:
        j = data.find(b"\xff\xc4", i)
        if j < 0 or j > data.find(b"\xff\xda"):
            return bytes(out + data[i:])
        out += data[i:j]
        i = j + 2 + struct.unpack(">H", data[j + 2:j + 4])[0]


@pytest.mark.parametrize("case", sorted(_rule_cases()))
def test_libjpeg_recovery_rule(case, tmp_path):
    """libjpeg-turbo's handling of a damaged scan, case by case (jdmarker.c
    read_restart_marker and jpeg_resync_to_restart, next_marker's skipped
    bytes, jdhuff.c's zero bits and bad codes, the fatal errors OpenCV
    gives no image for, the standard tables of jdhuff.c): OpenCV's
    outcome in the port."""
    ref, got = D.outcome(str(tmp_path / "a.jpg"), _rule_cases()[case])
    assert D.verdict(ref, got) in D.OUTCOMES, (case, D.verdict(ref, got))


@pytest.mark.parametrize("scan", range(1, 10))
def test_progressive_jpeg_cut_after_each_scan(scan, tmp_path):
    """A progressive JPEG cut before each of its later scans: the earlier
    scans' coefficients with libjpeg-turbo's block smoothing (the DC-only
    5x5 kernel after the first scan, AC 1-9 estimated after the others,
    the coef_bits of the rows the cut scan reached), as OpenCV decodes it."""
    for img in (D.image(8, 48, 64), D.image(9, 40, 56, C=1)):
        data = D._cv2(".jpg", img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
        sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
        if scan >= len(sos):
            continue
        cut = sos[scan]
        ref, got = D.outcome(str(tmp_path / "a.jpg"), data[:cut])
        assert D.verdict(ref, got) == "equal", scan
        # cut inside the scan before (or its header, where libjpeg stops)
        ref, got = D.outcome(str(tmp_path / "a.jpg"), data[:(sos[scan - 1] + cut) // 2])
        assert D.verdict(ref, got) in ("equal", "refused"), scan


def _with_wide_tables(data: bytes, tables) -> bytes:
    """A JPEG with every DQT segment's tables rewritten as 16-bit ones
    (`tables[id]`, zigzag order), its scans as they were."""
    out, p = bytearray(data[:2]), 2
    while data[p + 1] != 0xDA:
        n = struct.unpack(">H", data[p + 2:p + 4])[0]
        if data[p + 1] == 0xDB:
            body = b"".join(bytes([0x10 | tid]) + np.asarray(tables[tid], ">u2").tobytes()
                            for tid in data[p + 4:p + 2 + n:65])
            out += b"\xff\xdb" + struct.pack(">H", len(body) + 2) + body
        else:
            out += data[p:p + 2 + n]
        p += 2 + n
    return bytes(out + data[p:])


@pytest.mark.parametrize("top", [300, 3000, 65535])
def test_wide_quantisers_take_the_simd_idct(top, tmp_path):
    """Coefficients times 16-bit quantisers (a corrupt DQT, or corrupt
    scans) wrap in libjpeg-turbo's SIMD IDCT, which OpenCV runs: the
    dequantisation and in0 + in4 in 16 bits, the passes saturated; the
    port's `idct_islow` gives OpenCV's pixels."""
    g = np.random.default_rng(top)
    for sub in (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444):
        img = g.integers(0, 256, (24, 40, 3)).astype(np.uint8)
        data = D._cv2(".jpg", img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sub)
        data = _with_wide_tables(data, {t: g.integers(1, top, 64) for t in range(2)})
        ref, got = D.outcome(str(tmp_path / "a.jpg"), data)
        assert D.verdict(ref, got) == "equal"


def _png(chunks) -> bytes:
    return b"\x89PNG\r\n\x1a\n" + b"".join(
        struct.pack(">I", len(body)) + kind + body
        + struct.pack(">I", zlib.crc32(kind + body) if crc else 0) for kind, body, crc in chunks)


def _png_parts(img):
    H, W = img.shape[:2]
    raw = b"".join(b"\x00" + row.tobytes() for row in img.reshape(H, -1))
    return [(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0), True),
            (b"IDAT", zlib.compress(raw), True), (b"IEND", b"", True)]


def test_png_without_iend_gives_no_image(tmp_path):
    """The fault this slice repaired: a PNG without its IEND chunk, which
    the port read, gives no image in OpenCV (libpng's read of the end
    fails), so NoImage; so does a corrupt IDAT byte (its CRC fails)."""
    parts = _png_parts(D.image(10, 12, 16))
    whole = _png(parts)
    assert D.verdict(*D.outcome(str(tmp_path / "a.png"), whole)) == "equal"
    for data in (_png(parts[:2]), whole[:40] + bytes([whole[40] ^ 1]) + whole[41:]):
        ref, got = D.outcome(str(tmp_path / "a.png"), data)
        assert ref is None and isinstance(got, tio.NoImage), got


@pytest.mark.parametrize("case", ["ancillary chunk with a bad CRC", "IEND with a bad CRC",
                                  "unknown critical chunk", "a chunk between IDATs",
                                  "tRNS with a bad CRC"])
def test_png_chunk_damage(case, tmp_path):
    """libpng's chunk rules as OpenCV meets them: an ancillary chunk that
    fails its CRC is dropped (a tRNS too: three channels), IEND's CRC is
    not checked, an unknown critical chunk or a chunk between two IDAT
    chunks gives no image."""
    parts = _png_parts(D.image(11, 12, 16))
    ihdr, idat, iend = parts
    text = (b"tEXt", b"k\x00v", False)
    chunks = {"ancillary chunk with a bad CRC": [ihdr, text, idat, iend],
              "IEND with a bad CRC": [ihdr, idat, (b"IEND", b"", False)],
              "unknown critical chunk": [ihdr, (b"ABCD", b"x", True), idat, iend],
              "a chunk between IDATs": [ihdr, (b"IDAT", idat[1][:20], True),
                                        (b"tEXt", b"a\x00b", True),
                                        (b"IDAT", idat[1][20:], True), iend]}
    if case == "tRNS with a bad CRC":
        pal = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0]], np.uint8)
        raw = b"".join(b"\x00" + bytes([(x + y) % 3 for x in range(16)]) for y in range(12))
        chunks[case] = [(b"IHDR", struct.pack(">IIBBBBB", 16, 12, 8, 3, 0, 0, 0), True),
                        (b"PLTE", pal.tobytes(), True), (b"tRNS", b"\x00\x80", False),
                        (b"IDAT", zlib.compress(raw), True), iend]
    ref, got = D.outcome(str(tmp_path / "a.png"), _png(chunks[case]))
    assert D.verdict(ref, got) in D.OUTCOMES, (case, D.verdict(ref, got))


# ---------------------------------------------------------------------------
# the committed fixture, the dataset and preprocess
# ---------------------------------------------------------------------------

def _sha(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def test_damaged_fixture_matches_its_manifest():
    """tests/data_damaged/, which chip_smoke.py's phase 8o holds on the
    card: the three damaged views and their masks decode to the arrays
    recorded from cv2.imread (still OpenCV's here), and every refused
    file, where cv2.imread gives None, raises NoImage."""
    root = os.path.join(REPO, "tests", "data_damaged")
    with open(os.path.join(root, "opencv_sha256.json")) as f:
        want = json.load(f)
    assert len([k for k, v in want.items() if v is None]) == 13
    for key, w in sorted(want.items()):
        path = os.path.join(root, key)
        data = open(path, "rb").read()
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if w is None:
            assert ref is None
            with pytest.raises(tio.NoImage):
                tio.decode_image(data, key)
        else:
            ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]] if ref.ndim == 3 else ref
            assert _sha(tio.decode_image(data, key)) == w == _sha(ref), key


def test_damaged_fixture_loads_as_in_the_jax_package():
    """RayDataset.from_folder on tests/data_damaged/ (damaged JPEG views,
    PNG masks): the JAX package's images and masks, bit for bit; view0's
    cut tail at 128/255."""
    root = os.path.join(REPO, "tests", "data_damaged")
    mask_dir = os.path.join(root, "mask")
    ds = RayDataset.from_folder(root, mask_dir=mask_dir, device="cpu")
    jds = JRayDataset.from_folder(root, mask_dir=mask_dir)
    assert [os.path.basename(p) for p in ds.fpaths] == ["view0.jpg", "view1.jpg", "view2.jpg"]
    for k in ("images", "masks", "Ks", "W2Cs"):
        assert np.array_equal(getattr(ds, k).numpy(), np.asarray(getattr(jds, k))), k
    assert (ds.images[0, 161:] == 128 / 255).all()


def _preprocess_both(tmp_path, files: dict):
    """Each package's make-masks then apply-alpha on its own copy of
    `files` (name -> bytes) -> the two roots."""
    roots = []
    for pkg, lib in (("j", j_preprocess), ("t", t_preprocess)):
        root = tmp_path / pkg
        os.makedirs(root / "image")
        for name, data in files.items():
            (root / "image" / name).write_bytes(data)
        lib.main(["make-masks", "--image_dir", str(root / "image")])
        lib.main(["apply-alpha", "--image_dir", str(root / "image")])
        roots.append(root)
    return roots


def test_preprocess_skips_damaged_files_as_the_jax_package(tmp_path):
    """make-masks and apply-alpha over a folder of damaged files named .png
    (a PNG without IEND, one with a corrupt IDAT, a cut RGBA PNG, the
    fixture's refused files) beside readable ones (an RGBA PNG, the damaged
    views OpenCV reads): both packages skip the same files and leave the
    same arrays in the rest."""
    rgba = np.dstack([D.image(12, 24, 32), D.image(13, 24, 32, C=1)])
    png = D._cv2(".png", rgba)
    files = {"rgba.png": png, "cut_rgba.png": png[:len(png) // 2],
             "no_iend.png": png[:-12],
             "corrupt_idat.png": png[:60] + bytes([png[60] ^ 0x55]) + png[61:]}
    root = os.path.join(REPO, "tests", "data_damaged")
    for name in sorted(os.listdir(os.path.join(root, "refused")))[:6]:
        files[name] = open(os.path.join(root, "refused", name), "rb").read()
    files["view0.png"] = open(os.path.join(root, "image", "view0.jpg"), "rb").read()
    j, t = _preprocess_both(tmp_path, files)
    assert sorted(os.listdir(t / "masks")) == sorted(os.listdir(j / "masks")) == \
        ["rgba.png", "view0.png"]
    for d in ("image", "masks"):
        for name in sorted(os.listdir(j / d)):
            a = cv2.imread(str(j / d / name), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(t / d / name), cv2.IMREAD_UNCHANGED)
            assert (a is None) == (b is None), (d, name)
            if a is not None:
                assert np.array_equal(a, b), (d, name)
            else:
                assert (j / d / name).read_bytes() == (t / d / name).read_bytes()
    shutil.rmtree(tmp_path)


# ---------------------------------------------------------------------------
# regressions: the arithmetic SOS cut, JPEG 2000 header damage, CMYK / e-YCC
# ---------------------------------------------------------------------------

_JPEGS = sorted(n for n in D.FORMATS if n.startswith("jpeg"))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("fmt", _JPEGS)
def test_jpeg_cut_inside_its_sos_segment(fmt, seed, tmp_path):
    """Every JPEG variant cut at every byte of its first SOS segment: the
    fields the cut removes are read from libjpeg's fake EOI markers (an
    arithmetic-coded sequential scan then ignores the Ss, Se, Ah and Al it
    read, as jdarith.c does), and each file reads as cv2.imread reads it."""
    data = D.FORMATS[fmt][0](seed)
    i = data.index(b"\xff\xda")
    n = struct.unpack_from(">H", data, i + 2)[0]
    path = str(tmp_path / ("f" + D.FORMATS[fmt][1]))
    for k in range(1, n + 3):
        ref, got = D.outcome(path, data[:i + k])
        assert D.classify(fmt, "cut", seed, ref, got) in D.OUTCOMES, \
            (fmt, seed, k, D.verdict(ref, got))


@pytest.mark.parametrize("fmt", ["jp2", "jp2 3 layers"])
def test_jp2_header_damage_sets_code_block_styles(fmt, tmp_path):
    """Header seed 126 sets code-block style 0x33 (BYPASS, RESET, PTERM,
    SEGSYM) on a stream coded with style 0: OpenCV decodes it, and the port
    gives its image."""
    data = D.damaged(fmt, "header", 126)
    k = data.index(b"\xff\x52")
    assert data[k + 12] == 0x33
    ref, got = D.outcome(str(tmp_path / "f.jp2"), data)
    assert D.verdict(ref, got) == "equal"


def _jp2_colour(img: np.ndarray, enum: int) -> bytes:
    """A .jp2 from the system's OpenJPEG with its 'colr' set to `enum`."""
    data = W.openjpeg_encode(img, resolutions=3)
    k = data.index(b"colr")
    return data[:k + 7] + struct.pack(">I", enum) + data[k + 11:]


def test_preprocess_skips_cmyk_and_eycc_jp2_as_the_jax_package(tmp_path):
    """A CMYK .jp2 (4 components, 'colr' 12) and an e-YCC one (3
    components, 'colr' 24) named .png, which cv2.imread gives no image for:
    the port raises NoImage for both, and its make-masks skips them as the
    JAX package's does."""
    files = {"cmyk.png": _jp2_colour(np.dstack([D.image(14), D.image(15, C=1)]), 12),
             "eycc.png": _jp2_colour(D.image(16), 24),
             "rgb.png": D._cv2(".png", D.image(17))}
    for name in ("cmyk.png", "eycc.png"):
        ref, got = D.outcome(str(tmp_path / name), files[name])
        assert ref is None and isinstance(got, tio.NoImage), name
    j, t = _preprocess_both(tmp_path, files)
    assert sorted(os.listdir(t / "masks")) == sorted(os.listdir(j / "masks")) == ["rgb.png"]
    shutil.rmtree(tmp_path)
