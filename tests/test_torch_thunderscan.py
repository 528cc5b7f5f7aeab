"""ThunderScan TIFF (compression 32809) in the port's reader
(iron_tpu_torch/data/thunder.py through data/tiff.py) against
cv2.imread(IMREAD_UNCHANGED), which the JAX package reads every image
through (libtiff 4.7's RGBA interface for a 4-bit palette): every code kind
(runs, 2- and 3-bit deltas with their skip codes, raw pixels), a row's
leftover codes carried into the next row, "Too much" and "Not enough" data
(the rest of the row and of the strip zero), odd widths, several strips,
FillOrder 2, both byte orders, 8- and 16-bit colormaps, the Orientation
field, tiles (which libtiff has no ThunderScan decoder for: zeros), and
seeded random code streams.  Then the files OpenCV gives no image for,
which the port refuses with NoImage: ThunderScan at other depths and of
gray, and the three repairs of the port's TIFF reader -- a 2-bit palette,
PixarLog (which OpenCV's libtiff is built without) and NeXT (whose decoder
takes only the 2-bit samples OpenCV refuses) -- which the port read, or
raised a plain ValueError for, before; a 1-bit palette, which OpenCV reads
as gray; `preprocess` over a folder of them beside the JAX package's; and
the committed fixture tests/data_thunderscan/
(scripts/make_thunderscan_fixtures.py).

Files are written by the system's libtiff (ctypes,
tests/image_format_writers.libtiff_encode), the ThunderScan strips by
image_format_writers.thunderscan_encode or as the codes listed, stored
raw."""
import collections
import hashlib
import json
import os
import shutil

import cv2
import numpy as np
import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

import damage_cases as D
import image_format_writers as W
from iron_tpu.data import io as jio
from iron_tpu.data.dataset import load_image_folder as j_load_image_folder
from test_torch_damaged import _preprocess_both
from test_torch_image_formats import _assert_reads_as_jax, _write

from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.dataset import load_image_folder
from iron_tpu_torch.data.thunder import decode_thunderscan
from iron_tpu_torch.data.tiff import _directory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data_thunderscan")

# a 16-entry colormap: 16-bit entries (libtiff shifts them down 8 bits), and
# the same colours as 8-bit entries (libtiff takes them as they are)
CMAP16 = np.stack([np.arange(16) * 4369, (15 - np.arange(16)) * 4096 + 3,
                   np.arange(16) * 7 % 16 * 4096 + 255]).astype(np.uint16)
CMAP8 = (CMAP16 >> 8).astype(np.uint16)
REVERSED = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


def RUN(n):
    return n


def RAW(v):
    return 0xC0 | v


def D2(a, b, c):
    return 0x40 | a << 4 | b << 2 | c


def D3(a, b):
    return 0x80 | a << 3 | b


def levels(seed: int, H: int = 40, W_: int = 56) -> np.ndarray:
    """A 16-level image that needs every code kind: the seeded blurred
    image times 5, modulo 16."""
    return (D.image(seed, H, W_, C=1).astype(np.int64) * 5 >> 4) % 16


def thunder(strips, width: int, height: int, rows=None, bps: int = 4, photo: int = 3,
            cmap=CMAP16, extra=(), mode: str = "w", tile=None) -> bytes:
    """A ThunderScan TIFF of the strips (or `tile`-square tiles) given as
    code bytes."""
    fields = [(256, width), (257, height), (258, bps), (277, 1), (262, photo), (259, 32809)]
    fields += [(322, tile), (323, tile)] if tile else [(278, rows or height)]
    if photo == 3:
        c = np.asarray(cmap, np.uint16)
        fields.append((320, c[0].copy(), c[1].copy(), c[2].copy()))
    return W.libtiff_encode(strips, fields + list(extra), mode=mode, tiled=bool(tile), raw=True)


def coded(idx: np.ndarray, rows: int, **kw) -> bytes:
    """`idx` coded by thunderscan_encode in strips of `rows` rows."""
    H, W_ = idx.shape
    return thunder([W.thunderscan_encode(idx[y:y + rows]) for y in range(0, H, rows)], W_, H,
                   rows, **kw)


def _random_codes(seed: int) -> bytes:
    """A seeded stream of random ThunderScan codes: the kinds drawn evenly,
    runs mostly short, with strips that run long or short of their rows."""
    g = np.random.default_rng(seed)
    width, height = int(g.integers(1, 40)), int(g.integers(1, 13))
    rows = int(g.integers(1, height + 1))
    strips = []
    for _ in range(0, height, rows):
        n = int(g.integers(0, rows * (width + 2) // 2 + 4))
        kinds = g.integers(0, 4, n)
        body = np.where(kinds == 0, np.where(g.random(n) < 0.9, g.integers(0, 8, n),
                                             g.integers(0, 64, n)),
                        kinds << 6 | g.integers(0, 64, n))
        strips.append(bytes(body.astype(np.uint8).tolist()) or bytes([RAW(1)]))
    return thunder(strips, width, height, rows)


CASES = {
    "every code kind, one strip": lambda: coded(levels(0), 40),
    "every code kind, strips of 8 rows": lambda: coded(levels(1), 8),
    "strips of 7 rows (the last of 5)": lambda: coded(levels(2), 7),
    "odd width (15), strips of 3 rows": lambda: coded(levels(3, 9, 15), 3),
    "width 1": lambda: coded(levels(4, 12, 1), 5),
    "8-bit colormap": lambda: coded(levels(5), 16, cmap=CMAP8),
    "FillOrder 2": lambda: thunder([W.thunderscan_encode(levels(6)).translate(REVERSED)], 56,
                                   40, extra=[(266, 2)]),
    "big-endian": lambda: coded(levels(7), 10, mode="wb"),
    **{f"orientation {o}": (lambda o=o: coded(levels(8 + o), 12, extra=[(274, o)]))
       for o in (2, 3, 4)},
    "a raw pixel then a run that fills the row": lambda: thunder(
        [bytes([RAW(5), RUN(15), RAW(6), RAW(7), RUN(14)])], 16, 2),
    "runs of 0 and 1 at odd and even places": lambda: thunder(
        [bytes([RAW(5), RUN(0), RAW(6), RUN(0), RUN(1), RUN(11), RAW(3)])], 16, 1),
    "2- and 3-bit deltas and skips, wrapping modulo 16": lambda: thunder(
        [bytes([RAW(15), D2(1, 1, 1), RAW(0), D3(5, 5), D3(6, 7), D2(2, 3, 2), D3(4, 3),
                D2(0, 2, 1), D3(1, 4), RAW(9)])], 16, 1),
    "a row of 17: the last code starts the next row": lambda: thunder(
        [bytes([RAW(5), RUN(15), RAW(2), RAW(9), RUN(14)])], 16, 2),
    "2-bit deltas past the row's end are dropped": lambda: thunder(
        [bytes([RAW(5), RAW(6), RAW(7), D2(1, 1, 1), RAW(2), RUN(3)])], 4, 2),
    "too much: a run past the row's end": lambda: thunder(
        [bytes([RAW(5), RUN(7), RAW(6), RUN(9), RAW(2), RUN(7)])], 8, 3),
    "too much in the second strip": lambda: thunder(
        [bytes([RAW(5), RUN(7), RAW(6), RUN(7)]), bytes([RAW(1), RUN(20), RAW(2), RUN(7)])],
        8, 4, 2),
    "not enough: an odd pixel left": lambda: thunder([bytes([RAW(5), RAW(6), RAW(7)])], 16, 2),
    "not enough in the first strip": lambda: thunder(
        [bytes([RAW(5), RUN(7), RAW(6)]), bytes([RAW(1), RUN(7), RAW(2), RUN(7)])], 8, 4, 2),
    "not enough in the last strip": lambda: thunder(
        [bytes([RAW(5), RUN(7), RAW(6), RUN(7)]), bytes([RAW(1), RUN(3)])], 8, 4, 2),
    "tiles (no ThunderScan tile decoder: zeros)": lambda: thunder(
        [bytes([RAW(5), RUN(15)] * 16), bytes([RAW(6), RUN(15)] * 16)], 32, 16, tile=16),
    "tiles, orientation 3": lambda: thunder(
        [bytes([RAW(5), RUN(15)] * 16)] * 4, 32, 20, tile=16, extra=[(274, 3)]),
    **{f"random codes, seed {s}": (lambda s=s: _random_codes(s)) for s in range(12)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_thunderscan_reads_as_opencv(case, tmp_path):
    """The port's decode is cv2.imread's array bit for bit, its read_image
    the JAX package's."""
    _assert_reads_as_jax(_write(tmp_path, "a.tif", CASES[case]()))


def test_thunderscan_encode_emits_every_code_kind():
    """The writer's codes of a 16-level image hold runs, 2- and 3-bit deltas
    with skip codes and raw pixels, and decode back to the image."""
    idx = levels(0)
    codes = W.thunderscan_encode(idx)
    kinds = collections.Counter(c & 0xC0 for c in codes)
    assert all(kinds[k] >= 10 for k in (0x00, 0x40, 0x80, 0xC0)), kinds
    assert any(2 in ((c >> 4) & 3, (c >> 2) & 3, c & 3) for c in codes if c & 0xC0 == 0x40)
    assert any(4 in ((c >> 3) & 7, c & 7) for c in codes if c & 0xC0 == 0x80)
    raw, failed = decode_thunderscan(codes, idx.shape[1], idx.shape[0])
    got = np.frombuffer(raw, np.uint8).reshape(idx.shape[0], -1)
    got = np.stack([got >> 4, got & 15], -1).reshape(idx.shape[0], -1)[:, :idx.shape[1]]
    assert not failed and np.array_equal(got, idx)


def _refused(tmp_path, data: bytes, what: str) -> None:
    """cv2.imread gives no image, the JAX package raises IOError, the port
    NoImage naming what it met."""
    path = _write(tmp_path, "a.tif", data)
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(IOError):
        jio.read_image(path)
    with pytest.raises(tio.NoImage, match=what):
        tio.read_image(path)


THUNDER_REFUSED = {
    "4-bit gray": (dict(photo=1), "4-bit samples of photometric 1"),
    "4-bit min-is-white": (dict(photo=0), "4-bit samples of photometric 0"),
    "1-bit gray": (dict(bps=1, photo=1), "ThunderScan compression of 1-bit"),
    "2-bit palette": (dict(bps=2), "2-bit samples"),
    "8-bit palette": (dict(bps=8), "ThunderScan compression of 8-bit"),
    "8-bit gray": (dict(bps=8, photo=1), "ThunderScan compression of 8-bit"),
    "16-bit gray": (dict(bps=16, photo=1), "ThunderScan compression of 16-bit"),
}


@pytest.mark.parametrize("case", sorted(THUNDER_REFUSED))
def test_thunderscan_other_depths_and_gray_give_no_image(case, tmp_path):
    """ThunderScan decodes 4-bit samples only, and OpenCV reads 4 bits in
    palette files only."""
    kw, what = THUNDER_REFUSED[case]
    bps = kw.get("bps", 4)
    cmap = np.zeros((3, 1 << bps), np.uint16) if kw.get("photo", 3) == 3 else None
    _refused(tmp_path, thunder([bytes([RAW(5), RUN(15)] * 4)], 16, 4, cmap=cmap, **kw), what)


def _lt(bps: int, spp: int, photo: int, comp: int, extra=(), raw: bool = False,
        fmt: int = 1, width: int = 16, height: int = 8) -> bytes:
    """A file of the system's libtiff over seeded samples, a ramp colormap
    for a palette."""
    g = np.random.default_rng(bps * 10 + spp)
    fields = [(256, width), (257, height), (258, bps), (277, spp), (262, photo), (259, comp),
              (278, height)]
    if photo == 3:
        n = 1 << bps
        c = np.stack([np.arange(n) * 65535 // (n - 1)] * 3).astype(np.uint16)
        fields.append((320, c[0].copy(), c[1].copy(), c[2].copy()))
    if fmt == 3:
        data = g.uniform(0, 1, (height, width, spp)).astype(np.float32).tobytes()
        fields.append((339, 3))
    else:
        data = g.integers(0, 256, (width * spp * bps + 7) // 8 * height,
                          dtype=np.uint8).tobytes()
    return W.libtiff_encode([data], fields + list(extra), raw=raw)


ALPHA = (338, 1, np.array([2], np.uint16))
REPAIRED = {
    # OpenCV's readHeader refuses 2 bits in every photometric; the port read
    # a 2-bit palette
    "2-bit palette": (lambda: _lt(2, 1, 3, 1), "2-bit samples"),
    "2-bit palette, PackBits": (lambda: _lt(2, 1, 3, 32773), "2-bit samples"),
    # OpenCV's libtiff is built without PixarLog; the port raised a plain
    # ValueError
    **{f"PixarLog {k}": ((lambda a=a: _lt(*a)), "PixarLog")
       for k, a in {"8-bit gray": (8, 1, 1, 32909), "8-bit RGB": (8, 3, 2, 32909),
                    "8-bit RGBA": (8, 4, 2, 32909, [ALPHA]),
                    "8-bit RGB, horizontal predictor": (8, 3, 2, 32909, [(317, 2)]),
                    "16-bit gray": (16, 1, 1, 32909), "16-bit RGB": (16, 3, 2, 32909),
                    "float gray": (32, 1, 1, 32909, (), False, 3),
                    "float RGB": (32, 3, 2, 32909, (), False, 3)}.items()},
    # libtiff's NeXT decoder takes 2 bits, which OpenCV refuses; the port
    # raised a plain ValueError
    **{f"NeXT {k}": ((lambda a=a: _lt(*a, raw=True)), what)
       for k, (a, what) in {"1-bit gray": ((1, 1, 1, 32766), "NeXT"),
                            "2-bit gray": ((2, 1, 1, 32766), "2-bit samples"),
                            "2-bit palette": ((2, 1, 3, 32766), "2-bit samples"),
                            "4-bit palette": ((4, 1, 3, 32766), "NeXT"),
                            "8-bit gray": ((8, 1, 1, 32766), "NeXT"),
                            "8-bit palette": ((8, 1, 3, 32766), "NeXT"),
                            "16-bit gray": ((16, 1, 1, 32766), "NeXT")}.items()},
}


@pytest.mark.parametrize("case", sorted(REPAIRED))
def test_repaired_refusals_give_no_image(case, tmp_path):
    """A 2-bit palette, PixarLog and NeXT at every depth probed: cv2.imread
    gives no image, and the port raises NoImage (it read the 2-bit palette,
    and raised a plain ValueError for the others)."""
    make, what = REPAIRED[case]
    _refused(tmp_path, make(), what)


@pytest.mark.parametrize("photo", [0, 1, 3])
def test_one_bit_files_read_as_opencv(photo, tmp_path):
    """A 1-bit file reads as one channel in OpenCV: a 1-bit palette's
    colours weighed to gray (the port gave three channels)."""
    cmap = np.array([[0, 65535], [2816, 2816], [60000, 60000]], np.uint16)
    extra = [(320, cmap[0].copy(), cmap[1].copy(), cmap[2].copy())] if photo == 3 else []
    data = bytes([0x0F, 0xF0, 0x3C, 0xA5] * 8)
    fields = [(256, 16), (257, 16), (258, 1), (277, 1), (262, photo), (259, 1), (278, 16)]
    path = _write(tmp_path, "a.tif", W.libtiff_encode([data], fields + extra))
    _assert_reads_as_jax(path)
    assert tio.read_image(path).shape == (16, 16, 3)


def test_preprocess_skips_refused_files_as_the_jax_package(tmp_path):
    """make-masks and apply-alpha over a folder of files named .png: the
    refused files of the fixture (PixarLog, NeXT, a 2-bit palette,
    ThunderScan gray and 8-bit) beside a ThunderScan view and an RGBA PNG:
    both packages skip the same files and write the same masks (the port
    stopped at PixarLog before)."""
    files = {"rgba.png": D._cv2(".png", np.dstack([D.image(12), D.image(13, C=1)])),
             "thunder.png": coded(levels(14), 8)}
    root = os.path.join(FIXTURE, "refused")
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            files[name] = f.read()
    j, t = _preprocess_both(tmp_path, files)
    assert sorted(os.listdir(t / "masks")) == sorted(os.listdir(j / "masks")) == \
        ["rgba.png", "thunder.png"]
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


def _sha(arr) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def test_fixture_decodes_to_its_recorded_hashes():
    """tests/data_thunderscan: OpenCV and the port decode each view and mask
    to the hash recorded beside it and refuse each file of refused/ (what
    chip_smoke.py phase 8u holds on the card); the views' strips hold every
    code kind, the masks are binary, and load_image_folder gives the JAX
    package's arrays."""
    with open(os.path.join(FIXTURE, "opencv_sha256.json")) as f:
        expected = json.load(f)
    assert sum(v is None for v in expected.values()) == 16
    for key, want in expected.items():
        path = os.path.join(FIXTURE, key)
        with open(path, "rb") as f:
            data = f.read()
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if want is None:
            assert ref is None, key
            with pytest.raises(tio.NoImage):
                tio.decode_image(data, key)
            continue
        assert _directory(data)[259] == [32809], key
        assert _sha(ref[..., ::-1]) == want, key
        assert _sha(tio.decode_image(data, key)) == want, key
    for key in ("image/view0.png", "image/view1.jpg", "image/view2.png"):
        with open(os.path.join(FIXTURE, key), "rb") as f:
            data = f.read()
        t = _directory(data)
        codes = b"".join(data[o:o + n] for o, n in zip(t["offsets"], t["counts"]))
        if t.get(266, [1])[0] == 2:
            codes = codes.translate(REVERSED)
        assert {c & 0xC0 for c in codes} == {0x00, 0x40, 0x80, 0xC0}, key
    masks = [tio.read_image(os.path.join(FIXTURE, "mask", f"view{i}.png")) for i in range(3)]
    for m in masks:
        assert set(np.unique(m).tolist()) == {0.0, 1.0}
        assert np.array_equal(m, masks[0])
    got = load_image_folder(FIXTURE, mask_dir=os.path.join(FIXTURE, "mask"))
    ref = j_load_image_folder(FIXTURE, mask_dir=os.path.join(FIXTURE, "mask"))
    assert [os.path.basename(p) for p in got[0]] == ["view0.png", "view1.jpg", "view2.png"]
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(got[1][0], got[1][1]) and np.array_equal(got[1][0], got[1][2])
