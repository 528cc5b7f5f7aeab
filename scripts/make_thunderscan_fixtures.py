"""Write tests/data_thunderscan/: a three-view scene whose images and masks
are ThunderScan TIFF files (compression 32809, 4-bit palette), and beside
them refused/, files of the compressions and depths OpenCV reads no image
from, for the tests (tests/test_torch_thunderscan.py) and for
chip_smoke.py's phase 8u on the card.

    python scripts/make_thunderscan_fixtures.py

The views are tests/data_singleview/12.png shrunk to 256^2 (OpenCV's
INTER_AREA; the focal length and centre halved) and cut to 16 colours:
black where no channel reaches 5, else one of 15 bins of luminance
(0.299 R + 0.587 G + 0.114 B) split at its quantiles over the foreground,
each bin's colour the mean of its pixels, bin k at palette index 5 k mod
16.  One camera for all three, the
files named as the dataset lists images, each coded by
tests/image_format_writers.thunderscan_encode (every code kind) and
stored raw by the system's libtiff:
  image/view0.png  strips of 16 rows, a 16-bit colormap, little-endian;
  image/view1.jpg  strips of 7 rows, FillOrder 2, big-endian;
  image/view2.png  one strip, an 8-bit colormap, Orientation 3 (stored
                   turned, so that it reads as the others).
The masks (foreground where any channel of the shrunk image reaches 5) are
2-entry palettes (black, white) in 4 bits: mask/view0.png strips of 32
rows, mask/view1.png one strip with FillOrder 2, mask/view2.png strips of 5
rows with Orientation 4 (stored flipped).
refused/ holds 16 x 8 files named .png that cv2.imread gives no image for:
PixarLog (8-bit gray, RGB and RGBA, 16-bit gray and RGB, float gray and
RGB), NeXT (1-bit, 2-bit gray and palette, 4-bit palette, 8-bit, 16-bit),
a 2-bit palette without compression, ThunderScan of 4-bit gray and of an
8-bit palette.
Beside them, `opencv_sha256.json`: for each file the shape, dtype and sha256
of the array cv2.imread(IMREAD_UNCHANGED) decodes (channels in RGB order),
or null where it reads none, which the port's decoder must give on a
machine without OpenCV.  Needs OpenCV and the system's libtiff; the port
needs neither to read the result.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZE = 256


def _palette(rgb, mask):
    """(16-level index image, 16 x 3 palette): black (index 0) off the
    mask, 15 luminance bins on it, bin k at index 5 k mod 16, so that
    neighbouring bins differ by 5 or 6 indices and the coder needs every
    code kind."""
    import numpy as np
    lum = rgb @ np.array([0.299, 0.587, 0.114])
    edges = np.quantile(lum[mask], np.linspace(0, 1, 16)[1:-1])
    bins = np.where(mask, 1 + np.searchsorted(edges, lum, side="right"), 0)
    pal = np.zeros((16, 3), np.int64)
    for k in range(1, 16):
        if (bins == k).any():
            pal[5 * k % 16] = np.round(rgb[bins == k].mean(0))
    return 5 * bins % 16, pal


def thunder_file(W, idx, cmap, rows: int, extra=(), mode: str = "w") -> bytes:
    """`idx` [H, W_] (4-bit values) as a ThunderScan palette TIFF: strips of
    `rows` rows coded by thunderscan_encode, `cmap` [3, 16] the ColorMap,
    then the fields of `extra` (a FillOrder of 2 reverses every strip's
    bits, as libtiff reads them)."""
    import numpy as np
    H, W_ = idx.shape
    strips = [W.thunderscan_encode(idx[y:y + rows]) for y in range(0, H, rows)]
    if any(tag == 266 and v[0] == 2 for tag, *v in extra):
        rev = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))
        strips = [s.translate(rev) for s in strips]
    c = np.asarray(cmap, np.uint16)
    fields = [(256, W_), (257, H), (258, 4), (277, 1), (262, 3), (259, 32809), (278, rows),
              (320, c[0].copy(), c[1].copy(), c[2].copy())]
    return W.libtiff_encode(strips, fields + list(extra), mode=mode, raw=True)


def refused_files(W) -> dict:
    """name -> a 16 x 8 file cv2.imread gives no image for."""
    import numpy as np
    g = np.random.default_rng(21)
    w, h = 16, 8

    def lt(bps, spp, photo, comp, data, extra=(), raw=False):
        fields = [(256, w), (257, h), (258, bps), (277, spp), (262, photo), (259, comp),
                  (278, h)]
        if photo == 3:
            n = 1 << bps
            cmap = np.stack([np.arange(n) * 65535 // (n - 1)] * 3).astype(np.uint16)
            fields.append((320, cmap[0].copy(), cmap[1].copy(), cmap[2].copy()))
        return W.libtiff_encode([data], fields + list(extra), raw=raw)

    def noise(bps, spp):
        return g.integers(0, 256, (w * spp * bps + 7) // 8 * h, dtype=np.uint8).tobytes()

    pixar = {"gray8": (8, 1, 1), "rgb8": (8, 3, 2), "rgba8": (8, 4, 2), "gray16": (16, 1, 1),
             "rgb16": (16, 3, 2)}
    files = {f"pixarlog_{k}.png": lt(b, s, p, 32909, noise(b, s),
                                     [(338, 1, np.array([2], np.uint16))] if s == 4 else ())
             for k, (b, s, p) in pixar.items()}
    for k, spp in (("gray", 1), ("rgb", 3)):
        files[f"pixarlog_float_{k}.png"] = lt(
            32, spp, 1 if spp == 1 else 2, 32909,
            g.uniform(0, 1, (h, w, spp)).astype(np.float32).tobytes(), [(339, 3)])
    for k, (bps, photo) in {"1": (1, 1), "2_gray": (2, 1), "2_palette": (2, 3),
                            "4_palette": (4, 3), "8": (8, 1), "16": (16, 1)}.items():
        files[f"next_{k}.png"] = lt(bps, 1, photo, 32766, noise(bps, 1), raw=True)
    files["palette_2bit.png"] = lt(2, 1, 3, 1, noise(2, 1))
    files["thunderscan_gray4.png"] = lt(4, 1, 1, 32809, bytes([0xC5, 15] * h), raw=True)
    files["thunderscan_palette8.png"] = lt(8, 1, 3, 32809, bytes([0xC5, 15] * h), raw=True)
    return files


def main() -> int:
    import cv2
    import numpy as np
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import image_format_writers as W

    src = os.path.join(HERE, "tests", "data_singleview")
    out = os.path.join(HERE, "tests", "data_thunderscan")
    for d in ("image", "mask", "refused"):
        os.makedirs(os.path.join(out, d), exist_ok=True)
    bgr = cv2.imread(os.path.join(src, "12.png"), cv2.IMREAD_UNCHANGED)
    scale = SIZE / bgr.shape[1]
    bgr = cv2.resize(bgr, (SIZE, SIZE), interpolation=cv2.INTER_AREA)
    rgb = np.ascontiguousarray(bgr[..., ::-1]).astype(np.int64)
    mask = rgb.max(-1) >= 5
    idx, pal = _palette(rgb, mask)
    cmap16 = (pal.T * 257).astype(np.uint16)
    cmap8 = pal.T.astype(np.uint16)
    bw = np.zeros((3, 16), np.uint16)
    bw[:, 1] = 65535
    m = mask.astype(np.int64)
    images = {
        "view0.png": thunder_file(W, idx, cmap16, 16),
        "view1.jpg": thunder_file(W, idx, cmap16, 7, [(266, 2)], mode="wb"),
        "view2.png": thunder_file(W, idx[::-1, ::-1], cmap8, SIZE, [(274, 3)]),
    }
    masks = {
        "view0.png": thunder_file(W, m, bw, 32),
        "view1.png": thunder_file(W, m, bw, SIZE, [(266, 2)]),
        "view2.png": thunder_file(W, m[::-1], bw, 5, [(274, 4)]),
    }
    refused = refused_files(W)
    with open(os.path.join(src, "cam_dict_norm.json")) as fh:
        cam = json.load(fh)["12.png"]
    K = np.asarray(cam["K"], np.float64).reshape(4, 4)
    K[:2, :3] *= scale
    cams = {name: {"K": K.ravel().tolist(), "W2C": cam["W2C"], "img_size": [SIZE, SIZE]}
            for name in images}
    groups = (("image", images), ("mask", masks), ("refused", refused))
    for d, files in groups:
        for name, data in files.items():
            with open(os.path.join(out, d, name), "wb") as fh:
                fh.write(data)
    with open(os.path.join(out, "cam_dict_norm.json"), "w") as fh:
        json.dump(cams, fh, indent=1)
    expected = {}
    for d, files in groups:
        for name in files:
            ref = cv2.imread(os.path.join(out, d, name), cv2.IMREAD_UNCHANGED)
            assert (ref is None) == (d == "refused"), (d, name)
            if ref is None:
                expected[f"{d}/{name}"] = None
                continue
            if ref.ndim == 3:
                ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
            ref = np.ascontiguousarray(ref)
            expected[f"{d}/{name}"] = {"shape": list(ref.shape), "dtype": str(ref.dtype),
                                       "sha256": hashlib.sha256(ref.tobytes()).hexdigest()}
    with open(os.path.join(out, "opencv_sha256.json"), "w") as fh:
        json.dump(expected, fh, indent=1)
    total = sum(len(v) for _, files in groups for v in files.values())
    print(f"wrote {out}: {len(images)} views, {len(refused)} refused files, {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
