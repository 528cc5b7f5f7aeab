"""Write tests/data_tiff_wide/: a three-view scene whose images and masks are
TIFF files of the corners slice 16 of the port reads (10- to 14-bit
samples, gray of three samples, SGILOG LogLuv), for the tests
(tests/test_torch_tiff_wide.py) and for chip_smoke.py's phase 8p on the
card.

    python scripts/make_tiff_wide_fixtures.py

The views are tests/data_singleview/12.png shrunk to 256^2 (OpenCV's
INTER_AREA; the focal length and centre halved), one camera for all three,
named as the dataset lists images (`*.png` / `*.jpg`) but TIFF inside,
which OpenCV reads by its content, all written by the system's libtiff
(ctypes): view0.jpg 12-bit RGB (each 8-bit sample's bits repeated to 12),
LZW in strips of 32 rows; view1.png big-endian 10-bit RGB, Deflate in 64^2
tiles; view2.png LogLuv32 (SGILOG, no dither) of the XYZ that OpenCV's
XYZ -> RGB matrix takes back to the PNG's RGB / 255.  The masks (a pixel
is foreground where any channel of the shrunk image reaches 5): view0.tif
16-bit gray of three samples (OpenCV weighs them to one channel), view1.tif
14-bit gray PackBits, view2.tif 12-bit gray LZW with FillOrder 2; OpenCV
shifts the last two to 16 bits, so their foreground reads as 65532 and
65520 of 65535.
Beside them, `opencv_sha256.json`: for each file the shape, dtype and sha256
of the array cv2.imread(IMREAD_UNCHANGED) decodes (channels in RGB order),
which the port's decoder must give on a machine without OpenCV.  Needs
OpenCV and the system's libtiff; the port needs neither to read the result.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZE = 256
# OpenCV's XYZ -> sRGB matrix (color_lab.cpp), whose inverse makes view2's XYZ
XYZ2RGB = ((3.240479, -1.53715, -0.498535), (-0.969256, 1.875991, 0.041556),
           (0.055648, -0.204043, 1.057311))


def main() -> int:
    import cv2
    import numpy as np
    sys.path.insert(0, os.path.join(HERE, "tests"))
    sys.path.insert(0, HERE)
    import image_format_writers as W

    src = os.path.join(HERE, "tests", "data_singleview")
    out = os.path.join(HERE, "tests", "data_tiff_wide")
    os.makedirs(os.path.join(out, "image"), exist_ok=True)
    os.makedirs(os.path.join(out, "mask"), exist_ok=True)
    bgr = cv2.imread(os.path.join(src, "12.png"), cv2.IMREAD_UNCHANGED)
    scale = SIZE / bgr.shape[1]
    bgr = cv2.resize(bgr, (SIZE, SIZE), interpolation=cv2.INTER_AREA)
    rgb = np.ascontiguousarray(bgr[..., ::-1]).astype(np.uint16)
    mask = (rgb.max(-1) >= 5).astype(np.uint16)

    def libtiff(a, bps, comp, photo, rows=None, tile=None, mode="w", extra=()):
        """`a` [H, W, spp] at `bps` bits a sample through the system's
        libtiff, in strips of `rows` rows or `tile`-square tiles."""
        fields = [(256, SIZE), (257, SIZE), (258, bps), (277, a.shape[2]), (259, comp),
                  (262, photo)]
        if tile:
            fields += [(322, tile), (323, tile)]
            chunks = [a[y:y + tile, x:x + tile] for y in range(0, SIZE, tile)
                      for x in range(0, SIZE, tile)]
        else:
            fields.append((278, rows))
            chunks = [a[y:y + rows] for y in range(0, SIZE, rows)]
        if bps % 8:
            chunks = [W.pack_samples(c, bps).tobytes() for c in chunks]
        return W.libtiff_encode(chunks, fields + list(extra), mode=mode, tiled=bool(tile))

    xyz = (rgb.astype(np.float32) / np.float32(255)) @ np.linalg.inv(
        np.asarray(XYZ2RGB, np.float64)).T.astype(np.float32)
    images = {"view0.jpg": libtiff((rgb << 4) | (rgb >> 4), 12, 5, 2, rows=32),
              "view1.png": libtiff((rgb << 2) | (rgb >> 6), 10, 8, 2, tile=64, mode="wb"),
              "view2.png": W.libtiff_encode(
                  [xyz.astype(np.float32)], [(256, SIZE), (257, SIZE), (277, 3), (262, 32845),
                                             (259, 34676), (65560, 0), (65561, 0),
                                             (278, SIZE)])}
    masks = {"view0.tif": libtiff(np.repeat(mask[..., None] * 65535, 3, -1).astype(np.uint16),
                                  16, 8, 1, rows=64),
             "view1.tif": libtiff(mask[..., None] * 16383, 14, 32773, 1, rows=SIZE),
             "view2.tif": libtiff(mask[..., None] * 4095, 12, 5, 1, rows=SIZE,
                                  extra=[(266, 2)])}
    with open(os.path.join(src, "cam_dict_norm.json")) as fh:
        cam = json.load(fh)["12.png"]
    K = np.asarray(cam["K"], np.float64).reshape(4, 4)
    K[:2, :3] *= scale
    cams = {name: {"K": K.ravel().tolist(), "W2C": cam["W2C"], "img_size": [SIZE, SIZE]}
            for name in images}
    for d, files in (("image", images), ("mask", masks)):
        for name, data in files.items():
            with open(os.path.join(out, d, name), "wb") as fh:
                fh.write(data)
    with open(os.path.join(out, "cam_dict_norm.json"), "w") as fh:
        json.dump(cams, fh, indent=1)
    expected = {}
    for d, files in (("image", images), ("mask", masks)):
        for name in files:
            ref = cv2.imread(os.path.join(out, d, name), cv2.IMREAD_UNCHANGED)
            if ref.ndim == 3:
                ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
            ref = np.ascontiguousarray(ref)
            expected[f"{d}/{name}"] = {"shape": list(ref.shape), "dtype": str(ref.dtype),
                                       "sha256": hashlib.sha256(ref.tobytes()).hexdigest()}
    with open(os.path.join(out, "opencv_sha256.json"), "w") as fh:
        json.dump(expected, fh, indent=1)
    sizes = {f"{d}/{k}": len(v) for d, files in (("image", images), ("mask", masks))
             for k, v in files.items()}
    print(f"wrote {out}: {len(images)} views, {sum(sizes.values())} bytes of images and masks "
          f"({sizes})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
