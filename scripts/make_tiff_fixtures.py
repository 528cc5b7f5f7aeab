"""Write tests/data_tiff/: a three-view scene whose images and masks are TIFF
files of the variants slice 12 of the port reads, for the tests
(tests/test_torch_tiff.py) and for chip_smoke.py's phase 8l on the card.

    python scripts/make_tiff_fixtures.py

The views are tests/data_singleview/12.png shrunk to 256^2 (OpenCV's
INTER_AREA; the focal length and centre halved), one camera for all three,
named as the dataset lists images (`*.png` / `*.jpg`) but TIFF inside,
which OpenCV reads by its content: view0.jpg is YCbCr JPEG-in-TIFF with 2x2
subsampling in 128^2 tiles (the port's JPEG encoder at quality 75, its
tables moved to JPEGTables); view1.png a big-endian BigTIFF of float32
samples, the PNG's values / 255, Deflate with the floating-point predictor,
in strips of 32 rows; view2.png CMYK (K = 0, C, M, Y = 255 - R, G, B, so
its colour is the PNG's exactly) LZW with the horizontal predictor.  The
masks (a pixel is foreground where any channel of the shrunk image reaches
5): view0.tif Group 4 (PIL's libtiff), view1.tif Group 3 2D with FillOrder
2 (PIL's libtiff), view2.tif float64 0 / 1, Deflate with the
floating-point predictor.
Beside them, `opencv_sha256.json`: for each file the shape, dtype and sha256
of the array cv2.imread(IMREAD_UNCHANGED) decodes (channels in RGB order),
which the port's decoder must give on a machine without OpenCV.  Needs
OpenCV and PIL; the port needs neither to read the result.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZE = 256


def main() -> int:
    import cv2
    import numpy as np
    from PIL import Image
    sys.path.insert(0, os.path.join(HERE, "tests"))
    sys.path.insert(0, HERE)
    import image_format_writers as W

    src = os.path.join(HERE, "tests", "data_singleview")
    out = os.path.join(HERE, "tests", "data_tiff")
    os.makedirs(os.path.join(out, "image"), exist_ok=True)
    os.makedirs(os.path.join(out, "mask"), exist_ok=True)
    bgr = cv2.imread(os.path.join(src, "12.png"), cv2.IMREAD_UNCHANGED)
    scale = SIZE / bgr.shape[1]
    bgr = cv2.resize(bgr, (SIZE, SIZE), interpolation=cv2.INTER_AREA)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    mask = rgb.max(-1) >= 5

    def pil_bilevel(compression, **kw):
        f = io.BytesIO()
        Image.fromarray(mask).save(f, "TIFF", compression=compression, **kw)
        return f.getvalue()

    images = {"view0.jpg": W.encode_tiff(rgb, "jpeg", tile=(128, 128)),
              "view1.png": W.encode_tiff(rgb.astype(np.float32) / np.float32(255), "deflate", 3,
                                         rows_per_strip=32, big_endian=True, bigtiff=True,
                                         sample_format=3),
              "view2.png": W.encode_tiff(np.dstack([255 - rgb, np.zeros_like(rgb[..., :1])]),
                                         "lzw", True, photometric=5, rows_per_strip=64)}
    masks = {"view0.tif": pil_bilevel("group4"),
             "view1.tif": pil_bilevel("group3", tiffinfo={292: 1, 266: 2}),
             "view2.tif": W.encode_tiff(mask.astype(np.float64), "deflate", 3,
                                        rows_per_strip=64, sample_format=3)}
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
