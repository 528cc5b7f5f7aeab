"""Write tests/data_formats/: a three-view scene whose images and masks are
in the formats the JAX package reads through OpenCV and the port reads with
its own decoders, for the tests (tests/test_torch_image_formats.py) and for
chip_smoke.py's stage-1 phase on the card.

    python scripts/make_format_fixtures.py

The views are tests/data_singleview/12.png shrunk to 256^2 (OpenCV's
INTER_AREA; the focal length and centre halved), one camera for all three:
view0 an Adobe CMYK JPEG (PIL), view1 a lossless JPEG (SOF3, predictor 1,
restart markers every 32 rows), view2 an arithmetic-coded progressive JPEG
(the system's libjpeg).  The masks (a pixel is foreground where any channel
of the shrunk image reaches 5, opened by a noise draw from seed 0 at the
border) are an RLE8 BMP, a 16-bit LZW TIFF with the predictor and a binary
PGM.  Beside them, `opencv_sha256.json`: for each file the shape, dtype and
sha256 of the array cv2.imread(IMREAD_UNCHANGED) decodes (channels in RGB
order), which the port's decoders must give on a machine without OpenCV
(chip_smoke.py phase 8i).  Needs OpenCV, PIL and libjpeg; the port needs
none of them to read the result.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "tests"))

SIZE = 256
SEED = 0


def main() -> int:
    import cv2
    import numpy as np
    from PIL import Image

    import image_format_writers as W

    src = os.path.join(HERE, "tests", "data_singleview")
    out = os.path.join(HERE, "tests", "data_formats")
    os.makedirs(os.path.join(out, "image"), exist_ok=True)
    os.makedirs(os.path.join(out, "mask"), exist_ok=True)
    bgr = cv2.imread(os.path.join(src, "12.png"), cv2.IMREAD_UNCHANGED)
    scale = SIZE / bgr.shape[1]
    bgr = cv2.resize(bgr, (SIZE, SIZE), interpolation=cv2.INTER_AREA)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    rng = np.random.default_rng(SEED)
    mask = (rgb.max(-1) >= 5).astype(np.uint8)
    edge = cv2.dilate(mask, np.ones((3, 3), np.uint8)) != cv2.erode(mask, np.ones((3, 3),
                                                                                 np.uint8))
    mask = np.where(edge & (rng.random(mask.shape) < 0.5), 1 - mask, mask) * 255

    cmyk = np.dstack([255 - rgb, np.zeros(rgb.shape[:2], np.uint8)])
    f = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(f, "JPEG", quality=92)
    images = {
        "view0.jpg": f.getvalue(),
        "view1.jpg": W.encode_lossless_jpeg(rgb, predictor=1, restart_rows=32),
        "view2.jpg": W.libjpeg_encode(rgb, arith=True, progressive=True, quality=92),
    }
    masks = {
        "view0.bmp": W.encode_bmp(mask, 8, np.repeat(np.arange(256, dtype=np.uint8)[:, None],
                                                     3, 1), rle=True),
        "view1.tif": W.encode_tiff(mask.astype(np.uint16) * 257, "lzw", True),
        "view2.pgm": b"P5\n%d %d\n255\n" % (SIZE, SIZE) + mask.tobytes(),
    }
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
    total = sum(len(v) for v in list(images.values()) + list(masks.values()))
    print(f"wrote {out}: {len(images)} views, {total} bytes of images and masks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
