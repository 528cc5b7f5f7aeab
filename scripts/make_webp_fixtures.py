"""Write tests/data_webp/: a three-view scene whose images and masks are
WebP and PAM files under the names the dataset lists, for the tests
(tests/test_torch_webp.py) and for chip_smoke.py's phase 8j on the card.

    python scripts/make_webp_fixtures.py

The views are tests/data_singleview/12.png shrunk to 256^2 (OpenCV's
INTER_AREA; the focal length and centre halved), one camera for all three,
named as the dataset lists images (`*.png` / `*.jpg`) but WebP inside, as a
photo saved from the web often is: view0.jpg lossy VP8 (OpenCV, quality
90), view1.png VP8X lossy with an ALPH chunk (PIL, quality 90; alpha 255 on
the object, 64 elsewhere), view2.png lossless VP8L (OpenCV).  The masks (a
pixel is foreground where any channel of the shrunk image reaches 5) are
view0.webp lossless (OpenCV), view1.pam a P7 GRAYSCALE file and
view2.webp lossy (OpenCV, quality 90).  Beside them, `opencv_sha256.json`:
for each file the shape, dtype and sha256 of the array
cv2.imread(IMREAD_UNCHANGED) decodes (channels in RGB order), which the
port's decoders must give on a machine without OpenCV.  Needs OpenCV and
PIL; the port needs neither to read the result.
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

    src = os.path.join(HERE, "tests", "data_singleview")
    out = os.path.join(HERE, "tests", "data_webp")
    os.makedirs(os.path.join(out, "image"), exist_ok=True)
    os.makedirs(os.path.join(out, "mask"), exist_ok=True)
    bgr = cv2.imread(os.path.join(src, "12.png"), cv2.IMREAD_UNCHANGED)
    scale = SIZE / bgr.shape[1]
    bgr = cv2.resize(bgr, (SIZE, SIZE), interpolation=cv2.INTER_AREA)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    mask = (rgb.max(-1) >= 5).astype(np.uint8) * 255

    def cv2_webp(img, quality):
        ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])
        assert ok
        return buf.tobytes()

    f = io.BytesIO()
    Image.fromarray(np.dstack([rgb, np.where(mask > 0, 255, 64).astype(np.uint8)]),
                    "RGBA").save(f, "WEBP", quality=90)
    images = {"view0.jpg": cv2_webp(bgr, 90), "view1.png": f.getvalue(),
              "view2.png": cv2_webp(bgr, 101)}
    masks = {"view0.webp": cv2_webp(mask, 101),
             "view1.pam": b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE\n"
                          b"ENDHDR\n" % (SIZE, SIZE) + mask.tobytes(),
             "view2.webp": cv2_webp(mask, 90)}
    assert images["view1.png"][12:16] == b"VP8X" and b"ALPH" in images["view1.png"]
    assert images["view2.png"][12:16] == b"VP8L" and images["view0.jpg"][12:16] == b"VP8 "
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
