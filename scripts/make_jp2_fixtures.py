"""Write tests/data_jp2/: a three-view scene whose images and masks are JPEG
2000 files under the names the dataset lists, for the tests
(tests/test_torch_jp2.py) and for chip_smoke.py's phase 8k on the card.

    python scripts/make_jp2_fixtures.py

The views are tests/data_singleview/12.png shrunk to 256^2 (OpenCV's
INTER_AREA; the focal length and centre halved), one camera for all three,
named as the dataset lists images (`*.png` / `*.jpg`) but JPEG 2000 inside,
which OpenCV reads by its content: view0.jpg is OpenCV's .jp2 at its
defaults (this OpenCV writes the reversible 5/3 without a colour transform,
lossless here); view1.png a PIL .jp2, reversible 5/3 with the RCT, 128^2
tiles, RPCL, 3 resolutions and 3 quality layers, the last lossless;
view2.png a PIL raw codestream, 9/7 with the ICT at rates 20 and 10 (so
code-blocks are cut mid-plane), 32^2 code-blocks, 64^2 precincts (halved at
each lower resolution), CPRL and PLT markers.  The masks (a pixel is
foreground where any channel of the shrunk image reaches 5): view0.jp2
8-bit gray lossless (PIL), view1.j2k 16-bit gray (0 / 65535) lossless
(PIL), view2.jp2 8-bit gray lossy (OpenCV at IMWRITE_JPEG2000_COMPRESSION_X1000
25: its 5/3 codestream cut at that rate, so reversible code-blocks end
mid-plane).
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

    src = os.path.join(HERE, "tests", "data_singleview")
    out = os.path.join(HERE, "tests", "data_jp2")
    os.makedirs(os.path.join(out, "image"), exist_ok=True)
    os.makedirs(os.path.join(out, "mask"), exist_ok=True)
    bgr = cv2.imread(os.path.join(src, "12.png"), cv2.IMREAD_UNCHANGED)
    scale = SIZE / bgr.shape[1]
    bgr = cv2.resize(bgr, (SIZE, SIZE), interpolation=cv2.INTER_AREA)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    mask = (rgb.max(-1) >= 5).astype(np.uint8) * 255

    def cv2_jp2(img, params=()):
        ok, buf = cv2.imencode(".jp2", img, list(params))
        assert ok
        return buf.tobytes()

    def pil(img, **kw):
        f = io.BytesIO()
        Image.fromarray(img).save(f, "JPEG2000", **kw)      # uint16 [H, W] is mode I;16
        return f.getvalue()

    images = {"view0.jpg": cv2_jp2(bgr),
              "view1.png": pil(rgb, irreversible=False, mct=1, tile_size=(128, 128),
                               progression="RPCL", num_resolutions=3,
                               quality_layers=[40, 10, 0]),
              "view2.png": pil(rgb, no_jp2=True, irreversible=True, quality_layers=[20, 10],
                               codeblock_size=(32, 32), precinct_size=(64, 64),
                               progression="CPRL", plt=True, mct=1)}
    masks = {"view0.jp2": pil(mask),
             "view1.j2k": pil(mask.astype(np.uint16) * 257, no_jp2=True),
             "view2.jp2": cv2_jp2(mask, (cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 25))}
    for name, data in list(images.items()) + list(masks.items()):
        raw = name == "view2.png" or name.endswith(".j2k")
        assert data[:4] == b"\xff\x4f\xff\x51" if raw else data[4:8] == b"jP  ", name
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
