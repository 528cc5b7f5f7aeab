"""Write tests/data_jp2_corners/: a three-view scene whose images and masks
are JPEG 2000 files that use the corners OpenCV reads (code-block styles,
POC, tile-parts, RGN, PPM / PPT, palettes, sYCC), written by the system's
OpenJPEG (tests/image_format_writers.openjpeg_encode), for the tests
(tests/test_torch_jp2_corners.py) and for chip_smoke.py's phase 8r on the
card.

    python scripts/make_jp2_corner_fixtures.py

The views are tests/data_singleview/12.png shrunk to 256^2 (OpenCV's
INTER_AREA; the focal length and centre halved), one camera for all three,
named as the dataset lists images but JPEG 2000 inside, which OpenCV reads
by its content:
  image/view0.png  .jp2, 5/3 with the RCT, code-block style 0x3F (BYPASS,
                   RESET, TERMALL, VSC, PTERM, SEGSYM), 3 layers (the last
                   lossless), a POC (resolutions 0-2 in LRCP, then 3-5 in
                   RLCP), tile-parts split by resolution;
  image/view1.jpg  raw codestream, 9/7 with the ICT at rates 12 and 4, an
                   RGN max-shift of 6 on component 0, its packet headers in
                   PPM markers of at most 4000 bytes;
  image/view2.png  .jp2 in the sYCC colour space: the view as OpenCV's
                   BGR2YUV gives it (rounded), lossless 5/3 without a
                   transform, which OpenCV turns back through YUV2BGR.
The masks (a pixel is foreground where any channel of the shrunk image
reaches 5), each 8-bit gray of 0 / 255: mask/view0.png BYPASS + TERMALL,
lossless 5/3; mask/view1.png an index image (0 / 1) with a 'pclr' of two
entries (0, 255) and its 'cmap', gray 'colr'; mask/view2.png a raw
codestream with its packet headers in PPT markers.
Beside them, `opencv_sha256.json`: for each file the shape, dtype and sha256
of the array cv2.imread(IMREAD_UNCHANGED) decodes (channels in RGB order),
which the port's decoder must give on a machine without OpenCV.  Needs
OpenCV and the system's libopenjp2; the port needs neither to read the
result.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZE = 256


def _palette_mask(W, mask) -> bytes:
    """mask (0 / 255) as a 1-bit-valued index image (0 / 1, 8-bit samples)
    with a 'pclr' of two entries, 0 and 255, and a 'cmap' mapping it."""
    import numpy as np
    jp2 = W.openjpeg_encode((mask > 0).astype(np.int64), space="gray")

    def box(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", 8 + len(body)) + kind + body

    boxes = box(b"pclr", struct.pack(">HBB", 2, 1, 7) + b"\x00\xff") + \
        box(b"cmap", struct.pack(">HBB", 0, 1, 0))
    h = jp2.index(b"jp2h") - 4
    n = struct.unpack_from(">I", jp2, h)[0]
    return jp2[:h] + struct.pack(">I", n + len(boxes)) + jp2[h + 4:h + n] + boxes + jp2[h + n:]


def main() -> int:
    import cv2
    import numpy as np
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import image_format_writers as W

    src = os.path.join(HERE, "tests", "data_singleview")
    out = os.path.join(HERE, "tests", "data_jp2_corners")
    os.makedirs(os.path.join(out, "image"), exist_ok=True)
    os.makedirs(os.path.join(out, "mask"), exist_ok=True)
    bgr = cv2.imread(os.path.join(src, "12.png"), cv2.IMREAD_UNCHANGED)
    scale = SIZE / bgr.shape[1]
    bgr = cv2.resize(bgr, (SIZE, SIZE), interpolation=cv2.INTER_AREA)
    rgb = np.ascontiguousarray(bgr[..., ::-1]).astype(np.int64)
    mask = (rgb.max(-1) >= 5).astype(np.int64) * 255
    yuv = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV).astype(np.int64)

    view1 = W.openjpeg_encode(rgb, j2k=True, irreversible=True, mct=1, rates=(12, 4),
                              roi=(0, 6))
    images = {
        "view0.png": W.openjpeg_encode(rgb, mct=1, mode=0x3F, rates=(20, 6, 1),
                                       pocs=[(0, 0, 3, 3, 3, "LRCP", 1),
                                             (3, 0, 3, 6, 3, "RLCP", 1)], tile_parts="R"),
        "view1.jpg": W.pack_packet_headers(view1, "PPM", 4000),
        "view2.png": W.openjpeg_encode(yuv, space="sycc"),
    }
    masks = {
        "view0.png": W.openjpeg_encode(mask, space="gray", mode=0x05),
        "view1.png": _palette_mask(W, mask),
        "view2.png": W.pack_packet_headers(W.openjpeg_encode(mask, j2k=True, rates=(4, 1)),
                                           "PPT", 2000),
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
            assert ref is not None, (d, name)
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
