"""Write tests/data_damaged/: a three-view scene whose images are damaged
JPEG files that OpenCV still reads, and a folder of damaged files of every
other format that OpenCV reads no image from, for the tests
(tests/test_torch_damaged.py) and for chip_smoke.py's phase 8o on the card.

    python scripts/make_damaged_fixtures.py

The views share one camera, that of tests/data_singleview/12.png shrunk
to 256^2 (OpenCV's INTER_AREA; the focal length and centre halved), and
show one image, each written by cv2.imencode and then damaged at places
drawn from a numpy generator seeded with SEED:

  * image/view0.jpg: the shrunk image, baseline, 4:2:0, cut at 60 % of its
    scan (libjpeg decodes the rest from zero coefficients: gray 128);
  * image/view1.jpg: view0 as cv2.imread decodes it, progressive, cut
    inside its ninth scan (of ten): the earlier scans' image with
    libjpeg-turbo's block smoothing;
  * image/view2.jpg: view0 as cv2.imread decodes it, with a restart
    interval of 2 MCUs, 8 bytes of one interval in the middle of the scan
    set to seeded values, and no EOI marker.

Views 1 and 2 start from view0's decode so that the three views of the one
camera agree but for their own damage, as a stage-1 run on them needs
(with view1 and view2 made from the shrunk image, 40 % of view0's pixels
would contradict them, and a fixed batch drawn from view0 gets worse as
the model learns the other two).

Their masks, mask/view{0,1,2}.png, are intact (a pixel is foreground where
any channel of the shrunk image reaches 5).  refused/ holds one damaged
file of each other format, each named .png (the dataset's name; every
reader goes by content): a JPEG cut before its first scan, a PNG without
its IEND chunk and one with a corrupt IDAT byte, a lossy WebP, an LZW TIFF,
a BMP, a PPM, a PAM, a PFM, a Radiance HDR, a Sun raster and a .jp2 cut at
60 %, and a GIF without its trailer.
Beside them, `opencv_sha256.json`: for each view and mask the shape, dtype
and sha256 of the array cv2.imread(IMREAD_UNCHANGED) decodes (channels in
RGB order), which the port's decoder must give on a machine without
OpenCV, and null for each refused file, where cv2.imread gives None.
Needs OpenCV; the port needs it not to read the result.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZE = 256
SEED = 19


def _sos_ends(data: bytes):
    """The position after each SOS segment of a JPEG (where its scan's
    entropy-coded data starts)."""
    out, i = [], 0
    while True:
        i = data.find(b"\xff\xda", i)
        if i < 0:
            return out
        out.append(i + 2 + ((data[i + 2] << 8) | data[i + 3]))
        i = out[-1]


def main() -> int:
    import cv2
    import numpy as np

    g = np.random.default_rng(SEED)
    src = os.path.join(HERE, "tests", "data_singleview")
    out = os.path.join(HERE, "tests", "data_damaged")
    for d in ("image", "mask", "refused"):
        os.makedirs(os.path.join(out, d), exist_ok=True)
    bgr = cv2.imread(os.path.join(src, "12.png"), cv2.IMREAD_UNCHANGED)
    scale = SIZE / bgr.shape[1]
    bgr = cv2.resize(bgr, (SIZE, SIZE), interpolation=cv2.INTER_AREA)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    mask = (rgb.max(-1) >= 5).astype(np.uint8) * 255
    small = np.ascontiguousarray(cv2.resize(bgr, (64, 64), interpolation=cv2.INTER_AREA))

    def enc(ext, img, *flags):
        ok, buf = cv2.imencode(ext, img, list(flags))
        assert ok, ext
        return buf.tobytes()

    base = enc(".jpg", bgr, cv2.IMWRITE_JPEG_QUALITY, 95)
    (start,) = _sos_ends(base)
    view0 = base[:start + int(0.6 * (len(base) - 2 - start))]
    with open(os.path.join(out, "image", "view0.jpg"), "wb") as fh:
        fh.write(view0)
    bgr = cv2.imread(os.path.join(out, "image", "view0.jpg"), cv2.IMREAD_UNCHANGED)

    prog = enc(".jpg", bgr, cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    starts = _sos_ends(prog)
    assert len(starts) == 10, len(starts)
    s9, s10 = starts[8], prog.rfind(b"\xff\xda", 0, starts[9])
    view1 = prog[:s9 + int(g.uniform(0.3, 0.7) * (s10 - s9))]

    rst = bytearray(enc(".jpg", bgr, cv2.IMWRITE_JPEG_QUALITY, 95,
                        cv2.IMWRITE_JPEG_RST_INTERVAL, 2))
    marks = [i for i in range(len(rst) - 1) if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]
    k = int(g.integers(len(marks) // 3, 2 * len(marks) // 3))
    lo, hi = marks[k] + 2, marks[k + 1]
    at = int(g.integers(lo, hi - 8))
    rst[at:at + 8] = g.integers(0, 256, 8).astype(np.uint8).tobytes()
    view2 = bytes(rst[:-2])

    images = {"view0.jpg": view0, "view1.jpg": view1, "view2.jpg": view2}
    masks = {f"view{i}.png": enc(".png", mask) for i in range(3)}

    # the refused files: small images of each format, damaged
    cut = lambda data: data[:int(0.6 * len(data))]
    jpg = enc(".jpg", small)
    png = enc(".png", small)
    idat = png.find(b"IDAT") + 4
    bad_idat = bytearray(png)
    bad_idat[idat + 20] ^= 0xFF
    refused = {
        "jpeg_cut_before_its_scan.png": jpg[:jpg.find(b"\xff\xda") - 40],
        "png_without_iend.png": png[:-12],
        "png_corrupt_idat.png": bytes(bad_idat),
        "webp_cut.png": cut(enc(".webp", small, cv2.IMWRITE_WEBP_QUALITY, 80)),
        "tiff_cut.png": cut(enc(".tif", small)),
        "bmp_cut.png": cut(enc(".bmp", small)),
        "ppm_cut.png": cut(enc(".ppm", small)),
        "pam_cut.png": cut(enc(".pam", small)),
        "pfm_cut.png": cut(enc(".pfm", small.astype(np.float32) / 255)),
        "hdr_cut.png": cut(enc(".hdr", small.astype(np.float32) / 255)),
        "ras_cut.png": cut(enc(".ras", small)),
        "gif_without_trailer.png": enc(".gif", small)[:-1],
        "jp2_cut.png": cut(enc(".jp2", small)),
    }
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
            if d == "refused":
                assert ref is None, name
                expected[f"{d}/{name}"] = None
                continue
            assert ref is not None, name
            if ref.ndim == 3:
                ref = ref[..., [2, 1, 0, 3][:ref.shape[2]]]
            ref = np.ascontiguousarray(ref)
            expected[f"{d}/{name}"] = {"shape": list(ref.shape), "dtype": str(ref.dtype),
                                       "sha256": hashlib.sha256(ref.tobytes()).hexdigest()}
    with open(os.path.join(out, "opencv_sha256.json"), "w") as fh:
        json.dump(expected, fh, indent=1)
    sizes = {f"{d}/{k}": len(v) for d, files in groups for k, v in files.items()}
    print(f"wrote {out}: {len(images)} views, {len(refused)} refused files, "
          f"{sum(sizes.values())} bytes ({sizes})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
