"""Write tests/data_jp2w/: the inputs of the port's JPEG 2000 writer
(iron_tpu_torch/data/jp2_enc.py) with what cv2.imwrite makes of them, for
the tests (tests/test_torch_jp2_writer.py) and for chip_smoke.py's phase 8n
on the card.

    python scripts/make_jp2w_fixtures.py

tests/data_jp2w/inputs.npz holds uint8 images in the file's channel order
(gray, RGB, RGBA), made from seed 17 and from the repository's images:

  * the "required" set, which OpenCV's file decodes exactly (the 4:1 rate
    cut does not bind): integer ramps from 32 x 32 up to odd sizes
    (33 x 65, 65 x 33, 37 x 40 RGBA, 48 x 32 gray),
    tests/data_singleview/12.png at 512^2 and the mask
    tests/data_jp2/mask/view0.jp2;
  * the "cut" set, where the cut binds and OpenCV's file is lossy: seeded
    uniform noise (53 x 37 RGB, 64 x 64 gray, 32 x 32 RGBA) and crops of
    12.png with seeded Gaussian texture (96 x 80, 71 x 45 RGB);
  * the three images of tests/data_writers/inputs.npz (12.png shrunk to
    64 x 48), in the set their decode puts them in: the cut binds for each.

tests/data_jp2w/opencv_sha256.json has, for each image, its set, the sha256
and size of cv2.imencode(".jp2") of it (the image's channels put in
OpenCV's order), and the shape, dtype and sha256 of cv2.imdecode of those
bytes (channels back in RGB(A) order), whether that decode equals the image
and, where it does not, its PSNR.  Needs OpenCV; the port needs none of it
to hold its output to these hashes.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 17


def to_opencv(img: np.ndarray) -> np.ndarray:
    """RGB(A) -> BGR(A); gray unchanged."""
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return np.ascontiguousarray(img)


def record(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64).reshape(a.shape)) ** 2))
    return 10 * np.log10(255.0 ** 2 / mse)


def _ramp(g, h: int, w: int, c: int) -> np.ndarray:
    """Integer ramps (a slope of -2..2 a pixel each way, a channel): small
    images OpenCV's cut leaves exact."""
    yy, xx = np.mgrid[0:h, 0:w]
    n = max(c, 1)
    sx, sy, base = g.integers(-2, 3, n), g.integers(-2, 3, n), g.integers(40, 216, n)
    chans = [np.clip(b + a * (xx - w // 2) + d * (yy - h // 2), 0, 255)
             for a, d, b in zip(sx, sy, base)]
    return (np.stack(chans, -1) if c else chans[0]).astype(np.uint8)


def inputs() -> dict:
    """name -> (set, or None where OpenCV's decode decides it; uint8 image in
    the file's channel order)."""
    import cv2
    g = np.random.default_rng(SEED)
    out = {}
    for name, (h, w, c) in {"ramp_32x32": (32, 32, 3), "ramp_33x65": (33, 65, 3),
                            "ramp_65x33": (65, 33, 3), "ramp_37x40_rgba": (37, 40, 4),
                            "ramp_48x32_gray": (48, 32, 0)}.items():
        out[name] = ("required", _ramp(g, h, w, c))
    writers = np.load(os.path.join(HERE, "tests", "data_writers", "inputs.npz"))
    for name in ("rgb", "gray", "rgba"):
        out[f"writers_{name}"] = (None, writers[name])
    bgr = cv2.imread(os.path.join(HERE, "tests", "data_singleview", "12.png"))
    out["singleview_12"] = ("required", np.ascontiguousarray(bgr[..., ::-1]))
    out["mask_view0"] = ("required", cv2.imread(
        os.path.join(HERE, "tests", "data_jp2", "mask", "view0.jp2"), cv2.IMREAD_UNCHANGED))
    out["noise_53x37"] = ("cut", g.integers(0, 256, (37, 53, 3), np.uint8))
    out["noise_64_gray"] = ("cut", g.integers(0, 256, (64, 64), np.uint8))
    out["noise_32_rgba"] = ("cut", g.integers(0, 256, (32, 32, 4), np.uint8))
    for name, (y, x, h, w) in {"texture_96x80": (200, 180, 80, 96),
                               "texture_71x45": (260, 300, 45, 71)}.items():
        crop = bgr[y:y + h, x:x + w, ::-1].astype(np.float64)
        out[name] = ("cut", np.clip(np.rint(crop + g.normal(0, 24, crop.shape)), 0, 255)
                     .astype(np.uint8))
    return out


def main() -> int:
    import cv2
    root = os.path.join(HERE, "tests", "data_jp2w")
    os.makedirs(root, exist_ok=True)
    images = inputs()
    np.savez_compressed(os.path.join(root, "inputs.npz"),
                        **{k: v for k, (_, v) in images.items()})
    manifest = {}
    for name, (kind, img) in images.items():
        ok, buf = cv2.imencode(".jp2", to_opencv(img))
        assert ok, name
        data = buf.tobytes()
        back = to_opencv(cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))       # BGR(A) -> RGB(A)
        exact = bool(np.array_equal(back.reshape(img.shape), img))
        assert kind is None or exact == (kind == "required"), (name, kind, exact)
        kind = kind or ("required" if exact else "cut")
        manifest[name] = {"set": kind, "bytes": {"sha256": hashlib.sha256(data).hexdigest(),
                                                 "size": len(data)},
                          "decoded": record(back), "exact": exact,
                          "psnr": None if exact else psnr(img, back)}
    with open(os.path.join(root, "opencv_sha256.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
