"""Write tests/data_writers/ and tests/data_preprocess/: the inputs of the
port's image writers and of its `preprocess` commands, with what the JAX
package makes of them through OpenCV, for the tests
(tests/test_torch_writers.py) and for chip_smoke.py's phase 8m on the card.

    python scripts/make_writer_fixtures.py

tests/data_writers/inputs.npz holds three uint8 images made from
tests/data_singleview/12.png shrunk to 64 x 48 (OpenCV's INTER_AREA):
`rgb` [48, 64, 3], `gray` [48, 64] (its green channel) and `rgba`
[48, 64, 4] (alpha 255 inside a disc, falling to 0 outside it).  Its
`opencv_sha256.json` has, for each image and each extension the port's
write_image takes, what the JAX package's write_image (cv2.imwrite) gives:
  * "bytes": the file's sha256 and size, for the formats the port writes
    byte for byte as OpenCV does (.jpg / .jpeg / .jpe, .bmp / .dib, .pam,
    .ras / .sr, .pfm, .hdr / .pic, .pbm / .pgm / .ppm / .pnm);
  * "decoded": the shape, dtype and sha256 of cv2.imread(IMREAD_UNCHANGED)
    of the file (channels in RGB(A) order), for .png and .tif / .tiff (the
    JAX package's file) and .webp and .gif (the port's file: OpenCV's own
    differs, see tests/test_torch_writers.py), with OpenCV's own file's
    size beside the port's;
  * "refused": where OpenCV writes no file, or one it cannot read.
tests/data_preprocess/image/ holds seven `*.png` files of 32 x 24 pixels,
several of them not PNG or not RGBA inside: gray + alpha (PIL mode LA),
JPEG bytes, RGBA, RGBA of 16 bits, a palette with tRNS (PIL), gray, and
bytes of no image format.  Its `opencv_sha256.json` has the decoded
arrays (as above) of every file the JAX package's `preprocess make-masks`
then `apply-alpha` leave in a copy of the folder (image/<name>, null where
OpenCV reads no image) and in its masks/ folder (masks/<name>).  Needs
OpenCV, PIL and the JAX package; the port needs none of them to hold its
output to these hashes.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every extension the port's write_image takes, as cv2.imwrite picks the
# format; those written byte for byte as OpenCV writes them
EXTENSIONS = (".png", ".jpg", ".jpeg", ".jpe", ".bmp", ".dib", ".tif", ".tiff", ".pbm", ".pgm",
              ".ppm", ".pnm", ".pam", ".ras", ".sr", ".pfm", ".hdr", ".pic", ".webp", ".gif")
BYTE_EQUAL = (".jpg", ".jpeg", ".jpe", ".bmp", ".dib", ".pbm", ".pgm", ".ppm", ".pnm", ".pam",
              ".ras", ".sr", ".pfm", ".hdr", ".pic")
PORT_DECODED = (".webp", ".gif")        # the hash is of the port's file, decoded by OpenCV


def decoded_record(arr) -> dict:
    """shape, dtype and sha256 of an array cv2.imread returned, its
    channels put in RGB(A) order."""
    import numpy as np
    if arr.ndim == 3 and arr.shape[2] >= 3:
        arr = arr[..., [2, 1, 0, 3][:arr.shape[2]]]
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def writer_inputs():
    import cv2
    import numpy as np
    bgr = cv2.imread(os.path.join(HERE, "tests", "data_singleview", "12.png"),
                     cv2.IMREAD_UNCHANGED)
    rgb = np.ascontiguousarray(cv2.resize(bgr, (64, 48), interpolation=cv2.INTER_AREA)[..., ::-1])
    yy, xx = np.mgrid[0:48, 0:64]
    r = np.hypot(yy - 24, xx - 32)
    alpha = np.clip((26 - r) * 32, 0, 255).astype(np.uint8)
    return {"rgb": rgb, "gray": np.ascontiguousarray(rgb[..., 1]),
            "rgba": np.dstack([rgb, alpha])}


def write_writers(out: str) -> None:
    import cv2
    import numpy as np
    from iron_tpu.data import io as jio
    from iron_tpu_torch.data import io as tio
    inputs = writer_inputs()
    os.makedirs(out, exist_ok=True)
    np.savez_compressed(os.path.join(out, "inputs.npz"), **inputs)
    manifest = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, img in inputs.items():
            for ext in EXTENSIONS:
                j, t = os.path.join(tmp, "j" + ext), os.path.join(tmp, "t" + ext)
                for p in (j, t):
                    if os.path.exists(p):
                        os.remove(p)
                jio.write_image(j, img)
                ref = cv2.imread(j, cv2.IMREAD_UNCHANGED) if os.path.exists(j) else None
                key = f"{name}{ext}"
                if ref is None:
                    try:
                        tio.write_image(t, img)
                    except ValueError as e:
                        manifest[key] = {"refused": str(e).split(": ", 1)[-1]}
                        assert not os.path.exists(t), key
                        continue
                    raise AssertionError(f"{key}: OpenCV writes no readable file; the port did")
                tio.write_image(t, img)
                with open(j, "rb") as f:
                    jb = f.read()
                with open(t, "rb") as f:
                    tb = f.read()
                if ext in BYTE_EQUAL:
                    assert tb == jb, key
                    manifest[key] = {"bytes": {"sha256": hashlib.sha256(tb).hexdigest(),
                                               "size": len(tb)}}
                    continue
                ours = cv2.imread(t, cv2.IMREAD_UNCHANGED)
                if ext not in PORT_DECODED:
                    assert ours.shape == ref.shape and np.array_equal(ours, ref), key
                manifest[key] = {"decoded": decoded_record(ours), "size": len(tb),
                                 "opencv_size": len(jb)}
    with open(os.path.join(out, "opencv_sha256.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")


def preprocess_inputs():
    """name -> the bytes of each `*.png` of tests/data_preprocess/image/."""
    import cv2
    import numpy as np
    from PIL import Image
    rgba = writer_inputs()["rgba"][8:32, 16:48]            # 24 x 32
    rgb = np.ascontiguousarray(rgba[..., :3])
    bgra = np.ascontiguousarray(rgba[..., [2, 1, 0, 3]])

    def pil(im, **kw):
        f = io.BytesIO()
        im.save(f, "PNG", **kw)
        return f.getvalue()

    def cv(img, ext=".png"):
        ok, buf = cv2.imencode(ext, img)
        assert ok
        return buf.tobytes()

    gray = rgb[..., 1]
    pal = Image.fromarray(rgb).quantize(16, dither=Image.Dither.NONE)
    idx = np.asarray(pal)
    idx = np.where(rgba[..., 3] == 0, 0, idx)
    pal_im = Image.fromarray(idx.astype(np.uint8), "P")
    pal_im.putpalette(pal.getpalette())
    noise = np.random.default_rng(16).integers(0, 256, 96, dtype=np.uint8).tobytes()
    return {
        "gray_alpha.png": pil(Image.fromarray(np.dstack([gray, rgba[..., 3]]), "LA")),
        "jpeg_inside.png": cv(rgb[..., ::-1], ".jpg"),
        "rgba.png": cv(bgra),
        "rgba16.png": cv(bgra.astype(np.uint16) * 257 + 3),
        "palette_trns.png": pil(pal_im, transparency=0),
        "gray.png": cv(gray),
        "no_image.png": b"\x00no image\x00" + noise,
    }


def run_jax_preprocess(root: str) -> dict:
    """The JAX package's make-masks then apply-alpha on a copy of root's
    image/ folder -> the manifest of what they leave."""
    import cv2
    from iron_tpu.cli import preprocess as jpre
    manifest = {}
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(root, "image"), os.path.join(tmp, "image"))
        jpre.main(["make-masks", "--image_dir", os.path.join(tmp, "image")])
        jpre.main(["apply-alpha", "--image_dir", os.path.join(tmp, "image")])
        for sub in ("image", "masks"):
            for name in sorted(os.listdir(os.path.join(tmp, sub))):
                img = cv2.imread(os.path.join(tmp, sub, name), cv2.IMREAD_UNCHANGED)
                manifest[f"{sub}/{name}"] = None if img is None else decoded_record(img)
    return manifest


def write_preprocess(out: str) -> None:
    os.makedirs(os.path.join(out, "image"), exist_ok=True)
    for name, data in preprocess_inputs().items():
        with open(os.path.join(out, "image", name), "wb") as f:
            f.write(data)
    with open(os.path.join(out, "opencv_sha256.json"), "w") as fh:
        json.dump(run_jax_preprocess(out), fh, indent=1, sort_keys=True)
        fh.write("\n")


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, HERE)
    write_writers(os.path.join(HERE, "tests", "data_writers"))
    write_preprocess(os.path.join(HERE, "tests", "data_preprocess"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
