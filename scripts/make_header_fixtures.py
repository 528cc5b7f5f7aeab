"""Write tests/data_header/: a three-view scene whose images and masks have
damaged headers that OpenCV still reads, and a folder of files of every
format whose damaged header OpenCV refuses, for the tests
(tests/test_torch_header.py) and for chip_smoke.py's phase 8q on the card.

    python scripts/make_header_fixtures.py

The views share one camera, that of tests/data_singleview/12.png shrunk
to 256^2 (OpenCV's INTER_AREA; the focal length and centre halved), and
show one image (views that contradict each other make a stage-1 run's
loss on a fixed batch rise), each named .png as the dataset lists them
(every reader goes by content):

  * image/view0.png: the shrunk image as a baseline JPEG (cv2.imencode,
    quality 95) whose JFIF segment's identifier is damaged (libjpeg skips
    the segment);
  * image/view1.png: view0 as cv2.imread decodes it, as lossless WebP
    whose VP8L chunk size is lowered below its data (libwebp reads the
    first chunk only and hands its decoder the bytes to the end);
  * image/view2.png: view0's decode as a Deflate TIFF of one strip whose
    StripByteCounts is 0 (libtiff estimates it from the file's size).

Their masks (a pixel is foreground where any channel of the shrunk image
reaches 5): mask/view0.png a 1-bit uncompressed TIFF of one strip whose
StripByteCounts is 50 bytes short (libtiff recomputes it from the image
size), mask/view1.png a Group 3 TIFF (PIL's libtiff) whose last row's
EOL is broken (libtiff decodes the strip again from its start without
EOLs into that row), mask/view2.png a PNG.  refused/ holds one file of
each format whose header damage OpenCV refuses, each named .png.
Beside them, `opencv_sha256.json`: for each view and mask the shape,
dtype and sha256 of the array cv2.imread(IMREAD_UNCHANGED) decodes
(channels in RGB order), and null for each refused file, where cv2.imread
gives None.  Needs OpenCV and PIL; the port needs neither to read the
result.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZE = 256


def _entry(data: bytes, tag: int) -> int:
    """The position of `tag`'s entry in a little-endian TIFF's first
    directory."""
    (off,) = struct.unpack("<I", data[4:8])
    (n,) = struct.unpack("<H", data[off:off + 2])
    for i in range(n):
        e = off + 2 + 12 * i
        if struct.unpack("<H", data[e:e + 2])[0] == tag:
            return e
    raise KeyError(tag)


def _with_field(data: bytes, tag: int, value: int) -> bytes:
    e = _entry(data, tag)
    typ = struct.unpack("<H", data[e + 2:e + 4])[0]
    body = struct.pack("<HH", value, 0) if typ == 3 else struct.pack("<I", value)
    return data[:e + 8] + body + data[e + 12:]


def _field(data: bytes, tag: int) -> int:
    e = _entry(data, tag)
    typ = struct.unpack("<H", data[e + 2:e + 4])[0]
    return struct.unpack("<H" if typ == 3 else "<I", data[e + 8:e + (10 if typ == 3 else 12)])[0]


def _eol_broken(data: bytes) -> bytes:
    """A Group 3 TIFF of one strip with its last EOL's 1 bit cleared."""
    off, n = _field(data, 273), _field(data, 279)
    bits = "".join(format(b, "08b") for b in data[off:off + n])
    at = bits.rfind("0" * 11 + "1") + 11
    bits = bits[:at] + "0" + bits[at + 1:]
    strip = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return data[:off] + strip + data[off + n:]


def main() -> int:
    import cv2
    import numpy as np
    from PIL import Image

    src = os.path.join(HERE, "tests", "data_singleview")
    out = os.path.join(HERE, "tests", "data_header")
    for d in ("image", "mask", "refused"):
        os.makedirs(os.path.join(out, d), exist_ok=True)
    bgr = cv2.imread(os.path.join(src, "12.png"), cv2.IMREAD_UNCHANGED)
    scale = SIZE / bgr.shape[1]
    bgr = cv2.resize(bgr, (SIZE, SIZE), interpolation=cv2.INTER_AREA)
    mask = (bgr.max(-1) >= 5).astype(np.uint8) * 255
    small = np.ascontiguousarray(cv2.resize(bgr, (32, 32), interpolation=cv2.INTER_AREA))

    def enc(ext, img, *flags):
        ok, buf = cv2.imencode(ext, img, list(flags))
        assert ok, ext
        return buf.tobytes()

    def pil(img, fmt, mode=None, **opts):
        f = io.BytesIO()
        pic = Image.fromarray(img, mode) if img.ndim == 2 else \
            Image.fromarray(np.ascontiguousarray(img[..., ::-1]))
        pic.save(f, fmt, **opts)
        return f.getvalue()

    jpg = bytearray(enc(".jpg", bgr, cv2.IMWRITE_JPEG_QUALITY, 95))
    assert jpg[6:10] == b"JFIF"
    jpg[7] = ord("X")                                # "JXIF": not a JFIF segment
    view0 = bytes(jpg)
    path0 = os.path.join(out, "image", "view0.png")
    with open(path0, "wb") as fh:
        fh.write(view0)
    bgr = cv2.imread(path0, cv2.IMREAD_UNCHANGED)

    webp = bytearray(enc(".webp", bgr, cv2.IMWRITE_WEBP_QUALITY, 101))
    assert webp[12:16] == b"VP8L"
    struct.pack_into("<I", webp, 16, struct.unpack_from("<I", webp, 16)[0] - 100)
    tif = pil(bgr, "TIFF", compression="tiff_adobe_deflate", strip_size=1 << 20)
    assert _field(tif, 278) == SIZE
    view2 = _with_field(tif, 279, 0)

    mask0 = pil(mask > 0, "TIFF")
    mask0 = _with_field(mask0, 279, _field(mask0, 279) - 50)
    mask1 = _eol_broken(pil(mask > 0, "TIFF", compression="group3"))
    images = {"view0.png": view0, "view1.png": bytes(webp), "view2.png": view2}
    masks = {"view0.png": mask0, "view1.png": mask1, "view2.png": enc(".png", mask)}

    # the refused files: small images of each format, a header byte damaged
    png = bytearray(enc(".png", small))
    png[20] ^= 0x40                                  # IHDR's height: its CRC fails
    jpeg = bytearray(enc(".jpg", small))
    k = jpeg.index(b"\xff\xc0")
    jpeg[k + 5:k + 7] = b"\x00\x00"                  # SOF height 0 (no DNL support)
    tiff = pil(small, "TIFF")
    webp_small = bytearray(enc(".webp", small, cv2.IMWRITE_WEBP_QUALITY, 101))
    struct.pack_into("<I", webp_small, 16, len(webp_small))     # VP8L past the file
    gif = bytearray(enc(".gif", small))
    gif[gif.index(b"!\xf9") + 3] = 0x10            # a graphic control's disposal method 4
    jp2 = pil(small, "JPEG2000")
    j2k = bytearray(pil(small, "JPEG2000", no_jp2=True, irreversible=True))
    cod = j2k.index(b"\xff\x52")
    j2k[cod + 8] = 2                                 # COD's component transform 2
    bmp = bytearray(enc(".bmp", small))
    bmp[28] = 52                                     # 52 bits a pixel
    ras = bytearray(enc(".ras", small))
    ras[27] = 40                                     # colour map type 40
    refused = {
        "jpeg_sof_height_0.png": bytes(jpeg),
        "png_ihdr_crc.png": bytes(png),
        "tiff_image_length_past_its_strip.png": _with_field(tiff, 257, 80),
        "tiff_rows_per_strip_0.png": _with_field(tiff, 278, 0),
        "webp_chunk_past_the_file.png": bytes(webp_small),
        "bmp_52_bits.png": bytes(bmp),
        "ppm_width_letter.png": enc(".ppm", small).replace(b"32 32", b"x2 32", 1),
        "pam_depth_misspelt.png": enc(".pam", small).replace(b"DEPTH", b"DEP4H"),
        "pfm_scale_0.png": enc(".pfm", small.astype(np.float32) / 255).replace(
            b"\n-1\n", b"\n-0\n", 1),
        "hdr_size_line.png": enc(".hdr", small.astype(np.float32) / 255).replace(
            b"+X", b"+\xb1", 1),
        "ras_map_type_40.png": bytes(ras),
        "gif_disposal_4.png": bytes(gif),
        "jp2_ftyp_renamed.png": jp2.replace(b"ftyp", b"ftyq", 1),
        "j2k_component_transform_2.png": bytes(j2k),
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
    views = [cv2.imread(os.path.join(out, "image", n), cv2.IMREAD_UNCHANGED) for n in images]
    assert all(np.array_equal(views[0], v) for v in views[1:]), "the views differ"
    with open(os.path.join(out, "opencv_sha256.json"), "w") as fh:
        json.dump(expected, fh, indent=1)
    sizes = {f"{d}/{k}": len(v) for d, files in groups for k, v in files.items()}
    print(f"wrote {out}: {len(images)} views, {len(refused)} refused files, "
          f"{sum(sizes.values())} bytes ({sizes})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
