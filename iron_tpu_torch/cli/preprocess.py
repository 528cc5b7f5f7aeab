"""Dataset preprocessing utilities (counterpart of iron_tpu/cli/preprocess.py;
the port's own codecs instead of OpenCV: each `*.png` is decoded by its
content as cv2.imread(IMREAD_UNCHANGED) decodes it, a file OpenCV reads no
image from is skipped, and the outputs are written as PNG).

Generic replacements for the reference's one-off munging scripts
(`process_maskimage.py`, `process_filelist.py`, `process_heic_images.py`,
`main_test.py` data checks — all hard-coded author paths):

  * `check`      — verify every image has a cam-dict entry and vice versa;
  * `apply-alpha`— multiply RGBA alpha into RGB (BlendedMVS-style masks);
  * `make-masks` — extract alpha channels into a masks/ folder;
  * `normalize`  — normalize the camera dict into the unit sphere.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def cmd_check(args):
    from iron_tpu_torch.data.cameras import load_cam_dict
    cam = load_cam_dict(args.cam_dict)
    imgs = sorted(sum([glob.glob(os.path.join(args.image_dir, f"*.{e}"))
                       for e in ("png", "jpg", "jpeg", "exr")], []))
    img_names = {os.path.basename(p) for p in imgs}
    missing_cam = sorted(img_names - set(cam.keys()))
    missing_img = sorted(set(cam.keys()) - img_names)
    print(f"{len(imgs)} images, {len(cam)} cam entries")
    if missing_cam:
        print("images without cameras:", missing_cam[:20])
    if missing_img:
        print("cameras without images:", missing_img[:20])
    if not missing_cam and not missing_img:
        print("OK: dataset is consistent")


def _read_unchanged(path: str):
    """cv2.imread(path, IMREAD_UNCHANGED) in the port: the array with its
    channels in RGB(A) order, or None where OpenCV gives no image.  A file
    OpenCV reads and the port does not (AVIF) raises."""
    from iron_tpu_torch.data.io import NoImage, decode_image
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data, path)
    except NoImage:
        return None


def cmd_apply_alpha(args):
    from iron_tpu_torch.data.io import write_png
    for p in sorted(glob.glob(os.path.join(args.image_dir, "*.png"))):
        img = _read_unchanged(p)
        if img is None or img.ndim != 3 or img.shape[2] != 4:
            continue
        a = img[:, :, 3:4].astype(np.float32) / 255.0
        rgb = (img[:, :, :3].astype(np.float32) * a).astype(img.dtype)
        write_png(p, rgb)
        print("alpha-multiplied", p)


def cmd_make_masks(args):
    from iron_tpu_torch.data.io import write_png
    out_dir = args.out_dir or os.path.join(os.path.dirname(args.image_dir), "masks")
    os.makedirs(out_dir, exist_ok=True)
    for p in sorted(glob.glob(os.path.join(args.image_dir, "*.png"))):
        img = _read_unchanged(p)
        if img is None:
            continue
        if img.ndim == 3 and img.shape[2] == 4:          # the alpha channel
            mask = img[:, :, 3]
        else:
            mask = ((img.sum(axis=-1) if img.ndim == 3 else img) > 0).astype(np.uint8) * 255
        write_png(os.path.join(out_dir, os.path.basename(p)), mask)
    print("masks written to", out_dir)


def cmd_normalize(args):
    from iron_tpu_torch.data.cameras import normalize_cam_dict
    normalize_cam_dict(args.cam_dict, args.out or args.cam_dict.replace(
        ".json", "_norm.json"), target_radius=args.target_radius)
    print("normalized cam dict written")


def main(argv=None):
    p = argparse.ArgumentParser(description="Dataset checks and preprocessing.")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check")
    c.add_argument("--image_dir", required=True)
    c.add_argument("--cam_dict", required=True)
    a = sub.add_parser("apply-alpha")
    a.add_argument("--image_dir", required=True)
    m = sub.add_parser("make-masks")
    m.add_argument("--image_dir", required=True)
    m.add_argument("--out_dir", default=None)
    n = sub.add_parser("normalize")
    n.add_argument("--cam_dict", required=True)
    n.add_argument("--out", default=None)
    n.add_argument("--target_radius", type=float, default=1.0)
    args = p.parse_args(argv)
    {"check": cmd_check, "apply-alpha": cmd_apply_alpha,
     "make-masks": cmd_make_masks, "normalize": cmd_normalize}[args.cmd](args)


if __name__ == "__main__":
    main()
