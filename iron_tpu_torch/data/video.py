"""Motion-JPEG video without OpenCV (the JAX package writes its videos
through cv2.VideoWriter).  Each frame is a baseline JPEG of the port's own
encoder (`jpeg.py`, quality 95); the container follows the file's
extension, as cv2 picks it:

  * `.avi`: RIFF AVI, one `vids` stream with the `MJPG` handler, one `00dc`
    chunk a frame and an `idx1` index (every frame a key frame);
  * `.mp4` / `.mov`: ISO base media (ftyp, mdat, moov), one video track
    whose sample entry is `jpeg`, every frame one sample of one chunk.

`avi_frames` reads the JPEG frames of an AVI back.
"""
from __future__ import annotations

import os
import struct
from typing import List, Sequence

import numpy as np

from iron_tpu_torch.data.jpeg import encode_jpeg

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return fourcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def _avi(jpegs: List[bytes], w: int, h: int, fps: float) -> bytes:
    n, biggest = len(jpegs), max(len(j) for j in jpegs)
    avih = struct.pack("<10I4I", int(round(1e6 / fps)), int(biggest * fps), 0, _AVIF_HASINDEX,
                       n, 0, 1, biggest, w, h, 0, 0, 0, 0)
    # dwScale / dwRate = seconds a frame
    scale, rate = (1, int(fps)) if float(fps).is_integer() else (1000, int(round(fps * 1000)))
    strh = (b"vids" + b"MJPG" + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, scale, rate, 0, n,
                                            biggest, -1, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    frames, index, offset = [], [], 4      # offsets from the 'movi' fourcc
    for j in jpegs:
        c = _chunk(b"00dc", j)
        index.append(b"00dc" + struct.pack("<III", _AVIIF_KEYFRAME, offset, len(j)))
        frames.append(c)
        offset += len(c)
    body = b"AVI " + hdrl + _list(b"movi", b"".join(frames)) + _chunk(b"idx1", b"".join(index))
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags) + body)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _mp4(jpegs: List[bytes], w: int, h: int, fps: float) -> bytes:
    n = len(jpegs)
    timescale, delta = int(round(fps * 1000)), 1000       # a sample lasts `delta` units
    media_duration = n * delta
    movie_duration = int(round(n * 1000 / fps))            # the movie's timescale is 1000
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    data = b"".join(jpegs)
    if len(ftyp) + 8 + len(data) >= 2 ** 32:
        raise ValueError("the MP4 writer takes videos under 4 GiB (32-bit chunk offsets)")
    mdat = _box(b"mdat", data)
    first = len(ftyp) + 8                                  # the first frame's file offset
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, 1000, movie_duration,
                                                0x10000, 0x100) + bytes(10) + _MATRIX
                     + bytes(24) + struct.pack(">I", 2))
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie_duration)
                     + bytes(8) + struct.pack(">hhhH", 0, 0, 0, 0) + _MATRIX
                     + struct.pack(">II", w << 16, h << 16))
    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, media_duration,
                                                0x55C4, 0))              # language 'und'
    hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I", 0) + b"vide" + bytes(12)
                     + b"VideoHandler\0")
    vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
    dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1)
                                   + _full_box(b"url ", 0, 1, b"")))
    name = b"Photo - JPEG"
    entry = _box(b"jpeg", bytes(6) + struct.pack(">H", 1) + bytes(16)
                 + struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1)
                 + bytes([len(name)]) + name + bytes(31 - len(name))
                 + struct.pack(">Hh", 0x18, -1))
    stbl = _box(b"stbl",
                _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + entry)
                + _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
                + _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
                + _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n)
                            + struct.pack(f">{n}I", *(len(j) for j in jpegs)))
                + _full_box(b"stco", 0, 0, struct.pack(">II", 1, first)))
    minf = _box(b"minf", vmhd + dinf + stbl)
    trak = _box(b"trak", tkhd + _box(b"mdia", mdhd + hdlr + minf))
    return ftyp + mdat + _box(b"moov", mvhd + trak)


def write_mjpeg_video(path: str, frames: Sequence[np.ndarray], fps: float = 30,
                      quality: int = 95) -> None:
    """Write RGB uint8 frames [H, W, 3], all of one size, as Motion-JPEG:
    AVI for `.avi`, ISO base media for `.mp4` and `.mov`; any other
    extension raises."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".avi", ".mp4", ".mov"):
        raise ValueError(f"{path}: the video writer takes .avi (RIFF AVI, MJPG) or .mp4 / .mov "
                         f"(ISO base media, jpeg samples)")
    if not frames:
        raise ValueError("write_mjpeg_video takes at least one frame")
    h, w = np.asarray(frames[0]).shape[:2]
    if any(np.asarray(f).shape[:2] != (h, w) for f in frames):
        raise ValueError("every frame of a video must have the first frame's size")
    if fps <= 0:
        raise ValueError(f"fps must be positive, got {fps}")
    jpegs = [encode_jpeg(np.asarray(f), quality) for f in frames]
    data = _avi(jpegs, w, h, fps) if ext == ".avi" else _mp4(jpegs, w, h, fps)
    with open(path, "wb") as f:
        f.write(data)


def avi_frames(path: str) -> List[bytes]:
    """The `00dc` chunks (JPEG frames) of the `movi` list of an AVI, in
    order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")

    def walk(lo: int, hi: int, in_movi: bool, out: List[bytes]) -> None:
        while lo + 8 <= hi:
            fourcc, size = data[lo:lo + 4], struct.unpack("<I", data[lo + 4:lo + 8])[0]
            if fourcc == b"LIST":
                walk(lo + 12, lo + 8 + size, data[lo + 8:lo + 12] == b"movi", out)
            elif in_movi and fourcc == b"00dc":
                out.append(data[lo + 8:lo + 8 + size])
            lo += 8 + size + (size & 1)

    frames: List[bytes] = []
    walk(12, len(data), False, frames)
    return frames
