"""MPEG-4 Part 2 video without OpenCV: the codec the JAX package's
cv2.VideoWriter(..., fourcc "mp4v") writes (FFmpeg's `mpeg4`), in the
container the file's extension names, as cv2 picks it:

  * `.avi`: RIFF AVI, one `vids` stream with the `mp4v` handler (the tag
    OpenCV's own mp4v AVI carries), one `00dc` chunk a frame, each frame
    starting with the VOS, VO and VOL headers, and an `idx1` index;
  * `.mp4` / `.mov`: ISO base media (ftyp `isom` / `qt  `, mdat, moov), one
    video track whose `mp4v` sample entry holds an `esds` with the headers
    as its DecoderSpecificInfo; every frame one sample of one chunk.

The stream (ISO/IEC 14496-2, Simple Profile): a rectangular video object
layer of 8-bit samples with H.263 quantisation, then one I-VOP a frame at a
fixed quantiser `QP`.  A frame is converted to BT.601 limited-range Y'CbCr
(chroma the mean of each 2 x 2 block), padded to whole macroblocks by
repeating its last row and column, cut into 8 x 8 blocks and transformed by
the orthonormal DCT.  Each block's DC is quantised by the dc_scaler of
`QP`, predicted from its left or upper neighbour (7.4.3.1's gradient rule,
1024 outside the VOP) and coded with the dct_dc_size VLC; the AC
coefficients (zigzag scan, no AC prediction) are quantised by 2 QP toward
zero and each coded as a fixed-length escape (type 3: last, run, 12-bit
level), which needs no TCOEF table at a cost in size.

`encode_mpeg4` also returns the encoder's own reconstruction of each frame
(the dequantised blocks through the float IDCT, rounded and clipped), which
an H.263-quantised MPEG-4 decoder gives up to its IDCT's rounding.
"""
from __future__ import annotations

import os
import struct
from typing import List, Sequence, Tuple

import numpy as np

from iron_tpu_torch.data.jpeg import ZIGZAG

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
QP = 2          # the quantiser of every frame: a mean error near OpenCV's mp4v, or below
DC_SCALER = 8   # the dc_scaler of quantisers 1-4, luma and chroma (Table 7-1)

# dct_dc_size_luminance / _chrominance (Tables B-13, B-14): (code, length) by size
_DC_LUM = ((3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8),
           (1, 9), (1, 10), (1, 11))
_DC_CHROM = ((3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9),
             (1, 10), (1, 11), (1, 12))
# mcbpc of an intra macroblock in an I-VOP by cbpc (Table B-6), cbpy by the
# four luma bits, block 0 the highest (Table B-8)
_MCBPC_I = ((1, 1), (1, 3), (2, 3), (3, 3))
_CBPY = ((3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4), (2, 5), (3, 6), (5, 4),
         (10, 4), (4, 4), (8, 4), (6, 4), (3, 2))
_DCT = np.array([[np.sqrt((1 if k == 0 else 2) / 8) * np.cos((2 * n + 1) * k * np.pi / 16)
                  for n in range(8)] for k in range(8)])


class _Bits:
    """A bit string, most significant bit first."""

    def __init__(self):
        self.parts: List[str] = []
        self.n = 0

    def put(self, value: int, n: int) -> None:
        self.parts.append(format(value, f"0{n}b"))
        self.n += n

    def stuff(self) -> None:
        """next_start_code(): a 0, then 1s to the byte boundary."""
        self.put(0, 1)
        if self.n % 8:
            self.put((1 << (8 - self.n % 8)) - 1, 8 - self.n % 8)

    def tobytes(self) -> bytes:
        assert self.n % 8 == 0
        return int("".join(self.parts), 2).to_bytes(self.n // 8, "big") if self.n else b""


def _time_base(fps: float) -> Tuple[int, int]:
    """vop_time_increment_resolution and the fixed increment of a frame."""
    if float(fps).is_integer() and 0 < fps < 65536:
        return int(fps), 1
    res = int(round(fps * 1000))
    if not 0 < res < 65536:
        raise ValueError(f"fps {fps}: the MPEG-4 writer takes up to 65535 frames a second, or "
                         f"up to 65.535 with a fraction")
    return res, 1000


def _headers(w: int, h: int, fps: float) -> bytes:
    """The visual object sequence, visual object and video object layer
    headers (6.2.2-6.2.3) of a Simple Profile stream."""
    mbs = -(-w // 16) * -(-h // 16)
    level = next((lv for lv, most in ((1, 99), (3, 396), (4, 1200), (5, 1620)) if mbs <= most),
                 6)
    res, inc = _time_base(fps)
    b = _Bits()
    b.put(0x1B0, 32)
    b.put(level, 8)                     # profile_and_level_indication: Simple Profile
    b.put(0x1B5, 32)
    b.put(0, 1)                         # is_visual_object_identifier
    b.put(1, 4)                         # visual_object_type: video
    b.put(0, 1)                         # video_signal_type
    b.stuff()
    b.put(0x100, 32)                    # video_object_start_code
    b.put(0x120, 32)                    # video_object_layer_start_code
    b.put(0, 1)                         # random_accessible_vol
    b.put(1, 8)                         # video_object_type_indication: Simple Object
    b.put(0, 1)                         # is_object_layer_identifier
    b.put(1, 4)                         # aspect_ratio_info: square pixels
    b.put(0, 1)                         # vol_control_parameters
    b.put(0, 2)                         # video_object_layer_shape: rectangular
    b.put(1, 1)
    b.put(res, 16)                      # vop_time_increment_resolution
    b.put(1, 1)
    b.put(1, 1)                         # fixed_vop_rate
    b.put(inc, max(1, (res - 1).bit_length()))
    b.put(1, 1)
    b.put(w, 13)
    b.put(1, 1)
    b.put(h, 13)
    b.put(1, 1)
    b.put(0, 1)                         # interlaced
    b.put(1, 1)                         # obmc_disable
    b.put(0, 1)                         # sprite_enable
    b.put(0, 1)                         # not_8_bit
    b.put(0, 1)                         # quant_type: H.263
    b.put(1, 1)                         # complexity_estimation_disable
    b.put(1, 1)                         # resync_marker_disable
    b.put(0, 1)                         # data_partitioned
    b.put(0, 1)                         # scalability
    b.stuff()
    return b.tobytes()


def _to_ycbcr(rgb: np.ndarray, mb_w: int, mb_h: int):
    """RGB uint8 [H, W, 3] -> the Y, Cb, Cr planes (uint8) padded to whole
    macroblocks: BT.601 limited range, chroma from the mean of each 2 x 2
    RGB block."""
    h, w = rgb.shape[:2]
    pad = np.pad(rgb.astype(np.float64), ((0, 16 * mb_h - h), (0, 16 * mb_w - w), (0, 0)),
                 mode="edge")
    r, g, b = pad[..., 0], pad[..., 1], pad[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    sub = pad.reshape(8 * mb_h, 2, 8 * mb_w, 2, 3).mean(axis=(1, 3))
    r, g, b = sub[..., 0], sub[..., 1], sub[..., 2]
    cb = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    cr = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    return [np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in (y, cb, cr)]


def _to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, h: int, w: int) -> np.ndarray:
    """Y'CbCr planes (chroma at half size) -> RGB uint8 [h, w, 3], the chroma
    repeated over each 2 x 2 block (BT.601 limited range)."""
    cb = np.repeat(np.repeat(cb.astype(np.float64) - 128, 2, 0), 2, 1)[:h, :w]
    cr = np.repeat(np.repeat(cr.astype(np.float64) - 128, 2, 0), 2, 1)[:h, :w]
    yy = (y[:h, :w].astype(np.float64) - 16) * (255 / 219)
    rgb = np.stack([yy + 1.402 * (255 / 224) * cr,
                    yy - (255 / 224) * (0.344136 * cb + 0.714136 * cr),
                    yy + 1.772 * (255 / 224) * cb], -1)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[8 by, 8 bx] -> [by, bx, 8, 8]."""
    by, bx = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(by, 8, bx, 8).swapaxes(1, 2)


def _unblocks(blocks: np.ndarray) -> np.ndarray:
    by, bx = blocks.shape[:2]
    return blocks.swapaxes(1, 2).reshape(8 * by, 8 * bx)


def _dc_prediction(dc: np.ndarray) -> np.ndarray:
    """The quantised DC predictions of a grid of blocks from the
    reconstructed DC values `dc` (level x dc_scaler, clipped to [0, 2047]):
    with B the upper-left, C the upper and A the left neighbour (1024
    outside the VOP), C where |A - B| < |B - C|, else A, divided by the
    dc_scaler rounding half up (7.4.3.1)."""
    p = np.pad(dc, ((1, 0), (1, 0)), constant_values=1024)
    a, b, c = p[1:, :-1], p[:-1, :-1], p[:-1, 1:]
    pred = np.where(np.abs(a - b) < np.abs(b - c), c, a)
    return (pred + DC_SCALER // 2) // DC_SCALER


def _code_plane(blocks: np.ndarray):
    """Quantise a plane's [by, bx, 8, 8] DCT blocks -> (the DC levels'
    differentials from their predictions [by, bx], the AC levels in zigzag
    order [by, bx, 63], the dequantised blocks)."""
    dc_level = np.floor(blocks[..., 0, 0] / DC_SCALER + 0.5).astype(np.int64)
    dc_rec = np.clip(dc_level * DC_SCALER, 0, 2047)
    dc_diff = dc_level - _dc_prediction(dc_rec)
    zz = blocks.reshape(blocks.shape[:2] + (64,))[..., ZIGZAG[1:]]
    ac = (np.sign(zz) * np.minimum(np.abs(zz) // (2 * QP), 2047)).astype(np.int64)
    mag = np.abs(ac) * (2 * QP) + QP - (1 - QP % 2)
    ac_rec = np.where(ac == 0, 0, np.sign(ac) * mag)
    rec = np.zeros(blocks.shape[:2] + (64,))
    rec[..., ZIGZAG[1:]] = np.clip(ac_rec, -2048, 2047)
    rec[..., 0] = dc_rec
    return dc_diff, ac, rec.reshape(blocks.shape)


def _put_dc(b: _Bits, diff: int, table) -> None:
    size = abs(diff).bit_length()
    code, n = table[size]
    b.put(code, n)
    if size:
        b.put(diff if diff > 0 else diff + (1 << size) - 1, size)
        if size > 8:
            b.put(1, 1)                 # marker_bit


def _put_ac(b: _Bits, levels: np.ndarray) -> None:
    """The AC levels of a block, each a type-3 escape: 0000011 11, last,
    run (6), marker, level (12), marker."""
    nz = np.flatnonzero(levels)
    prev = -1
    for k, i in enumerate(nz.tolist()):
        last = int(k == len(nz) - 1)
        b.put((0x3 << 23) | (0x3 << 21) | (last << 20) | ((i - prev - 1) << 14) | (1 << 13)
              | ((int(levels[i]) & 0xFFF) << 1) | 1, 30)
        prev = i


def encode_mpeg4(frames: Sequence[np.ndarray], fps: float = 30):
    """RGB uint8 frames [H, W, 3], all of one size -> (the VOS / VO / VOL
    headers, one I-VOP a frame, the encoder's reconstruction of each frame
    as RGB uint8 [H, W, 3] and as its Y'CbCr planes)."""
    h, w = np.asarray(frames[0]).shape[:2]
    if w >= 1 << 13 or h >= 1 << 13:
        raise ValueError(f"a {w} x {h} frame is past the 13-bit VOL size")
    mb_w, mb_h = -(-w // 16), -(-h // 16)
    res, inc = _time_base(fps)
    tbits = max(1, (res - 1).bit_length())
    vops, recs = [], []
    for k, frame in enumerate(frames):
        planes = _to_ycbcr(np.asarray(frame)[..., :3], mb_w, mb_h)
        coded, planes_rec = [], []
        for plane in planes:
            blk = _DCT @ _blocks(plane.astype(np.float64)) @ _DCT.T
            dc_diff, ac, deq = _code_plane(blk)
            coded.append((dc_diff, ac))
            pix = _DCT.T @ deq @ _DCT
            planes_rec.append(_unblocks(np.clip(np.rint(pix), 0, 255).astype(np.uint8)))
        b = _Bits()
        b.put(0x1B6, 32)
        b.put(0, 2)                     # vop_coding_type: I
        t = k * inc
        ones = t // res - (t - inc) // res if k else 0
        b.put((1 << (ones + 1)) - 2, ones + 1)   # modulo_time_base: a 1 a second begun, a 0
        b.put(1, 1)
        b.put(t % res, tbits)           # vop_time_increment
        b.put(1, 1)
        b.put(1, 1)                     # vop_coded
        b.put(0, 3)                     # intra_dc_vlc_thr: the DC VLC at every quantiser
        b.put(QP, 5)                    # vop_quant
        (ydc, yac), (bdc, bac), (rdc, rac) = coded
        yany, bany, rany = yac.any(-1), bac.any(-1), rac.any(-1)
        for my in range(mb_h):
            for mx in range(mb_w):
                lum = [(2 * my + j, 2 * mx + i) for j in (0, 1) for i in (0, 1)]
                cbpy = sum(int(yany[q]) << (3 - n) for n, q in enumerate(lum))
                code, n = _MCBPC_I[int(bany[my, mx]) << 1 | int(rany[my, mx])]
                b.put(code, n)
                b.put(0, 1)             # ac_pred_flag
                b.put(*_CBPY[cbpy])
                for q in lum:
                    _put_dc(b, int(ydc[q]), _DC_LUM)
                    if yany[q]:
                        _put_ac(b, yac[q])
                for dc, ac, anyac in ((bdc, bac, bany), (rdc, rac, rany)):
                    _put_dc(b, int(dc[my, mx]), _DC_CHROM)
                    if anyac[my, mx]:
                        _put_ac(b, ac[my, mx])
        b.stuff()
        vops.append(b.tobytes())
        recs.append((_to_rgb(*planes_rec, h, w), planes_rec))
    return _headers(w, h, fps), vops, recs


# ---------------------------------------------------------------------------
# the containers
# ---------------------------------------------------------------------------

def _chunk(fourcc: bytes, body: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return fourcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def _avi(samples: List[bytes], w: int, h: int, fps: float) -> bytes:
    n, biggest = len(samples), max(len(s) for s in samples)
    avih = struct.pack("<10I4I", int(round(1e6 / fps)), int(biggest * fps), 0, _AVIF_HASINDEX,
                       n, 0, 1, biggest, w, h, 0, 0, 0, 0)
    # dwScale / dwRate = seconds a frame
    scale, rate = (1, int(fps)) if float(fps).is_integer() else (1000, int(round(fps * 1000)))
    strh = (b"vids" + b"mp4v" + struct.pack("<IHHIIIIIIiI", 0, 0, 0, 0, scale, rate, 0, n,
                                            biggest, -1, 0)
            + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"mp4v", w * h * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    frames, index, offset = [], [], 4      # offsets from the 'movi' fourcc
    for s in samples:
        c = _chunk(b"00dc", s)
        index.append(b"00dc" + struct.pack("<III", _AVIIF_KEYFRAME, offset, len(s)))
        frames.append(c)
        offset += len(c)
    body = b"AVI " + hdrl + _list(b"movi", b"".join(frames)) + _chunk(b"idx1", b"".join(index))
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags) + body)


def _descriptor(tag: int, body: bytes) -> bytes:
    """An MPEG-4 systems descriptor with a four-byte size, as FFmpeg writes
    them."""
    n = len(body)
    return bytes([tag, 0x80 | n >> 21 & 0x7F, 0x80 | n >> 14 & 0x7F, 0x80 | n >> 7 & 0x7F,
                  n & 0x7F]) + body


def _esds(headers: bytes, samples: List[bytes], fps: float) -> bytes:
    """The ES descriptor of an MPEG-4 Visual track (ISO/IEC 14496-1 and -14):
    object type 0x20, a visual stream, the headers as DecoderSpecificInfo."""
    biggest = max(len(s) for s in samples)
    rate = int(sum(len(s) for s in samples) * 8 * fps / len(samples))
    config = _descriptor(4, struct.pack(">BB", 0x20, 0x11) + biggest.to_bytes(3, "big")
                         + struct.pack(">II", rate, rate) + _descriptor(5, headers))
    es = _descriptor(3, struct.pack(">HB", 1, 0) + config + _descriptor(6, b"\x02"))
    return _full_box(b"esds", 0, 0, es)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _mp4(samples: List[bytes], headers: bytes, w: int, h: int, fps: float,
         quicktime: bool) -> bytes:
    n = len(samples)
    timescale, delta = int(round(fps * 1000)), 1000       # a sample lasts `delta` units
    media_duration = n * delta
    movie_duration = int(round(n * 1000 / fps))            # the movie's timescale is 1000
    ftyp = _box(b"ftyp", b"qt  " + struct.pack(">I", 0x200) + b"qt  " if quicktime
                else b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    data = b"".join(samples)
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
    entry = _box(b"mp4v", bytes(6) + struct.pack(">H", 1) + bytes(16)
                 + struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1) + bytes(32)
                 + struct.pack(">Hh", 0x18, -1) + _esds(headers, samples, fps))
    stbl = _box(b"stbl",
                _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + entry)
                + _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
                + _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
                + _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n)
                            + struct.pack(f">{n}I", *(len(s) for s in samples)))
                + _full_box(b"stco", 0, 0, struct.pack(">II", 1, first)))
    minf = _box(b"minf", vmhd + dinf + stbl)
    trak = _box(b"trak", tkhd + _box(b"mdia", mdhd + hdlr + minf))
    return ftyp + mdat + _box(b"moov", mvhd + trak)


def write_mpeg4_video(path: str, frames: Sequence[np.ndarray], fps: float = 30) -> list:
    """Write RGB uint8 frames [H, W, 3], all of one size, as MPEG-4 Part 2
    (`mp4v`): AVI for `.avi`, ISO base media for `.mp4` and `.mov`; any
    other extension raises, before any file is made.  Returns the encoder's
    reconstruction of each frame (RGB uint8, and its Y'CbCr planes)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".avi", ".mp4", ".mov"):
        raise ValueError(f"{path}: the video writer takes .avi (RIFF AVI) or .mp4 / .mov "
                         f"(ISO base media), each with an mp4v stream")
    if not frames:
        raise ValueError("write_mpeg4_video takes at least one frame")
    h, w = np.asarray(frames[0]).shape[:2]
    if any(np.asarray(f).shape[:2] != (h, w) for f in frames):
        raise ValueError("every frame of a video must have the first frame's size")
    if fps <= 0:
        raise ValueError(f"fps must be positive, got {fps}")
    headers, vops, recs = encode_mpeg4(frames, fps)
    if ext == ".avi":
        data = _avi([headers + v for v in vops], w, h, fps)
    else:
        data = _mp4(vops, headers, w, h, fps, ext == ".mov")
    with open(path, "wb") as f:
        f.write(data)
    return recs
