"""The port's Zstandard decoder (iron_tpu_torch/train/zstd.py) against the
zstandard package's encoder, bit for bit: levels 1, 3, 19 and a negative
one; zero, text, random and float32 content (float32 at N(0, 0.05), as the
JAX package's checkpoints hold); sizes 0, 1, around one block (128 KiB) and
a few MiB; with and without the content checksum and the content size;
streamed frames without a content size; several frames and a skippable
frame; a dictionary ID and a corrupt checksum refused."""
import os

import numpy as np
import pytest
import zstandard

from iron_tpu_torch.train import zstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 128 << 10


def _content(kind: str, size: int) -> bytes:
    rng = np.random.default_rng(size + len(kind))
    if kind == "zero":
        return bytes(size)
    if kind == "text":
        with open(os.path.join(REPO, "README.md"), "rb") as f:
            text = f.read()
        return (text * (size // len(text) + 1))[:size]
    if kind == "random":
        return rng.bytes(size)
    if kind == "small_alphabet":               # Huffman literals with short codes, long matches
        return rng.integers(0, 5, size, dtype=np.uint8).tobytes()
    return rng.normal(0, 0.05, (size + 3) // 4).astype(np.float32).tobytes()[:size]


def _check(data: bytes, frame: bytes) -> None:
    got = zstd.decompress(frame)
    assert got == data == zstandard.ZstdDecompressor().decompressobj().decompress(frame)


@pytest.mark.parametrize("level", [1, 3, 19, -5])
@pytest.mark.parametrize("kind", ["zero", "text", "random", "float32", "small_alphabet"])
def test_levels_and_content(level, kind):
    data = _content(kind, 200_000)
    _check(data, zstandard.ZstdCompressor(level=level).compress(data))


@pytest.mark.parametrize("size", [0, 1, BLOCK - 1, BLOCK, BLOCK + 1, 3 << 20])
@pytest.mark.parametrize("kind", ["text", "float32"])
def test_sizes(size, kind):
    data = _content(kind, size)
    _check(data, zstandard.ZstdCompressor(level=3).compress(data))


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
@pytest.mark.parametrize("level", [1, 19])
def test_checksum_and_content_size_flags(checksum, content_size, level):
    data = _content("text", 300_001) + _content("float32", 100_000)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=content_size).compress(data)
    _check(data, frame)


def test_streamed_frame_without_content_size():
    """A frame written by the streaming API: windowed (not single-segment),
    no content size, the checksum on."""
    data = _content("float32", 700_000)
    cobj = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    frame = b"".join(cobj.compress(data[i:i + 65536]) for i in range(0, len(data), 65536))
    frame += cobj.flush()
    _check(data, frame)


def test_several_frames_and_a_skippable_frame():
    parts = [_content("text", 5000), _content("float32", 150_000), b"", _content("zero", 9)]
    frames = [zstandard.ZstdCompressor(level=i + 1, write_checksum=bool(i % 2)).compress(p)
              for i, p in enumerate(parts)]
    skippable = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"ignored"
    stream = frames[0] + skippable + frames[1] + frames[2] + frames[3]
    assert zstd.decompress(stream) == b"".join(parts)


def test_dictionary_and_corrupt_checksum_refused():
    samples = [_content("text", 2000)[i:] for i in range(0, 1500, 50)]
    d = zstandard.train_dictionary(1024, samples * 4)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(_content("text", 4000))
    with pytest.raises(zstd.ZstdError, match=f"dictionary {d.dict_id()}"):
        zstd.decompress(frame)
    frame = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(b"x" * 100 + b"y"))
    frame[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))


def test_xxh64_against_the_reference_vectors():
    """xxHash64 of the empty input and of short inputs (seed 0), whose low
    32 bits are zstd's content checksum, against zstandard's frames."""
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    for n in (1, 4, 7, 8, 31, 32, 33, 100):
        data = _content("random", n)
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")
