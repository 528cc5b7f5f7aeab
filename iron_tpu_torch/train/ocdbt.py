"""A read-only OCDBT key-value store and zarr v2 arrays on it, on numpy:
what the JAX package's orbax saves hold (tensorstore's "ocdbt" driver under
its "zarr" driver), read without tensorstore.

    store = OcdbtStore(directory)
    store.list() -> [key, ...]          # sorted bytes keys
    store.read(key) -> bytes
    read_zarr(store, "params.sdf.layers.0.v") -> np.ndarray

The layout, as tensorstore writes it:

  * every manifest and b-tree node is a file or a range of a file: a
    4-byte magic (0x0cdb3a2a manifest, 0x0cdb20de node, big-endian), the
    length of the whole (u64 LE), a format version and a compression
    (varints; 1 = one zstd frame), the body, and the CRC-32C of all before
    it (u32 LE);
  * the manifest (`manifest.ocdbt`; with the numbered kind it holds only
    the config and the versions are in `manifest.<16 digits>`, the highest
    the newest) holds the config (uuid, kind, inline threshold, node size,
    version-tree arity, compression and an int32 zstd level), a data-file
    table, the inline versions (columns: generation, root height, root
    file, offset, length, three statistics, commit time) and the
    version-tree nodes, which only older versions need;
  * a node holds its height, a data-file table, and its entries in
    columns: keys prefix-compressed against the previous key; an interior
    node then gives each child's common key prefix and its (file, offset,
    length) and statistics, a leaf each value's length and kind (inline, or
    indirect at a file and offset), then the inline bytes.  A node's keys
    continue the key prefix its parent gives it;
  * a data-file table lists paths prefix-compressed against the previous
    one, relative to the store's directory (`d/...`, and
    `ocdbt.process_N/d/...` where orbax merged per-process stores).

Zarr v2: `<path>/.zarray` (C order, little- or big-endian numeric dtypes,
the zstd or no compressor, no filters) and its chunks `<path>/<i>.<j>...`
(or `/`-separated); a missing chunk reads as `fill_value`.  Anything else
raises, naming it.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from iron_tpu_torch.train.zstd import decompress

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1


class OcdbtError(ValueError):
    """A store this reader cannot read: corrupt, or a layout it refuses."""


def _crc32c_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(0x82F63B78), table >> 1)
    return table.astype(np.uint32)


_CRC_TABLE = _crc32c_table().tolist()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT's footers hold it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                raise OcdbtError("a truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        return self.take(1)[0]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError("a truncated field")
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _unwrap(data: bytes, magic: int, what: str) -> bytes:
    """A manifest or node's bytes -> its body, decompressed, after checking
    the magic, the length and the CRC-32C."""
    if len(data) < 18 or int.from_bytes(data[:4], "big") != magic:
        kind = "manifest" if magic == MANIFEST_MAGIC else "node"
        raise OcdbtError(f"{what}: not an OCDBT {kind}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OcdbtError(f"{what}: {len(data)} bytes where the header says {length}")
    if crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(data[:-4])
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = data[r.pos:-4]
    if compression == 1:
        return decompress(body)
    if compression != 0:
        raise OcdbtError(f"{what}: compression format {compression}")
    return body


def _keys(r: _Reader, n: int) -> Tuple[List[int], List[int]]:
    """n prefix-compressed keys' lengths: the prefix each shares with the
    one before it (none for the first) and its suffix's."""
    prefix = [0] + r.varints(n - 1) if n else []
    return prefix, r.varints(n)


def _expand(r: _Reader, prefix, suffix) -> List[bytes]:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys


def _file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix, suffix = _keys(r, n)
    r.varints(n)                        # each path's base-path length: the path is whole
    return [p.decode() for p in _expand(r, prefix, suffix)]


def _config(r: _Reader) -> int:
    """Skip a manifest's config; return its manifest kind (0 single, 1
    numbered)."""
    r.take(16)                          # uuid
    kind = r.varint()
    r.varint()                          # max inline value bytes
    r.varint()                          # max decoded node bytes
    r.byte()                            # version tree arity (log2)
    if r.varint() == 1:
        r.take(4)                       # zstd level, int32
    return kind


class OcdbtStore:
    """The newest version of the OCDBT store in `directory`, read-only."""

    def __init__(self, directory: str):
        self.directory = directory
        self._files: Dict[str, bytes] = {}
        self._values: Optional[Dict[bytes, tuple]] = None
        r = _Reader(self._manifest(os.path.join(directory, "manifest.ocdbt")))
        kind = _config(r)
        if kind == 1:                   # numbered manifests: the highest is the newest
            numbered = sorted(p for p in os.listdir(directory)
                              if p.startswith("manifest.") and p[9:].isdigit())
            if not numbered:
                raise OcdbtError(f"{directory}: a numbered manifest kind without manifests")
            r = _Reader(self._manifest(os.path.join(directory, numbered[-1])))
            _config(r)
        elif kind != 0:
            raise OcdbtError(f"{directory}: manifest kind {kind}")
        files = _file_table(r)
        n = r.varint()
        gen = r.varints(n)
        height = [r.byte() for _ in range(n)]
        ref = list(zip(r.varints(n), r.varints(n), r.varints(n)))
        if not n:
            self.root = None
            return
        newest = int(np.argmax(gen))
        file_id, offset, length = ref[newest]
        self.root = None if offset == _NO_ROOT else (height[newest], files[file_id], offset,
                                                     length)

    def _manifest(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return _unwrap(f.read(), MANIFEST_MAGIC, path)

    def _bytes(self, path: str, offset: int, length: int) -> bytes:
        full = os.path.join(self.directory, path)
        if full not in self._files:
            with open(full, "rb") as f:
                self._files[full] = f.read()
        data = self._files[full]
        if offset + length > len(data):
            raise OcdbtError(f"{full}: a reference past the file's end")
        return data[offset:offset + length]

    def _walk(self, height: int, path: str, offset: int, length: int, prefix: bytes,
              out: Dict[bytes, tuple]) -> None:
        where = f"{path}@{offset}"
        r = _Reader(_unwrap(self._bytes(path, offset, length), NODE_MAGIC, where))
        if r.byte() != height:
            raise OcdbtError(f"{where}: a node of another height than its parent says")
        files = _file_table(r)
        n = r.varint()
        kp, ks = _keys(r, n)
        if height > 0:
            common = r.varints(n)
            keys = _expand(r, kp, ks)
            ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            for key, c, i, o, ln in zip(keys, common, ids, offs, lens):
                self._walk(height - 1, files[i], o, ln, prefix + key[:c], out)
            return
        keys = _expand(r, kp, ks)
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"{where}: a value kind other than inline or indirect")
        m = sum(kinds)
        ids, offs = r.varints(m), r.varints(m)
        indirect = iter(zip(ids, offs))
        for key, ln, kind in zip(keys, lengths, kinds):
            if kind:
                i, o = next(indirect)
                out[prefix + key] = (files[i], o, ln)
            else:
                out[prefix + key] = r.take(ln)

    def _index(self) -> Dict[bytes, tuple]:
        if self._values is None:
            self._values = {}
            if self.root is not None:
                self._walk(*self.root, b"", self._values)
        return self._values

    def list(self) -> List[bytes]:
        return sorted(self._index())

    def read(self, key) -> Optional[bytes]:
        """The value at `key` (str or bytes), or None where there is none."""
        if isinstance(key, str):
            key = key.encode()
        v = self._index().get(key)
        if v is None or isinstance(v, bytes):
            return v
        return self._bytes(*v)


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------

_FILL = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}


def read_zarr(store: OcdbtStore, path: str) -> np.ndarray:
    """The zarr v2 array at `path` in `store`."""
    raw = store.read(f"{path}/.zarray")
    if raw is None:
        raise OcdbtError(f"{store.directory}: no zarr array '{path}'")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OcdbtError(f"{path}: zarr format {meta.get('zarr_format')}, not 2")
    if meta.get("order", "C") != "C":
        raise OcdbtError(f"{path}: zarr order {meta.get('order')}; the reader takes C")
    if meta.get("filters"):
        raise OcdbtError(f"{path}: zarr filters {meta['filters']}; the reader takes none")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OcdbtError(f"{path}: zarr compressor {comp.get('id')}; the reader takes zstd "
                         f"or none")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as e:
        raise OcdbtError(f"{path}: zarr dtype {meta['dtype']!r}") from e
    if dtype.kind not in "biuf" or dtype.fields is not None:
        raise OcdbtError(f"{path}: zarr dtype {meta['dtype']!r}; the reader takes numbers")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    fill = 0 if fill is None else _FILL.get(fill, fill)
    out = np.full(shape, fill, dtype.newbyteorder("="))
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        name = sep.join(str(i) for i in idx) if shape else "0"
        data = store.read(f"{path}/{name}")
        if data is None:
            continue
        if comp is not None:
            data = decompress(data)
        chunk = np.frombuffer(data, dtype)
        if chunk.size != int(np.prod(chunks)):
            raise OcdbtError(f"{path}/{name}: {chunk.size} values where a chunk holds "
                             f"{int(np.prod(chunks))}")
        chunk = chunk.reshape(chunks)
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sel] = chunk[tuple(slice(0, s.stop - s.start) for s in sel)]
    return out
