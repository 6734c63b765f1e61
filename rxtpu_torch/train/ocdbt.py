"""Read an OCDBT key-value store: what orbax checkpoints keep their arrays in.

rxtpu's orbax backend (``rxtpu/train/checkpoint.py:152-199``, orbax's
``StandardCheckpointer``) writes its zarr arrays through tensorstore's
``ocdbt`` kvstore: a B+tree of keys whose values are inline in the tree's
leaves or stored in data files. ``read_ocdbt(directory)`` returns the map of
key -> value bytes of the newest version, which is what tensorstore's
``ocdbt`` kvstore lists and reads for that directory, with neither
tensorstore nor orbax installed. The layout is tensorstore's published
"OCDBT storage format":

- every manifest and node file is ``magic (u32 BE) | length (u64 LE, the
  whole file) | version (varint, 0) | compression (varint: 0 none, 1
  zstd) | body | CRC-32C (u32 LE) of all that precedes it``. The manifest's
  magic is ``0c db 3a 2a``, a B+tree node's ``0c db 20 de``. A zstd body
  is one frame: a small one carries its content size, a larger one does
  not, and the store's max decoded node bytes bounds it;
- the manifest body: ``config`` (uuid[16], manifest kind, max inline value
  bytes, max decoded node bytes, version tree arity log2 (u8), compression
  method, and for zstd its level as i32 LE), a data file table, then the
  newest versions inline, column by column: generation numbers, root
  heights, the roots' (file, offset, length), their statistics (keys, tree
  bytes, indirect value bytes) and commit times (u64 LE). Older versions sit
  in version tree nodes, which the newest root does not need;
- a data file table: the count, the length of the prefix each path shares
  with the one before it (from the second path on), each path's suffix
  length and its base path length, then the suffixes. A file lies at its
  path under the directory; a pod's save leaves its processes' files under
  ``ocdbt.process_<i>/``, and the root's tables name them so;
- a B+tree node body: its height (u8), its data file table, the entry count,
  the keys prefix-compressed as the paths are (interior entries also give
  the length of the prefix that every key of their subtree shares, which the
  child's keys leave out), then for a leaf each value's length and kind (0
  inline, 1 in a data file, with its file and offset), and the inline values
  last; for an interior node each child's (file, offset, length) and its
  statistics.

zstd goes through the port's host codec library (``libzstd.so.1`` bound by
``dlopen``, ``rxtpu_torch.data.decode``); CRC-32C is table-driven here. What
this reader does not cover (numbered manifests, another format version or
compression, a value kind it does not know) raises ``OcdbtError`` naming it,
and so does a checksum or a length that does not match.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
_MISSING = (1 << 64) - 1  # the offset and length of an empty tree's root
_ZSTD_MAGIC = 0xFD2FB528
_MANIFEST_LIMIT = 1 << 26  # a manifest's decoded bytes, at most (it lists files and versions)


class OcdbtError(ValueError):
    """An OCDBT store this reader cannot read, or a damaged one."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli), as the store's footers hold it."""
    table = _CRC32C
    crc ^= 0xFFFFFFFF
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Little-endian reads and varints from a byte string, named in errors."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated at byte {self.pos} (want {n} more)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64le(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint longer than 64 bits at byte {self.pos}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.what}: {len(self.data) - self.pos} bytes left over "
                             "after the last field")


def _inflate(body: bytes, limit: int, what: str) -> bytes:
    """A zstd body: its frame's content size when the header carries it (a
    small node's does), else at most ``limit`` bytes (the store's max
    decoded node bytes), the buffer grown until the frame fits."""
    from rxtpu_torch.data.decode import inflate_each

    if len(body) < 6 or struct.unpack("<I", body[:4])[0] != _ZSTD_MAGIC:
        raise OcdbtError(f"{what}: the body is not a zstd frame")
    fhd = body[4]
    fcs_flag, single_segment, dict_flag = fhd >> 6, (fhd >> 5) & 1, fhd & 3
    pos = 5 + (0 if single_segment else 1) + (0, 1, 2, 4)[dict_flag]
    size = (1 if single_segment else 0, 2, 4, 8)[fcs_flag]
    if size:
        want = int.from_bytes(body[pos:pos + size], "little") + (256 if size == 2 else 0)
        caps, exact = [want], True
    else:
        caps, exact = [], False
        cap = max(1 << 16, 16 * len(body))
        while cap < limit:
            caps.append(cap)
            cap *= 8
        caps.append(limit)
    for cap in caps:
        try:
            return inflate_each([body], [cap], nthreads=1, exact=exact)[0].tobytes()
        except ValueError:
            continue
    raise OcdbtError(f"{what}: the zstd body does not decompress"
                     + ("" if exact else f" within {limit} bytes"))


def _unframe(buf: bytes, magic: int, what: str, limit: int = _MANIFEST_LIMIT) -> bytes:
    """A manifest's or node's body, its header and CRC-32C footer checked;
    ``limit`` bounds the decoded size where the body does not carry it."""
    if len(buf) < 18:
        raise OcdbtError(f"{what}: {len(buf)} bytes is too short for a header and footer")
    head = _Cursor(buf, what)
    got_magic = struct.unpack(">I", head.take(4))[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:08x}, expected {magic:08x}")
    length = head.u64le()
    if length != len(buf):
        raise OcdbtError(f"{what}: the header says {length} bytes, the file has {len(buf)}")
    version = head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (this reader knows version 0)")
    compression = head.varint()
    stored = struct.unpack("<I", buf[-4:])[0]
    computed = crc32c(buf[:-4])
    if stored != computed:
        raise OcdbtError(f"{what}: bad checksum (CRC-32C {computed:08x}, footer says "
                         f"{stored:08x})")
    body = buf[head.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise OcdbtError(f"{what}: compression {compression} (this reader knows 0, none, "
                         "and 1, zstd)")
    return _inflate(body, limit, what)


def _data_file_table(cur: _Cursor) -> List[str]:
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{cur.what}: data file {i} shares {prefix[i]} bytes with a "
                             f"{len(prev)}-byte path")
        prev = prev[:prefix[i]] + cur.take(suffix[i])
        if base[i] > len(prev):
            raise OcdbtError(f"{cur.what}: data file {i}'s base path is longer than its path")
        paths.append(prev.decode())
    return paths


class _Files:
    """The store's files, each read once, by their paths under ``root``."""

    def __init__(self, root: str):
        self.root, self.cache = os.path.realpath(root), {}

    def read(self, path: str, offset: int, length: int, what: str) -> bytes:
        if path not in self.cache:
            full = os.path.realpath(os.path.join(self.root, path))
            if not path or os.path.commonpath([self.root, full]) != self.root:
                raise OcdbtError(f"{what}: data file {path!r} lies outside the store")
            try:
                with open(full, "rb") as f:
                    self.cache[path] = f.read()
            except OSError as e:
                raise OcdbtError(f"{what}: cannot read data file {path}: {e}") from None
        data = self.cache[path]
        if offset + length > len(data):
            raise OcdbtError(f"{what}: bytes {offset}..{offset + length} lie past the end of "
                             f"{path} ({len(data)} bytes)")
        return data[offset:offset + length]


def read_manifest(root: str) -> Dict:
    """The root manifest's config and newest version: ``{"config": {...},
    "root_height", "root": (path, offset, length) or None for an empty
    tree, "num_keys"}``."""
    path = os.path.join(root, MANIFEST_FILE)
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError as e:
        raise OcdbtError(f"no OCDBT manifest at {path}: {e}") from None
    cur = _Cursor(_unframe(buf, MANIFEST_MAGIC, path), path)
    config = {"uuid": cur.take(16).hex(), "manifest_kind": cur.varint(),
              "max_inline_value_bytes": cur.varint(), "max_decoded_node_bytes": cur.varint(),
              "version_tree_arity_log2": cur.u8(), "compression_method": cur.varint()}
    if config["compression_method"] == 1:
        config["zstd_level"] = struct.unpack("<i", cur.take(4))[0]
    elif config["compression_method"] != 0:
        raise OcdbtError(f"{path}: compression method {config['compression_method']} "
                         "(this reader knows 0, none, and 1, zstd)")
    if config["manifest_kind"] != 0:
        raise OcdbtError(f"{path}: manifest kind {config['manifest_kind']} (numbered "
                         "manifests are not covered; this reader knows kind 0, single)")
    files = _data_file_table(cur)
    n = cur.varint()
    if n == 0:
        raise OcdbtError(f"{path}: the manifest holds no version")
    generation = cur.varints(n)
    height = [cur.u8() for _ in range(n)]
    file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
    num_keys = cur.varints(n)
    # the roots' tree bytes and indirect value bytes, and the commit times,
    # are not needed; older versions follow in version tree nodes

    i = int(np.argmax(generation))
    root = None
    if num_keys[i] and offset[i] != _MISSING:
        if file_id[i] >= len(files):
            raise OcdbtError(f"{path}: the root names data file {file_id[i]} of {len(files)}")
        root = (files[file_id[i]], offset[i], length[i])
    return {"config": config, "root_height": height[i], "root": root,
            "num_keys": num_keys[i]}


def _read_node(files: _Files, ref: Tuple[str, int, int], height: int, prefix: bytes,
               out: Dict[bytes, bytes], limit: int) -> None:
    path, offset, length = ref
    what = f"B+tree node {path}@{offset}"
    cur = _Cursor(_unframe(files.read(path, offset, length, what), NODE_MAGIC, what, limit),
                  what)
    got = cur.u8()
    if got != height:
        raise OcdbtError(f"{what}: height {got}, its parent says {height}")
    table = _data_file_table(cur)
    n = cur.varint()
    key_prefix = [0] + cur.varints(max(n - 1, 0))
    key_suffix = cur.varints(n)
    common = cur.varints(n) if height else None
    keys, prev = [], b""
    for i in range(n):
        if key_prefix[i] > len(prev):
            raise OcdbtError(f"{what}: key {i} shares {key_prefix[i]} bytes with a "
                             f"{len(prev)}-byte key")
        prev = prev[:key_prefix[i]] + cur.take(key_suffix[i])
        keys.append(prev)

    def ref_at(file_id: int, off: int, size: int) -> Tuple[str, int, int]:
        if file_id >= len(table):
            raise OcdbtError(f"{what}: names data file {file_id} of {len(table)}")
        return table[file_id], off, size

    if height:
        file_id, off, size = cur.varints(n), cur.varints(n), cur.varints(n)
        for _ in range(3):  # each child's keys, tree bytes, indirect value bytes
            cur.varints(n)
        cur.done()
        for i in range(n):
            if common[i] > len(keys[i]):
                raise OcdbtError(f"{what}: subtree prefix of {common[i]} bytes in a "
                                 f"{len(keys[i])}-byte key")
            _read_node(files, ref_at(file_id[i], off[i], size[i]), height - 1,
                       prefix + keys[i][:common[i]], out, limit)
        return
    value_length = cur.varints(n)
    kind = cur.varints(n)
    if any(k not in (0, 1) for k in kind):
        raise OcdbtError(f"{what}: value kind {max(kind)} (this reader knows 0, inline, "
                         "and 1, in a data file)")
    indirect = [i for i in range(n) if kind[i] == 1]
    file_id, off = cur.varints(len(indirect)), cur.varints(len(indirect))
    located = {i: ref_at(f, o, value_length[i]) for i, f, o in zip(indirect, file_id, off)}
    for i in range(n):
        value = files.read(*located[i], what) if kind[i] else cur.take(value_length[i])
        out[prefix + keys[i]] = value
    cur.done()


def read_ocdbt(root: str) -> Dict[bytes, bytes]:
    """Every key -> value of the newest version of the OCDBT store at
    ``root`` (a directory holding ``manifest.ocdbt``), keys in order."""
    manifest = read_manifest(root)
    out: Dict[bytes, bytes] = {}
    if manifest["root"] is not None:
        _read_node(_Files(root), manifest["root"], manifest["root_height"], b"", out,
                   manifest["config"]["max_decoded_node_bytes"])
    if len(out) != manifest["num_keys"]:
        raise OcdbtError(f"{root}: read {len(out)} keys, the manifest counts "
                         f"{manifest['num_keys']}")
    return out
