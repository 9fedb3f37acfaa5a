"""OCDBT, the key-value store under Orbax checkpoints, read and written
without tensorstore.

An OCDBT database is a directory: ``manifest.ocdbt`` names the versions of
a B+tree whose nodes and indirect values live in data files (``d/<id>``).
Orbax writes one database per process (``ocdbt.process_N/``) and then one
at the top whose tree points into theirs.  Every manifest and node is

    magic (uint32 big-endian) | length (uint64) | version (varint, 0)
    | compression (varint: 0 none, 1 zstd) | body | crc32c (uint32)

with the body zstd-compressed when compression is 1 (decoded by the port's
own decoder, ``_native.zstd_decompress``).  Within a body, integers are
LEB128 varints, lists are stored column by column, and keys and data-file
paths are prefix-compressed against their predecessor.

``OcdbtStore`` reads the latest version of a database (the top one, else
the union of the per-process ones); ``write_ocdbt`` writes a database of
one leaf node, uncompressed, that tensorstore reads.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, Iterable, List, Optional, Tuple

MANIFEST = "manifest.ocdbt"
_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_MAX_INLINE = 1024           # Orbax's max_inline_value_bytes
_MAX_NODE_BYTES = 100_000_000

# A value: bytes held inline in its node, or (data file, offset, length).
Ref = Tuple[str, int, int]


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum OCDBT ends each file part with."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a decoded body; running past its end raises."""

    def __init__(self, data: bytes, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def fail(self, why: str) -> ValueError:
        return ValueError(f"OCDBT {self.what}: {why}")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise self.fail("varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def data_files(self) -> List[str]:
        """A data-file table: each path prefix-compressed against the one
        before it (base path and relative path are not told apart here,
        both resolve against the database's directory)."""
        n = self.varint()
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        self.varints(n)                       # base-path lengths
        paths, prev = [], ""
        for p, s in zip(prefix, suffix):
            if p > len(prev):
                raise self.fail("bad data-file prefix")
            prev = prev[:p] + self.take(s).decode()
            if os.path.isabs(prev) or ".." in prev.split("/"):
                raise self.fail(f"data file outside the database: {prev!r}")
            paths.append(prev)
        return paths

    def keys(self, n: int, common: bool = False):
        """``n`` prefix-compressed keys (and, for an interior node, each
        subtree's common-prefix length)."""
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        subtree = self.varints(n) if common else None
        keys, prev = [], b""
        for p, s in zip(prefix, suffix):
            if p > len(prev):
                raise self.fail("bad key prefix")
            prev = prev[:p] + self.take(s)
            keys.append(prev)
        return keys, subtree


def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file part: checks the magic, the
    length, the version and the crc32c, and decodes a zstd body."""
    from .. import _native

    if len(raw) < 18:
        raise ValueError(f"OCDBT {what}: truncated")
    got_magic, length = struct.unpack(">I", raw[:4])[0], \
        struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"OCDBT {what}: bad magic {got_magic:#010x}")
    if length != len(raw):
        raise ValueError(f"OCDBT {what}: length {length} != {len(raw)}")
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise ValueError(f"OCDBT {what}: crc32c mismatch")
    head = _Reader(raw[12:-4], what)
    if head.varint() != 0:
        raise ValueError(f"OCDBT {what}: unknown format version")
    compression = head.varint()
    body = raw[12 + head.pos:-4]
    if compression == 1:
        return _native.zstd_decompress(body)
    if compression != 0:
        raise ValueError(f"OCDBT {what}: unknown compression {compression}")
    return body


def _read_part(root: str, path: str, offset: int, length: int) -> bytes:
    with open(os.path.join(root, path), "rb") as f:
        f.seek(offset)
        data = f.read(length)
    if len(data) != length:
        raise ValueError(f"OCDBT: {path} ends before {offset + length}")
    return data


class OcdbtStore:
    """The latest version of the OCDBT database(s) in ``root``, as a
    read-only mapping key (str) -> bytes.  Values are read from their data
    files when asked for."""

    def __init__(self, root: str):
        self.root = root
        self._values: Dict[str, object] = {}   # key -> bytes | (dir, Ref)
        if os.path.isfile(os.path.join(root, MANIFEST)):
            dbs = [root]
        else:   # no top-level tree: the per-process ones, in key order
            dbs = sorted(os.path.join(root, d) for d in os.listdir(root)
                         if d.startswith("ocdbt.process_") and
                         os.path.isfile(os.path.join(root, d, MANIFEST)))
        if not dbs:
            raise ValueError(f"no OCDBT manifest in {root!r}")
        for db in dbs:
            self._read_db(db)

    def _read_db(self, db: str) -> None:
        with open(os.path.join(db, MANIFEST), "rb") as f:
            r = _Reader(_unwrap(f.read(), _MANIFEST_MAGIC, "manifest"),
                        "manifest")
        r.take(16)                                  # uuid
        if r.varint() != 0:
            raise r.fail("a numbered manifest is not supported (Orbax "
                         "writes single manifests)")
        r.varint()                                  # max inline value bytes
        r.varint()                                  # max decoded node bytes
        r.byte()                                    # version tree arity log2
        if r.varint() == 1:                         # zstd: its level
            r.take(4)
        files = r.data_files()
        n = r.varint()                              # the inline versions
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        # Statistics, commit times and older versions' nodes are not needed.
        if not n:
            return
        latest = max(range(n), key=generation.__getitem__)
        if length[latest]:
            if file_id[latest] >= len(files):
                raise r.fail("bad data-file id")
            self._walk(db, (files[file_id[latest]], offset[latest],
                            length[latest]), height[latest], b"")

    def _walk(self, db: str, ref: Ref, height: int, prefix: bytes) -> None:
        r = _Reader(_unwrap(_read_part(db, *ref), _NODE_MAGIC, "node"),
                    "node")
        if r.byte() != height:
            raise r.fail("height differs from its parent's")
        files = r.data_files()
        n = r.varint()

        def file_of(i):
            if i >= len(files):
                raise r.fail("bad data-file id")
            return files[i]

        if height == 0:
            keys, _ = r.keys(n)
            lengths = r.varints(n)
            kinds = r.varints(n)
            indirect = [i for i in range(n) if kinds[i] == 1]
            if any(k not in (0, 1) for k in kinds):
                raise r.fail("unknown value kind")
            ids, offsets = (r.varints(len(indirect)),
                            r.varints(len(indirect)))
            where = dict(zip(indirect, zip(ids, offsets)))
            for i, key in enumerate(keys):
                name = (prefix + key).decode()
                if i in where:
                    fid, off = where[i]
                    self._values[name] = (db, (file_of(fid), off, lengths[i]))
                else:
                    self._values[name] = r.take(lengths[i])
            return
        keys, common = r.keys(n, common=True)
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        for key, c, fid, off, ln in zip(keys, common, ids, offsets, lengths):
            self._walk(db, (file_of(fid), off, ln), height - 1,
                       prefix + key[:c])

    def keys(self) -> List[str]:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def __getitem__(self, key: str) -> bytes:
        value = self._values[key]
        if isinstance(value, bytes):
            return value
        db, ref = value
        return _read_part(db, *ref)

    def get(self, key: str, default=None) -> Optional[bytes]:
        return self[key] if key in self._values else default


# ---- writing -------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in values)


def _wrap(body: bytes, magic: int) -> bytes:
    """An uncompressed file part around ``body``, with its crc32c."""
    head_tail = _varint(0) + _varint(0)          # version 0, no compression
    length = 4 + 8 + len(head_tail) + len(body) + 4
    raw = struct.pack(">I", magic) + struct.pack("<Q", length) + \
        head_tail + body
    return raw + struct.pack("<I", crc32c(raw))


def _data_file_table(paths: List[str]) -> bytes:
    # One path per table here: no prefix to share.
    encoded = [p.encode() for p in paths]
    return (_varint(len(paths)) + _varints(len(p) for p in encoded)
            + _varints(0 for _ in paths) + b"".join(encoded))


def write_ocdbt(root: str, items: Dict[str, bytes]) -> None:
    """Write ``items`` as a new OCDBT database in ``root``: one version
    whose tree is one uncompressed leaf node; values over 1 KiB go to a
    data file, smaller ones inline, as Orbax configures it.  The data file
    holds the values, then the node."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    uuid = os.urandom(16)
    data_path = f"d/{uuid.hex()}"
    keys = sorted(items, key=str.encode)
    enc = [k.encode() for k in keys]
    lengths, kinds, offsets, inline = [], [], [], []
    with open(os.path.join(root, data_path), "wb") as f:
        for key in keys:
            value = items[key]
            lengths.append(len(value))
            if len(value) > _MAX_INLINE:
                kinds.append(1)
                offsets.append(f.tell())
                f.write(value)
            else:
                kinds.append(0)
                inline.append(bytes(value))
        prefix = [os.path.commonprefix([a, b]) for a, b in zip(enc, enc[1:])]
        node = _wrap(
            bytes([0]) + _data_file_table([data_path]) + _varint(len(keys))
            + _varints(len(p) for p in prefix)
            + _varints(len(k) - len(p) for k, p in zip(enc, [b""] + prefix))
            + b"".join(k[len(p):] for k, p in zip(enc, [b""] + prefix))
            + _varints(lengths) + _varints(kinds)
            + _varints(0 for _ in offsets) + _varints(offsets)
            + b"".join(inline), _NODE_MAGIC)
        node_offset = f.tell()
        f.write(node)
    config = (uuid + _varint(0) + _varint(_MAX_INLINE)
              + _varint(_MAX_NODE_BYTES) + bytes([4]) + _varint(0))
    version = (_varint(1) + _varint(1) + bytes([0])     # 1 version, gen 1
               + _varint(0) + _varint(node_offset) + _varint(len(node))
               + _varint(len(keys)) + _varint(len(node))
               + _varint(sum(n for n, k in zip(lengths, kinds) if k == 1))
               + struct.pack("<Q", time.time_ns()))
    manifest = _wrap(config + _data_file_table([data_path]) + version
                     + _varint(0), _MANIFEST_MAGIC)
    tmp = os.path.join(root, MANIFEST + ".tmp")
    with open(tmp, "wb") as f:
        f.write(manifest)
    os.replace(tmp, os.path.join(root, MANIFEST))
