"""A read-only OCDBT key-value store: the layout under an orbax checkpoint
directory (``manifest.ocdbt``, ``d/<hash>``, ``ocdbt.process_<i>/...``) in
which tensorstore keeps every zarr array of the tree. numpy and the system's
``libzstd`` only.

Every file of the format, a manifest, a B-tree node or a version-tree node,
is ``magic (u32, big-endian) | length (u64le, the whole file) | version
(varint, 0) | compression (varint, 0 none or 1 zstd) | body | CRC-32C (u32le)
of all that precedes it``. A node is addressed by (data file, offset, length);
a data file also holds the values too large to lie inline. Its fields, as
tensorstore writes them (integers are LEB128 varints unless said otherwise;
every per-entry field is a column of ``n`` values, written one column after
the other):

* manifest (magic ``0x0cdb3a2a``): the config, ``uuid`` (16 bytes),
  ``manifest_kind`` (0 = the versions lie in this file; 1 = numbered
  manifest files, which this reader refuses), ``max_inline_value_bytes``,
  ``max_decoded_node_bytes``, ``version_tree_arity_log2`` (u8),
  ``compression_method`` (0 none, 1 zstd with a level, i32le); then a data
  file table; the newest versions inline (``n``, ``generation``,
  ``root_height`` (u8), ``data_file``, ``offset``, ``length``, ``num_keys``,
  ``num_tree_bytes``, ``num_indirect_value_bytes``, ``commit_time`` (u64le));
  and references to version-tree nodes holding the older ones (``n``,
  ``generation`` (the newest below), ``data_file``, ``offset``, ``length``,
  ``num_generations``, ``commit_time``, ``height`` (u8)).
* B-tree node (magic ``0x0cdb20de``): ``height`` (u8), a data file table,
  ``n``, the keys (``prefix_length`` for entries 1.., each the bytes shared
  with the previous key; ``suffix_length``; at height > 0
  ``subtree_common_prefix_length``; then the suffixes back to back), and at
  height 0 ``value_length``, ``value_kind`` (0 inline, 1 in a data file),
  ``data_file`` and ``offset`` for each indirect value, then the inline
  values back to back; above it ``data_file``, ``offset``, ``length``,
  ``num_keys``, ``num_tree_bytes``, ``num_indirect_value_bytes`` of each
  child. A node's keys follow the prefix its parent entry gives it: the
  first ``subtree_common_prefix_length`` bytes of that entry's key.
* data file table: ``n``, ``prefix_length`` (entries 1.., shared with the
  previous path), ``suffix_length``, ``base_path_length``, the suffixes. A
  path is ``base_path + relative_path``; ``base_path`` is taken relative to
  the base path of the file the table lies in (a merged orbax root reaches
  ``ocdbt.process_0/`` this way), and the result relative to the store's root.

Only the newest version is read; it always lies inline in the manifest (the
version-tree nodes, magic ``0x0cdb1234``, hold older ones).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)
del _i, _c


def crc32c(data) -> int:
    """CRC-32C (Castagnoli), as tensorstore's footers hold it."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for byte in bytes(data):
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class FormatError(ValueError):
    pass


class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise FormatError(f"{self.what}: truncated at byte {self.pos}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise FormatError(f"{self.what}: a varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise FormatError(f"{self.what}: {len(self.data) - self.pos} bytes left after the last field")


def decode_file(raw: bytes, magic: int, what: str, limit: int) -> _Cursor:
    """Check an encoded manifest or node (magic, length, version, CRC-32C) and
    return a cursor over its body, decompressed (at most ``limit`` bytes)."""
    if len(raw) < 18:
        raise FormatError(f"{what}: {len(raw)} bytes, too short")
    got_magic, length = struct.unpack_from(">I", raw)[0], struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise FormatError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(raw):
        raise FormatError(f"{what}: header says {length} bytes, found {len(raw)}")
    want = struct.unpack_from("<I", raw, len(raw) - 4)[0]
    if crc32c(raw[:-4]) != want:
        raise FormatError(f"{what}: CRC-32C mismatch (footer {want:#010x})")
    head = _Cursor(raw[:-4], what)
    head.take(12)
    if (version := head.varint()) != 0:
        raise FormatError(f"{what}: format version {version}, this reader knows 0")
    compression = head.varint()
    body = raw[head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body, limit)
    elif compression != 0:
        raise FormatError(f"{what}: compression format {compression} (0 none and 1 zstd are known)")
    return _Cursor(body, what)


@dataclass(frozen=True)
class DataFile:
    base_path: str
    relative_path: str

    @property
    def path(self) -> str:
        return self.base_path + self.relative_path


def read_data_file_table(cur: _Cursor, base: str) -> list[DataFile]:
    """The table's paths, each ``base_path`` taken relative to ``base``, the
    base path of the file holding the table."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    out, prev = [], b""
    for i in range(n):
        full = prev[:prefix[i]] + cur.take(suffix[i])
        if prefix[i] > len(prev) or base_len[i] > len(full):
            raise FormatError(f"{cur.what}: a data file path's lengths overrun it")
        out.append(DataFile(base + full[:base_len[i]].decode(), full[base_len[i]:].decode()))
        prev = full
    return out


@dataclass(frozen=True)
class Ref:
    """A node or an indirect value: ``length`` bytes at ``offset`` of ``file``."""
    file: DataFile
    offset: int
    length: int


@dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: str  # "none" or "zstd"
    zstd_level: int | None


@dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Ref | None  # None: the empty tree
    num_keys: int
    commit_time: int  # nanoseconds since the epoch


def _versions(cur: _Cursor, files: list[DataFile]) -> list[Version]:
    n = cur.varint()
    gen = cur.varints(n)
    height = [cur.u8() for _ in range(n)]
    file_id, offset, length, num_keys = cur.varints(n), cur.varints(n), cur.varints(n), cur.varints(n)
    cur.varints(n)  # num_tree_bytes
    cur.varints(n)  # num_indirect_value_bytes
    times = [struct.unpack("<Q", cur.take(8))[0] for _ in range(n)]
    return [Version(gen[i], height[i],
                    None if num_keys[i] == 0 else Ref(_file(cur, files, file_id[i]), offset[i], length[i]),
                    num_keys[i], times[i]) for i in range(n)]


def _skip_version_refs(cur: _Cursor) -> None:
    """Consume the manifest's references to version-tree nodes, which hold
    the older versions this reader does not read."""
    n = cur.varint()
    for _ in range(5):  # generation, data_file, offset, length, num_generations
        cur.varints(n)
    cur.take(8 * n)  # commit_time
    cur.take(n)  # height


def _file(cur: _Cursor, files: list[DataFile], i: int) -> DataFile:
    if i >= len(files):
        raise FormatError(f"{cur.what}: data file {i} of a table of {len(files)}")
    return files[i]


class OcdbtStore:
    """The newest version of the OCDBT store under ``root``, its keys and
    values read once at open: ``list()``, ``read(key)``, ``buffer(key)``.

    Each data file is memory-mapped once; an indirect value is a slice of
    that map, so a large value is paged in as it is decoded."""

    def __init__(self, root):
        self.root = Path(root)
        self._maps: dict[str, np.ndarray] = {}
        raw = (self.root / MANIFEST).read_bytes()
        # the node size limit lies inside the (compressed) manifest: bound the manifest itself generously
        cur = decode_file(raw, MANIFEST_MAGIC, str(self.root / MANIFEST), limit=1 << 31)
        self.config = self._config(cur)
        if self.config.manifest_kind != 0:
            raise FormatError(f"{self.root}: manifest kind {self.config.manifest_kind} (numbered manifests); "
                              "this reader takes the single-file manifest orbax writes")
        files = read_data_file_table(cur, "")
        versions = _versions(cur, files)
        _skip_version_refs(cur)
        cur.end()
        self.version = self._newest(versions)
        self._values: dict[bytes, object] = {}
        if self.version.root is not None:
            self._walk(self.version.root, self.version.root_height, b"")
        if len(self._values) != self.version.num_keys:
            raise FormatError(f"{self.root}: {len(self._values)} keys found, the manifest says "
                              f"{self.version.num_keys}")

    @staticmethod
    def _config(cur: _Cursor) -> Config:
        uuid = cur.take(16)
        kind, inline, node_bytes = cur.varint(), cur.varint(), cur.varint()
        arity = cur.u8()
        method = cur.varint()
        if method == 0:
            return Config(uuid, kind, inline, node_bytes, arity, "none", None)
        if method != 1:
            raise FormatError(f"{cur.what}: compression method {method} (0 none and 1 zstd are known)")
        return Config(uuid, kind, inline, node_bytes, arity, "zstd", struct.unpack("<i", cur.take(4))[0])

    def _newest(self, versions: list[Version]) -> Version:
        """The newest version. tensorstore adds every commit to the manifest's
        inline versions and moves only older ones into version-tree nodes, so
        the newest always lies inline; the nodes are not read."""
        if not versions:
            raise FormatError(f"{self.root}: the manifest holds no inline version")
        return max(versions, key=lambda v: v.generation)

    @property
    def _limit(self) -> int:
        return self.config.max_decoded_node_bytes

    def _what(self, ref: Ref) -> str:
        return f"{self.root / ref.file.path} [{ref.offset}:+{ref.length}]"

    def _map(self, file: DataFile) -> np.ndarray:
        path = file.path
        if path not in self._maps:
            self._maps[path] = np.memmap(self.root / path, np.uint8, mode="r")
        return self._maps[path]

    def _slice(self, ref: Ref) -> np.ndarray:
        data = self._map(ref.file)
        if ref.offset + ref.length > data.size:
            raise FormatError(f"{self._what(ref)}: past the end of a {data.size}-byte file")
        return data[ref.offset:ref.offset + ref.length]

    def _bytes(self, ref: Ref) -> bytes:
        return self._slice(ref).tobytes()

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        cur = decode_file(self._bytes(ref), BTREE_MAGIC, self._what(ref), self._limit)
        if (got := cur.u8()) != height:
            raise FormatError(f"{cur.what}: height {got}, its parent says {height}")
        files = read_data_file_table(cur, ref.file.base_path)
        n = cur.varint()
        pre = [0] + cur.varints(n - 1) if n else []
        suf = cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if pre[i] > len(prev):
                raise FormatError(f"{cur.what}: a key's prefix overruns the previous key")
            prev = prev[:pre[i]] + cur.take(suf[i])
            keys.append(prev)
        if height:
            file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(n)  # num_keys
            cur.varints(n)  # num_tree_bytes
            cur.varints(n)  # num_indirect_value_bytes
            cur.end()
            for i in range(n):
                child = Ref(_file(cur, files, file_id[i]), offset[i], length[i])
                self._walk(child, height - 1, prefix + keys[i][:common[i]])
            return
        lengths, kinds = cur.varints(n), cur.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise FormatError(f"{cur.what}: a value kind other than 0 (inline) and 1 (indirect)")
        file_id, offset = cur.varints(len(indirect)), cur.varints(len(indirect))
        at = dict(zip(indirect, range(len(indirect))))
        for i in range(n):
            key = prefix + keys[i]
            if i in at:
                j = at[i]
                self._values[key] = Ref(_file(cur, files, file_id[j]), offset[j], lengths[i])
            else:
                self._values[key] = cur.take(lengths[i])
        cur.end()

    def list(self) -> list[str]:
        """Every key, in order (UTF-8; other bytes as surrogate escapes)."""
        return [k.decode("utf-8", "surrogateescape") for k in sorted(self._values)]

    def buffer(self, key: str):
        """The value of ``key`` as a byte buffer (bytes inline, a read-only
        uint8 view of the data file's map otherwise), or None if absent."""
        value = self._values.get(key.encode("utf-8", "surrogateescape"))
        return self._slice(value) if isinstance(value, Ref) else value

    def read(self, key: str) -> bytes | None:
        value = self.buffer(key)
        return None if value is None else bytes(value)
