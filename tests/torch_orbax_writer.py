"""A writer of the JAX package's orbax checkpoint layout, without orbax,
tensorstore or JAX: the test and card-side counterpart of
``checkpoint/orbax_io.py:save_pytree`` (``ocp.StandardCheckpointer``), as
``torch_tf_bundle_writer.py`` is of the reference's TF1 bundles.

``write_orbax(path, tree)`` writes ``_METADATA`` and ``_CHECKPOINT_METADATA``
(JSON), every array leaf as a zarr v2 array (``<keys joined by .>/.zarray``
and its chunks, zstd level 1 through the port's ``checkpoint/zstd.py``), and
an OCDBT store over them: ``manifest.ocdbt`` (one version), B-tree nodes in
``d/<hash>`` (one leaf, or leaves of ``leaf_entries`` keys under interior
nodes of ``fanout`` children), and the values larger than
``max_inline_value_bytes`` in ``ocdbt.process_0/d/<hash>``, which the nodes
reach through the base path ``ocdbt.process_0/`` as orbax's merged root does.
``ocdbt.py``'s docstring gives the encoding. The JAX package's
``restore_pytree`` reads the result (``tests/test_torch_orbax.py``).

Leaves: numpy arrays, ``Bfloat16(bits)`` (a bfloat16 array as its uint16
bits, numpy having no bfloat16), Python ints and floats (orbax's
``scalar``), and ``None``/``{}``/``[]`` (its empty values). Dicts take their
keys as given; lists and tuples are indexed.
"""

from __future__ import annotations

import hashlib
import json
import struct
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import zstd
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint.ocdbt import crc32c

MANIFEST_MAGIC, BTREE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
VALUES_BASE = "ocdbt.process_0/"


@dataclass
class Bfloat16:
    bits: np.ndarray  # uint16

    @staticmethod
    def from_float32(x: np.ndarray) -> "Bfloat16":
        """Round to nearest even, as a float32 -> bfloat16 cast does (finite inputs)."""
        u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
        return Bfloat16(((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16))


def varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _column(values) -> bytes:
    return b"".join(varint(v) for v in values)


def encode_file(magic: int, body: bytes, compress: bool = True) -> bytes:
    payload = zstd.compress(body) if compress else body
    head_tail = struct.pack(">I", magic) + b"\0" * 8 + varint(0) + varint(1 if compress else 0)
    raw = bytearray(head_tail + payload + b"\0" * 4)
    raw[4:12] = struct.pack("<Q", len(raw))
    raw[-4:] = struct.pack("<I", crc32c(raw[:-4]))
    return bytes(raw)


def data_file_table(paths: list[tuple[str, str]]) -> bytes:
    """(base path, relative path) pairs, prefix-coded."""
    full = [(b + r).encode() for b, r in paths]
    prefix = []
    for prev, cur in zip(full, full[1:]):
        n = 0
        while n < min(len(prev), len(cur)) and prev[n] == cur[n]:
            n += 1
        prefix.append(n)
    suffixes = [full[0]] + [cur[n:] for cur, n in zip(full[1:], prefix)] if full else []
    return (varint(len(full)) + _column(prefix) + _column(len(s) for s in suffixes)
            + _column(len(b.encode()) for b, _ in paths) + b"".join(suffixes))


def _keys(keys: list[bytes], with_common: list[int] | None = None) -> bytes:
    prefix = []
    for prev, cur in zip(keys, keys[1:]):
        n = 0
        while n < min(len(prev), len(cur)) and prev[n] == cur[n]:
            n += 1
        prefix.append(n)
    suffixes = [keys[0]] + [cur[n:] for cur, n in zip(keys[1:], prefix)]
    out = varint(len(keys)) + _column(prefix) + _column(len(s) for s in suffixes)
    if with_common is not None:
        out += _column(with_common)
    return out + b"".join(suffixes)


def _common(keys: list[bytes]) -> int:
    first, last = keys[0], keys[-1]
    n = 0
    while n < min(len(first), len(last)) and first[n] == last[n]:
        n += 1
    return n


def _flatten(tree, keys=()):
    """(key_metadata, value) of every leaf, keys as orbax records them."""
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _flatten(v, keys + ((str(k), 2),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + ((str(i), 1),))
    else:
        yield keys, tree


def _zarray(shape, chunks, dtype: str) -> bytes:
    return json.dumps({"chunks": list(chunks), "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
                       "dtype": dtype, "fill_value": None, "filters": None, "order": "C", "shape": list(shape),
                       "zarr_format": 2}, separators=(",", ":")).encode()


def _array_values(name: str, arr: np.ndarray, dtype: str, chunks) -> dict[bytes, bytes]:
    """The .zarray and every chunk (full-size, edge chunks padded with zeros) of one array."""
    chunks = tuple(chunks) if chunks is not None else arr.shape
    out = {f"{name}/.zarray".encode(): _zarray(arr.shape, chunks, dtype)}
    grid = [-(-s // c) for s, c in zip(arr.shape, chunks)]
    for index in np.ndindex(*grid):
        block = np.zeros(chunks, arr.dtype)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, arr.shape))
        block[tuple(slice(0, r.stop - r.start) for r in region)] = arr[region]
        key = ".".join(map(str, index)) if index else "0"
        out[f"{name}/{key}".encode()] = zstd.compress(block.tobytes())
    return out


def write_orbax(path, tree, *, max_inline_value_bytes: int = 1024, leaf_entries: int | None = None,
                fanout: int = 4, chunks: dict[str, tuple] | None = None, compress_nodes: bool = True,
                seed: int = 0) -> None:
    """Write ``tree`` as an orbax checkpoint directory at ``path``.
    ``chunks``: a chunk shape for some arrays (by their dotted name); the rest
    are one chunk, as orbax writes a replicated array."""
    path = Path(path)
    (path / "d").mkdir(parents=True, exist_ok=True)
    (path / VALUES_BASE / "d").mkdir(parents=True, exist_ok=True)
    metadata, values = {}, {}
    for keys, leaf in _flatten(tree):
        name = ".".join(k for k, _ in keys)
        if isinstance(leaf, Bfloat16):
            value_type, arr, dtype = "np.ndarray", leaf.bits, "bfloat16"
        elif isinstance(leaf, np.ndarray) or isinstance(leaf, np.generic):
            arr = np.asarray(leaf, order="C")
            value_type, dtype = "np.ndarray", arr.dtype.str
        elif isinstance(leaf, (bool, int, float)):
            value_type, arr = "scalar", np.asarray(leaf, np.int64 if isinstance(leaf, int) else np.float64)
            dtype = arr.dtype.str
        elif leaf is None or leaf == {} or leaf == []:
            value_type, arr = {type(None): "None", dict: "Dict", list: "List"}[type(leaf)], None
        else:
            raise TypeError(f"{name}: a leaf of type {type(leaf).__name__}")
        metadata[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": value_type, "skip_deserialize": arr is None}}
        if arr is not None:
            values.update(_array_values(name, arr, dtype, (chunks or {}).get(name)))

    # the values too large to lie inline, back to back in one data file of ocdbt.process_0/
    blob, where = bytearray(), {}
    for key in sorted(values):
        if len(values[key]) > max_inline_value_bytes:
            where[key] = len(blob)
            blob += values[key]
    blob_name = "d/" + hashlib.md5(bytes(blob) + b"values").hexdigest()
    (path / VALUES_BASE / blob_name).write_bytes(bytes(blob))

    # B-tree nodes, back to back in one data file of the root
    nodes = bytearray()
    nodes_name = "d/" + hashlib.md5(repr(sorted(where.items())).encode() + bytes(blob[:64])).hexdigest()

    def leaf(keys: list[bytes], prefix: bytes) -> tuple[int, int, int]:
        rel = [k[len(prefix):] for k in keys]
        inline = [k for k in keys if k not in where]
        indirect = [k for k in keys if k in where]
        body = (bytes([0]) + data_file_table([(VALUES_BASE, blob_name)] if indirect else []) + _keys(rel)
                + _column(len(values[k]) for k in keys) + _column(int(k in where) for k in keys)
                + _column(0 for _ in indirect) + _column(where[k] for k in indirect)
                + b"".join(values[k] for k in inline))
        return put(body) + (sum(len(values[k]) for k in indirect),)

    def put(body: bytes) -> tuple[int, int]:
        raw = encode_file(BTREE_MAGIC, body, compress_nodes)
        nodes.extend(raw)
        return len(nodes) - len(raw), len(raw)

    def subtree(keys: list[bytes], prefix: bytes, height: int) -> tuple[int, int, int, int]:
        """(offset, length, tree bytes, indirect bytes) of the node over ``keys``, whose keys are taken
        relative to ``prefix``."""
        if height == 0:
            off, n, indirect = leaf(keys, prefix)
            return off, n, n, indirect
        per = leaf_entries * fanout ** (height - 1)
        groups = [keys[i:i + per] for i in range(0, len(keys), per)]
        common = [_common([k[len(prefix):] for k in g]) for g in groups]
        children = [subtree(g, prefix + g[0][len(prefix):len(prefix) + c], height - 1)
                    for g, c in zip(groups, common)]
        body = (bytes([height]) + data_file_table([("", nodes_name)]) + _keys([g[0][len(prefix):] for g in groups],
                                                                              common)
                + _column(0 for _ in groups) + _column(c[0] for c in children) + _column(c[1] for c in children)
                + _column(len(g) for g in groups) + _column(c[2] for c in children)
                + _column(c[3] for c in children))
        off, n = put(body)
        return off, n, n + sum(c[2] for c in children), sum(c[3] for c in children)

    keys = sorted(values)
    height = 0
    if leaf_entries:
        while leaf_entries * fanout ** height < len(keys):
            height += 1
    root_off, root_len, tree_bytes, indirect_bytes = subtree(keys, b"", height)
    (path / nodes_name).write_bytes(bytes(nodes))

    rng = np.random.default_rng(seed)
    config = (rng.integers(0, 256, 16, dtype=np.uint8).tobytes() + varint(0) + varint(max_inline_value_bytes)
              + varint(100_000_000) + bytes([4]) + varint(1) + struct.pack("<i", 0))
    commit = time.time_ns()
    versions = (varint(1) + varint(1) + bytes([height]) + varint(0) + varint(root_off) + varint(root_len)
                + varint(len(keys)) + varint(tree_bytes) + varint(indirect_bytes) + struct.pack("<Q", commit)
                + varint(0))
    (path / "manifest.ocdbt").write_bytes(
        encode_file(MANIFEST_MAGIC, config + data_file_table([("", nodes_name)]) + versions, compress_nodes))
    (path / "_METADATA").write_text(json.dumps({
        "tree_metadata": metadata, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    (path / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler",
        "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": commit,
        "commit_timestamp_nsecs": commit, "custom_metadata": {}}))
