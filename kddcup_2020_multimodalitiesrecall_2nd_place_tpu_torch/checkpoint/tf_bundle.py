"""TF1 checkpoint (tensor_bundle) reading without TensorFlow: the port's own
copy of the JAX package's ``checkpoint/tf_bundle.py`` pure-Python reader.

The reference's ImageBERT-A and -B/C checkpoints are TF ``tensor_bundle``
pairs (``<prefix>.index`` + ``<prefix>.data-00000-of-00001``). The ``.index``
file is a LevelDB *table* of ``BundleEntryProto`` values; each entry records
a tensor's dtype, shape, shard, offset and size in the data file. The parser
covers what TF1's ``tf.train.Saver`` writes: data shards without slices,
index blocks stored plain or snappy-compressed, each followed by its 5-byte
trailer (a compression byte and a CRC, which is not checked). No TensorFlow
branch: the reader always parses the files itself, and a bundle it cannot
parse raises.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# tensorflow DataType enum -> numpy dtype (subset used by the checkpoints)
_TF_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    6: np.int8,
    9: np.int64,
    10: np.bool_,
    14: np.dtype("bfloat16") if hasattr(np, "bfloat16") else np.uint16,
    19: np.float16,
}


def read_tf_checkpoint(prefix) -> dict[str, np.ndarray]:
    """Read ``<prefix>.index`` / ``<prefix>.data-*`` into a flat ``{variable name: array}`` dict."""
    return _read_pure_python(str(prefix))


# --------------------------------------------------------------------------
# pure-python tensor_bundle parsing
# --------------------------------------------------------------------------


def _read_pure_python(prefix: str) -> dict[str, np.ndarray]:
    index_path = Path(prefix + ".index")
    if not index_path.exists():
        raise FileNotFoundError(index_path)
    entries = _parse_index(index_path.read_bytes())
    datafiles = sorted(Path(prefix).parent.glob(Path(prefix).name + ".data-*"))
    if not datafiles:
        raise FileNotFoundError(f"{prefix}.data-*")
    shards = [p.read_bytes() for p in datafiles]
    out: dict[str, np.ndarray] = {}
    for name, entry in entries.items():
        if name == "":
            continue  # the header entry
        dtype = _TF_DTYPES.get(entry["dtype"])
        if dtype is None:
            continue
        shape = entry["shape"]
        shard = entry.get("shard_id", 0)
        off, size = entry.get("offset", 0), entry["size"]
        raw = shards[shard][off : off + size]
        out[name] = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    return out


def _parse_index(data: bytes) -> dict[str, dict]:
    """Parse a LevelDB-format table of BundleEntryProto values."""
    # footer: 48 bytes at the end: metaindex handle + index handle + magic
    magic = data[-8:]
    if magic != b"\x57\xfb\x80\x8b\x24\x75\x47\xdb":
        raise ValueError("not a LevelDB table (bad magic)")
    footer = data[-48:]
    pos = 0
    _, pos = _varint(footer, pos)  # metaindex offset
    _, pos = _varint(footer, pos)  # metaindex size
    index_off, pos = _varint(footer, pos)
    index_size, pos = _varint(footer, pos)
    index_block = _read_block(data, index_off, index_size)
    entries: dict[str, dict] = {}
    for _, handle in _iter_block(index_block):
        h = 0
        off, h = _varint(handle, h)
        size, h = _varint(handle, h)
        block = _read_block(data, off, size)
        for key, value in _iter_block(block):
            entries[key.decode("utf-8", "replace")] = _parse_bundle_entry(value)
    return entries


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    block = data[offset : offset + size]
    compression = data[offset + size]
    if compression == 0:
        return block
    if compression == 1:  # snappy
        return _snappy_decompress(block)
    raise ValueError(f"unsupported block compression {compression}")


def _iter_block(block: bytes):
    """Iterate (key, value) records of a LevelDB block (ignoring restarts)."""
    if len(block) < 4:
        return
    n_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        value_len, pos = _varint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def _varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_bundle_entry(value: bytes) -> dict:
    """Minimal BundleEntryProto parse: dtype(1) shape(2) shard(3) offset(4)
    size(5) crc(6); shape is a TensorShapeProto with dim(2){size(1)}."""
    entry = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0}
    pos = 0
    while pos < len(value):
        tag, pos = _varint(value, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _varint(value, pos)
            if field == 1:
                entry["dtype"] = v
            elif field == 3:
                entry["shard_id"] = v
            elif field == 4:
                entry["offset"] = v
            elif field == 5:
                entry["size"] = v
        elif wire == 2:
            ln, pos = _varint(value, pos)
            sub = value[pos : pos + ln]
            pos += ln
            if field == 2:
                entry["shape"] = _parse_shape(sub)
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
        else:
            break
    return entry


def _parse_shape(value: bytes) -> list[int]:
    dims: list[int] = []
    pos = 0
    while pos < len(value):
        tag, pos = _varint(value, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            ln, pos = _varint(value, pos)
            sub = value[pos : pos + ln]
            pos += ln
            if field == 2:  # dim
                dpos = 0
                size = None
                while dpos < len(sub):
                    dtag, dpos = _varint(sub, dpos)
                    dfield, dwire = dtag >> 3, dtag & 7
                    if dwire == 0:
                        v, dpos = _varint(sub, dpos)
                        if dfield == 1:
                            size = v
                    elif dwire == 2:
                        dln, dpos = _varint(sub, dpos)
                        dpos += dln
                if size is not None:
                    dims.append(size)
        elif wire == 0:
            _, pos = _varint(value, pos)
    return dims


def _snappy_decompress(data: bytes) -> bytes:
    """Minimal snappy raw-format decompressor."""
    out = bytearray()
    pos = 0
    _, pos = _varint(data, pos)  # uncompressed length
    while pos < len(data):
        tag = data[pos]
        pos += 1
        elem_type = tag & 3
        if elem_type == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            out += data[pos : pos + length]
            pos += length
        else:
            if elem_type == 1:
                length = ((tag >> 2) & 7) + 4
                offset = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif elem_type == 2:
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:
                length = (tag >> 2) + 1
                offset = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            start = len(out) - offset
            for i in range(length):
                out.append(out[start + i])
    return bytes(out)
