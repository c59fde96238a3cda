"""zarr v2 arrays over a key-value store: an ``OcdbtStore`` (orbax's
``use_ocdbt: true`` layout) or a plain directory (``DirectoryStore``, the
``use_ocdbt: false`` layout). numpy and the system's ``libzstd`` only.

An array ``<name>`` is ``<name>/.zarray`` (JSON: ``zarr_format`` 2, ``shape``,
``chunks``, ``dtype``, ``order``, ``fill_value``, ``compressor``,
``filters``, ``dimension_separator``) and one value a chunk, keyed by the
chunk's grid indices joined by the separator (``0.0``; ``0`` for a 0-d array).
A chunk holds ``prod(chunks)`` elements in C order, edge chunks too; a chunk
that is absent reads as ``fill_value`` (null: zeros). The compressor is
``zstd`` or null; anything else, and any filter, raises by name.

Dtypes are numpy's strings (``<f4``, ``<f8``, ``<i4``, ``<i8``, ``|b1``,
``<u4``, ...) and ``bfloat16``, which numpy lacks (and the card has no
``ml_dtypes``): a bfloat16 array is read as ``<u2`` and widened exactly to
float32, its bits in the upper half of each float32.
"""

from __future__ import annotations

import itertools
import json
import math
from pathlib import Path

import numpy as np

from . import zstd

BFLOAT16 = "bfloat16"


class DirectoryStore:
    """Keys as relative paths of files under ``root``."""

    def __init__(self, root):
        self.root = Path(root)

    def buffer(self, key: str):
        path = self.root / key
        return np.fromfile(path, np.uint8) if path.is_file() else None

    def read(self, key: str) -> bytes | None:
        value = self.buffer(key)
        return None if value is None else value.tobytes()


def _fill(meta: dict):
    """zarr v2's ``fill_value``: null, a number, or "NaN"/"Infinity"/"-Infinity" for floats."""
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


def read_array(store, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store`` as a C-ordered numpy array
    (bfloat16 widened to float32)."""
    raw = store.read(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"{name}: no {name}/.zarray in the store")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}; this reader takes zarr v2")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: order {meta['order']!r}; this reader takes C order")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {[f.get('id') for f in meta['filters']]} are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor.get('id')!r}; this reader decodes zstd or none")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    bf16 = meta["dtype"] == BFLOAT16
    stored = np.dtype("<u2" if bf16 else meta["dtype"])
    sep = meta.get("dimension_separator", ".")

    def chunk(index: tuple[int, ...]) -> np.ndarray | None:
        data = store.buffer(f"{name}/{sep.join(map(str, index)) if index else 0}")
        if data is None:
            return None
        out = np.empty(chunks, stored)
        if compressor is None:
            if len(data) != out.nbytes:
                raise ValueError(f"{name}: chunk {index} holds {len(data)} bytes, expected {out.nbytes}")
            out.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
        else:
            zstd.decompress_into(data, out)
        return out

    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    if shape == chunks:  # one chunk holds the array: decoded in place
        out = chunk(tuple(0 for _ in shape))
        if out is None:
            out = np.full(shape, _fill(meta), stored)
    else:
        out = np.full(shape, _fill(meta), stored)
        for index in itertools.product(*map(range, grid)):
            part = chunk(index)
            if part is not None:
                region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
                out[region] = part[tuple(slice(0, r.stop - r.start) for r in region)]
    out = out.astype(stored.newbyteorder("="), copy=False)
    if bf16:
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out
