"""The JAX package's orbax trees, read without orbax, tensorstore, ml_dtypes
or JAX: the port of its ``checkpoint/orbax_io.py:restore_pytree`` (:26-35)
called without ``like``, as every JAX script calls it on a checkpoint
directory (``step_<N>``, ``state_<N>``, ``best``, ``student_final``).

``_METADATA`` (JSON) lists each leaf under ``tree_metadata``: its keys
(``key_metadata``, ``key_type`` 2 a dict key, 1 a sequence index, kept as a
string) and its ``value_metadata.value_type``. An array leaf (``np.ndarray``,
``jax.Array``) is the zarr v2 array named by its keys joined with ``.``
(``zarr.py``), in the OCDBT store under the directory (``ocdbt.py``) where
``use_ocdbt`` is true, else in the directory's files; ``scalar`` is a Python
int or float; ``None``/``Dict``/``List``/``Tuple``/``NamedTuple`` are the
empty values orbax restores for them (``None``, ``{}``, ``[]``, ``()``,
``None``). Containers come back as orbax rebuilds them without a target:
dicts for dict keys (a NamedTuple's fields too) and lists for indices (a
tuple too). Leaves are numpy arrays; bfloat16 leaves come back widened to
float32. A zarr3 tree (``use_zarr3``) raises.

Writing orbax is out of scope: the port writes npz trees (``npz.py``),
which the JAX package's ``load_npz`` reads.
"""

from __future__ import annotations

import json
from pathlib import Path

from .ocdbt import MANIFEST, OcdbtStore
from .zarr import DirectoryStore, read_array

METADATA = "_METADATA"
SEQUENCE_KEY = 1  # key_type of an index (2: a dict key)
ARRAY_TYPES = ("np.ndarray", "jax.Array")
EMPTY_VALUES = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple, "NamedTuple": lambda: None}


def is_orbax_dir(path) -> bool:
    return (Path(path) / METADATA).is_file()


def _store(path: Path, meta: dict):
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: use_zarr3 is true; this reader takes the zarr v2 trees orbax writes by default")
    if meta.get("use_ocdbt", True):
        if not (path / MANIFEST).is_file():
            raise ValueError(f"{path}: use_ocdbt is true but there is no {MANIFEST}")
        return OcdbtStore(path)
    return DirectoryStore(path)


def _build(node: dict):
    """A node of ``{key: child}`` dicts whose keys say their container ->
    dicts and lists."""
    if not isinstance(node, _Node):
        return node
    if node.kind == SEQUENCE_KEY:
        order = sorted(node, key=int)
        if [int(k) for k in order] != list(range(len(order))):
            raise ValueError(f"the indices {order} of a sequence are not 0..{len(order) - 1}")
        return [_build(node[k]) for k in order]
    return {k: _build(v) for k, v in node.items()}


class _Node(dict):
    def __init__(self, kind: int):
        super().__init__()
        self.kind = kind


def restore_pytree(path):
    """The tree of the orbax checkpoint directory ``path`` (numpy leaves)."""
    path = Path(path)
    if not is_orbax_dir(path):
        raise ValueError(f"{path}: a directory without {METADATA}, not an orbax checkpoint")
    meta = json.loads((path / METADATA).read_text())
    store = _store(path, meta)
    entries = meta["tree_metadata"]
    if not entries:
        return {}
    root = None
    for entry in entries.values():
        keys = entry["key_metadata"]
        value_type = entry["value_metadata"]["value_type"]
        if value_type in ARRAY_TYPES or value_type == "scalar":
            value = read_array(store, ".".join(str(k["key"]) for k in keys))
            if value_type == "scalar":
                value = value.item()
        elif value_type in EMPTY_VALUES:
            value = EMPTY_VALUES[value_type]()
        else:
            raise ValueError(f"{path}: leaf {[k['key'] for k in keys]} has value type {value_type!r}, "
                             "which this reader does not restore")
        if not keys:
            return value
        if root is None:
            root = _Node(keys[0]["key_type"])
        node = root
        for i, key in enumerate(keys):
            if node.kind != key["key_type"]:
                raise ValueError(f"{path}: {[k['key'] for k in keys[:i + 1]]} mixes dict keys and indices")
            if i + 1 == len(keys):
                node[str(key["key"])] = value
            else:
                node = node.setdefault(str(key["key"]), _Node(keys[i + 1]["key_type"]))
    return _build(root)
