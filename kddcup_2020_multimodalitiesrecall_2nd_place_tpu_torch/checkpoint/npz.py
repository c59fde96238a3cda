"""Parameters from the JAX package's npz trees, prepared for the port.

* ``flatten_tree`` / ``unflatten_tree`` / ``load_npz``: the port's own copy
  of the flat ``a/b/c``-keyed npz interchange of the JAX package
  (``checkpoint/orbax_io.py`` :37-64).
* ``params_from_jax``: a tree of numpy arrays in the JAX layout -> float32
  torch tensors, with each layer's query/key/value fused ONCE into
  ``attention/qkv`` [H, 3H] (the JAX package concatenates them on every call,
  ``models/core.py`` :293-299).
* ``cast_matmul_weights``: one cast of every matmul kernel to the compute
  dtype (bf16 for the CUDA kernels); biases, LayerNorm, embedding tables and
  the head stay float32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.core import Params


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def unflatten_tree(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_npz(path, tree) -> None:
    np.savez(path, **flatten_tree(tree))


def load_npz(path) -> dict:
    with np.load(Path(path)) as data:
        return unflatten_tree({k: data[k] for k in data.files})


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _fuse_qkv(att: dict) -> dict:
    """query/key/value dense params -> one ``qkv`` dense, over the last axis."""
    parts = [att[n] for n in ("query", "key", "value")]
    fused = {
        "kernel": torch.cat([p["kernel"] for p in parts], dim=-1),
        "bias": torch.cat([p["bias"] for p in parts], dim=-1),
    }
    return {"qkv": fused, **{k: v for k, v in att.items() if k not in ("query", "key", "value")}}


def params_from_jax(tree: dict) -> Params:
    """JAX ImageBERT-A param tree (numpy leaves) -> the port's float32 params.

    Leaves the JAX apply never reads for scoring (the MLM head) are dropped."""
    params = _to_torch(tree)
    enc = params["bert"]["encoder"]
    enc["attention"] = _fuse_qkv(enc["attention"])
    params["cls"] = {"seq_relationship": params["cls"]["seq_relationship"]}
    return params


MATMUL_KERNELS = (
    ("bert", "encoder", "attention", "qkv"),
    ("bert", "encoder", "attention", "output", "dense"),
    ("bert", "encoder", "ffn", "intermediate"),
    ("bert", "encoder", "ffn", "output", "dense"),
    ("bert", "pooler", "dense"),
    ("featureemb",),
)


def cast_matmul_weights(params: Params, dtype: torch.dtype) -> Params:
    """A copy of ``params`` whose matmul kernels are ``dtype``; every other
    leaf is shared with the input."""
    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v for k, v in tree.items()}

    out = copy(params)
    for path in MATMUL_KERNELS:
        node = out
        for key in path:
            node = node[key]
        node["kernel"] = node["kernel"].to(dtype)
    return out


def tree_to(params: Params, device) -> Params:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in params.items()}
