"""Parameters from the JAX package's npz trees, prepared for the port.

* ``flatten_tree`` / ``unflatten_tree`` / ``load_npz``: the port's own copy
  of the flat ``a/b/c``-keyed npz interchange of the JAX package
  (``checkpoint/orbax_io.py`` :37-64).
* ``params_from_jax``: an ImageBERT-A, ImageBERT-B/C, LXMERT or two-tower
  tree of numpy arrays in the JAX layout -> float32 torch tensors, with each
  attention's query/key/value fused ONCE (``models/core.py:attention_forms``;
  the JAX package concatenates them on every call, ``models/core.py``
  :293-299, :315-316, :400-401). Leaves a model stores in another form
  are left to its spec's ``from_jax`` (ImageBERT-B's label-conv band).
* ``params_to_jax``: the inverse for an ImageBERT-A, ImageBERT-B/C, LXMERT or
  two-tower tree: each fused ``qkv`` split back into query/key/value (LXMERT's
  ``visual_attention`` from its ``query`` and ``kv``, which training updates,
  never from ``qkv``), a banded ``kdd_conv1`` (ImageBERT-B's, the product
  tower's) back into its taps,
  numpy leaves, so ``save_npz`` writes a checkpoint that the port's
  ``cli/score.py`` and the JAX package's ``scripts/score.py`` both load.
* ``scoring_params``: a tree without the MLM head, which no scorer reads.
* ``cast_matmul_weights``: one cast of a model's matmul kernels (the spec's
  list) to the compute dtype (bf16 for the CUDA kernels); biases, LayerNorm,
  embedding tables and the heads' f32 weights stay as they are, and so do the
  int8 nodes of ``ops/quant.py`` (``kernel_q8`` and its f32 ``kernel_scale``).

An int8 tree (``ops/quant.py:quantize_dense_tree``) passes through
``params_from_jax`` and ``params_to_jax`` as a float tree does: its
``kernel_q8`` leaves stay int8 and an attention's q/k/v ``kernel_q8`` and
``kernel_scale`` are fused and split as its ``kernel`` and ``bias`` are.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..models.core import Params, attention_forms
from ..models.imagebert_b import label_conv_taps


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
    # a C-ordered copy: an importer's leaf may be a transposed view (torch's [out, in] weights), whose strides
    # would otherwise reach the kernels, which take contiguous weights; an int8 tree's kernel_q8 stays int8
    arr = np.asarray(tree)
    return torch.from_numpy(np.array(arr, dtype=np.int8 if arr.dtype == np.int8 else np.float32, order="C"))


# the two-tower tree's encoders: scan-stacked encoders of their own, beside ``bert/embeddings``
TOWER_ENCODERS = ("query_encoder", "product_encoder")


def params_from_jax(tree: dict) -> Params:
    """JAX ImageBERT-A, ImageBERT-B/C, LXMERT or two-tower param tree (numpy
    leaves) -> the port's float32 params; an LXMERT tree is told by its
    ``x_layers``, a two-tower tree by its ``query_encoder``. ``kdd_conv1``'s
    taps stay as in the JAX tree: the spec's ``from_jax`` bands them (the AM
    head's ``am_kernel`` stays f32).

    The MLM head ``cls/predictions`` is kept (the MLM loss of A and LXMERT
    trains it; ``scoring_params`` leaves it out; ImageBERT-B's ``from_jax``
    drops it), as are LXMERT's AM head ``logit_W`` and ImageBERT-B's
    word-match head ``kdd_query_match`` (``am_loss`` and the word-match loss
    train them). LXMERT's NSP head ``cls/seq_relationship``, which no loss or
    scorer of the port reads, is dropped."""
    params = _to_torch(tree)
    if TOWER_ENCODERS[0] in params:
        for name in TOWER_ENCODERS:
            params[name]["attention"] = attention_forms(params[name]["attention"])
        return params
    enc = params["bert"]["encoder"]
    if "x_layers" in enc:
        for stack in ("layer", "r_layers"):
            enc[stack]["attention"] = attention_forms(enc[stack]["attention"])
        xs = enc["x_layers"]
        # one module serves both cross directions: the cross route reads
        # query and kv, the dual route qkv
        xs["visual_attention"] = attention_forms(xs["visual_attention"], cross=True)
        for name in ("lang_self_att", "visn_self_att"):
            xs[name] = attention_forms(xs[name])
        out = {k: params[k] for k in ("bert", "logit_fc", "logit_W") if k in params}
        if "predictions" in params.get("cls", {}):
            out["cls"] = {"predictions": params["cls"]["predictions"]}
        return out
    enc["attention"] = attention_forms(enc["attention"])
    return params


def scoring_params(params: Params) -> Params:
    """``params`` without the MLM head (``cls/predictions``), which only the
    MLM loss reads: the tree a scorer holds and an export bakes in."""
    if "predictions" not in params.get("cls", {}):
        return params
    cls = {k: v for k, v in params["cls"].items() if k != "predictions"}
    out = {k: v for k, v in params.items() if k != "cls"}
    return {**out, "cls": cls} if cls else out


def _split_attention(att: dict) -> dict:
    """``attention_forms`` undone: query/key/value from ``query`` and ``kv``
    where the tree has them (a cross attention), else from ``qkv``."""
    out = {k: v for k, v in att.items() if k not in ("qkv", "query", "kv")}
    if "kv" in att:
        out["query"] = att["query"]
        fused, names = att["kv"], ("key", "value")
    else:
        fused, names = att["qkv"], ("query", "key", "value")
    for i, name in enumerate(names):
        out[name] = {k: np.split(v, len(names), axis=-1)[i] for k, v in fused.items()}
    return out


def params_to_jax(params: Params) -> dict:
    """The port's ImageBERT-A, ImageBERT-B/C, LXMERT or two-tower params (with or
    without LXMERT's ``visual_attention/qkv``; ``kdd_conv1`` banded or as taps) ->
    the JAX package's tree layout, numpy float32 leaves: the inverse of
    ``params_from_jax``. ``kdd_query_match`` and the AM head's f32
    ``am_kernel`` pass as they are."""
    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        t = tree.detach().cpu()
        return (t if t.dtype == torch.int8 else t.float()).numpy()

    if "kernel" in params.get("kdd_conv1", {}):
        params = {**params, "kdd_conv1": label_conv_taps(params["kdd_conv1"])}
    tree = to_numpy(params)
    if TOWER_ENCODERS[0] in tree:
        for name in TOWER_ENCODERS:
            tree[name]["attention"] = _split_attention(tree[name]["attention"])
        return tree
    enc = tree["bert"]["encoder"]
    if "x_layers" in enc:
        for stack in ("layer", "r_layers"):
            enc[stack]["attention"] = _split_attention(enc[stack]["attention"])
        xs = enc["x_layers"]
        for name in ("visual_attention", "lang_self_att", "visn_self_att"):
            xs[name] = _split_attention(xs[name])
        return tree
    enc["attention"] = _split_attention(enc["attention"])
    return tree


def cast_matmul_weights(params: Params, dtype: torch.dtype, paths) -> Params:
    """A copy of ``params`` whose matmul kernels, at ``paths`` (a model's
    ``MATMUL_KERNELS``), are ``dtype``; every other leaf is shared with the input."""
    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v for k, v in tree.items()}

    out = copy(params)
    for path in paths:
        node = out
        for key in path:
            node = node[key]
        if "kernel" in node:  # an int8 node (kernel_q8) keeps its int8 weights and f32 scales
            node["kernel"] = node["kernel"].to(dtype)
    return out


def tree_to(params: Params, device) -> Params:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in params.items()}
