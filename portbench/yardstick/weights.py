"""Random weights of a configuration, drawn on the device from the seed in one
call, in the tree layout of the port's ``ModelSpec.init_params`` (ImageBERT-A),
or of the tree a trainer holds (ImageBERT-B: ``kdd_conv1`` as its 8 taps).

Every leaf is random, biases and LayerNorm parameters included (gamma about
1), so no term of the model can be dropped unseen. Normals are cut at two
standard deviations, as the init's truncated normal is.
"""

from __future__ import annotations

import torch

STD = 0.02
FEATURE_DIM = 2048
LABEL_TOKENS = 8
CONV_LEFT = 3


def _encoder(c: dict) -> dict:
    h, i, n = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    ln = {"gamma": (n, h), "beta": (n, h)}
    return {
        "attention": {"qkv": {"kernel": (n, h, 3 * h), "bias": (n, 3 * h)},
                      "output": {"dense": {"kernel": (n, h, h), "bias": (n, h)}, "LayerNorm": dict(ln)}},
        "ffn": {"intermediate": {"kernel": (n, h, i), "bias": (n, i)},
                "output": {"dense": {"kernel": (n, i, h), "bias": (n, h)}, "LayerNorm": dict(ln)}},
    }


def shapes(model: str, c: dict) -> dict:
    h = c["hidden_size"]
    emb = {"word_embeddings": (c["vocab_size"], h), "token_type_embeddings": (c["type_vocab_size"], h),
           "position_embeddings": (c["max_position_embeddings"], h), "LayerNorm": {"gamma": (h,), "beta": (h,)}}
    bert = {"embeddings": emb, "encoder": _encoder(c), "pooler": {"dense": {"kernel": (h, h), "bias": (h,)}}}
    if model == "imagebert_a":
        emb["word_embeddings_labelembedding"] = (LABEL_TOKENS, 1)
        return {"bert": bert, "featureemb": {"kernel": (FEATURE_DIM, h), "bias": (h,)},
                "cls": {"seq_relationship": {"output_weights": (2, h), "output_bias": (2,)}}}
    if model == "imagebert_b":
        return {"bert": bert, "kdd_conv1": {"weights": (LABEL_TOKENS, h, h), "biases": (h,)},
                "kdd_dense1": {"kernel": (5, h), "bias": (h,)}, "kdd_conv2": {"kernel": (FEATURE_DIM, h), "bias": (h,)},
                "kdd_featureemb": {"kernel": (h, h), "bias": (h,)}, "cls": {"seq_relationship": {"am_kernel": (h, 2)}}}
    raise ValueError(f"no weights for model {model!r}")


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def make_weights(model: str, c: dict, seed: int, device) -> dict:
    """-> the nested dict of f32 leaves on ``device``, drawn from ``seed``."""
    leaves = list(_leaves(shapes(model, c)))
    sizes = [torch.Size(s).numel() for _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    out: dict = {}
    for (path, shape), part in zip(leaves, torch.split(flat, sizes)):
        name = path[-1]
        if name == "gamma":
            leaf = 1.0 + STD * part
        elif name == "am_kernel":
            leaf = (2.0 / (shape[0] + shape[1])) ** 0.5 * part  # xavier normal, as the head's init
        else:
            leaf = STD * part
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[name] = leaf.reshape(shape)
    return out


def conv_band(weights: torch.Tensor, left: int = CONV_LEFT) -> torch.Tensor:
    """Taps [T, H_in, H_out] -> the band [T H_in, T H_out] whose block (t, w) is tap t - w + left, or zero."""
    t, h_in, h_out = weights.shape
    band = weights.new_zeros(t, h_in, t, h_out)
    for i in range(t):
        for w in range(t):
            if 0 <= i - w + left < t:
                band[i, :, w, :] = weights[i - w + left]
    return band.reshape(t * h_in, t * h_out)


def banded(tree: dict) -> dict:
    """ImageBERT-B's tree with ``kdd_conv1`` as the band the port's spec holds (``init_params``' form)."""
    conv = tree["kdd_conv1"]
    return {**tree, "kdd_conv1": {"kernel": conv_band(conv["weights"]),
                                  "bias": conv["biases"].repeat(conv["weights"].shape[0])}}
