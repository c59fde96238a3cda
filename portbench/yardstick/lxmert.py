"""LXMERT's part of the yardstick: its batches made in host memory, its random
weights and the work of scoring it.

* Batches: the queries, box counts, labels and f32 features that ``staged.py``
  draws for ImageBERT-A from the same seed (the same draws in the same
  order), then each box's corners, laid out as LXMERT's featurizer lays them
  out (``data/featurize.py:lxmert``): 23 query ids and their ``input_mask``,
  the 10 x 8 label ids, 4-d boxes normalised to [0, 1] by the image's height
  and width, the features zero-padded and ``feats_mask`` from the box count.
* Weights: every leaf of the scoring tree of the port's ``ModelSpec`` drawn
  from the seed in one call on the device (``weights.py``'s rules), and the
  two fused forms of ``visual_attention`` (``kv``, ``qkv``) built from its
  drawn ``query``, ``key`` and ``value``, as the port's init builds them.
* Work: the 9 language and 5 relational layers, the visual encoder, both
  directions of each of the 5 cross layers (Sq != Sk: q from one stream, k
  and v from the other) and the self-attention and FFN layers of both
  streams after them, the pooler and the two-layer head.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from . import weights
from . import work as yardwork
from .packed import spread
from .testb import FEATURE_DIM, LABEL_TEXTS, query_text

QUERY_LEN, BOXES, LABEL_TOKENS, BOX_DIM = 23, 10, 8, 4
DEPTHS = ("l_layers", "r_layers", "x_layers")
IMAGE_H, IMAGE_W = 800, 600
INPUT_KEYS = ("input_ids", "input_mask", "label_ids", "boxes", "features", "feats_mask")


def dims(cfg: dict) -> dict:
    """The configuration's ``bert`` widths with its depths; a depth given in ``bert`` wins (a test's cut)."""
    return {**{k: cfg[k] for k in DEPTHS}, **cfg["bert"]}


def make_batches(traffic: dict, seed: int, query_ids, label_lut) -> list[dict]:
    """``query_ids``: text -> [CLS] + pieces + [SEP] ids; ``label_lut``: [labels, 8] ids."""
    n_batches, size = int(traffic["batches"]), int(traffic["batch_size"])
    n = n_batches * size
    rng = np.random.default_rng(seed)
    n_q = max(1, round(n / traffic["pairs_per_query"]))
    qid = rng.permutation(np.arange(n) * n_q // n)
    ids = np.zeros((n_q, QUERY_LEN), np.int32)
    lens = np.zeros(n_q, np.int32)
    for q in range(n_q):
        row = query_ids(query_text(q))[:QUERY_LEN]
        ids[q, : len(row)] = row
        lens[q] = len(row)
    mask = (np.arange(QUERY_LEN)[None, :] < lens[:, None]).astype(np.int32)
    boxes = rng.permutation(spread(n, int(traffic["min_boxes"]), int(traffic["max_boxes"])))
    valid = np.arange(BOXES)[None, :] < boxes[:, None]
    feats = rng.standard_normal((n, BOXES, FEATURE_DIM), dtype=np.float32)
    feats *= valid[..., None]
    labels = rng.integers(0, len(LABEL_TEXTS), size=(n, BOXES))
    label_ids = (label_lut[labels] * valid[..., None]).astype(np.int32)
    pid = 400000 + rng.permutation(n)
    # the corners as the TSV's generator draws them (y1, x1, y2, x2), over the image's height and width
    y1 = rng.uniform(0, IMAGE_H / 2, size=(n, BOXES))
    x1 = rng.uniform(0, IMAGE_W / 2, size=(n, BOXES))
    y2 = y1 + rng.uniform(1, IMAGE_H / 2, size=(n, BOXES))
    x2 = x1 + rng.uniform(1, IMAGE_W / 2, size=(n, BOXES))
    corners = np.stack([y1 / IMAGE_H, x1 / IMAGE_W, y2 / IMAGE_H, x2 / IMAGE_W], axis=-1)
    corners = (corners * valid[..., None]).astype(np.float32)
    feats_mask = valid.astype(np.float32)
    out = []
    for b in range(n_batches):
        s = slice(b * size, (b + 1) * size)
        q = qid[s]
        out.append({"input_ids": ids[q], "input_mask": mask[q], "label_ids": label_ids[s], "boxes": corners[s],
                    "features": feats[s], "feats_mask": feats_mask[s], "labels": np.ones(size, np.int32),
                    "product_id": pid[s].astype(np.int64), "query_id": q.astype(np.int64),
                    "valid": np.ones(size, np.bool_)})
    return out


def _dense(d_in: int, d_out: int, lead=()) -> dict:
    return {"kernel": (*lead, d_in, d_out), "bias": (*lead, d_out)}


def _ln(dim: int, lead=()) -> dict:
    return {"gamma": (*lead, dim), "beta": (*lead, dim)}


def _layers(c: dict, n: int) -> dict:
    h, i = c["hidden_size"], c["intermediate_size"]
    lead = (n,)
    return {"attention": {"qkv": _dense(h, 3 * h, lead),
                          "output": {"dense": _dense(h, h, lead), "LayerNorm": _ln(h, lead)}},
            "ffn": {"intermediate": _dense(h, i, lead),
                    "output": {"dense": _dense(i, h, lead), "LayerNorm": _ln(h, lead)}}}


def shapes(c: dict) -> dict:
    """The scoring tree's leaves (no MLM head, no AM head), ``visual_attention`` as query, key, value."""
    h, n = c["hidden_size"], c["x_layers"]
    lang, visn = _layers(c, n), _layers(c, n)
    va = {name: _dense(h, h, (n,)) for name in ("query", "key", "value")}
    va["output"] = {"dense": _dense(h, h, (n,)), "LayerNorm": _ln(h, (n,))}
    return {
        "bert": {
            "embeddings": {"word_embeddings": (c["vocab_size"], h), "token_type_embeddings": (c["type_vocab_size"], h),
                           "position_embeddings": (c["max_position_embeddings"], h), "LayerNorm": _ln(h)},
            "encoder": {
                "layer": _layers(c, c["l_layers"]),
                "r_layers": _layers(c, c["r_layers"]),
                "x_layers": {"visual_attention": va, "lang_self_att": lang["attention"],
                             "visn_self_att": visn["attention"], "lang_ffn": lang["ffn"], "visn_ffn": visn["ffn"]},
                "visn_fc": {"visn_fc": _dense(FEATURE_DIM, h), "visn_layer_norm": _ln(h),
                            "box_fc": _dense(BOX_DIM, h), "box_layer_norm": _ln(h),
                            "label_conv": {"weights": (LABEL_TOKENS,), "biases": (1,)},
                            "label_fc": _dense(h, h), "label_layer_norm": _ln(h)},
            },
            "pooler": {"dense": _dense(h, h)},
        },
        "logit_fc": {"fc1": _dense(h, 2 * h), "LayerNorm": _ln(2 * h), "fc2": _dense(2 * h, 2)},
    }


def make_weights(c: dict, seed: int, device) -> dict:
    """-> the nested dict of f32 leaves on ``device``, drawn from ``seed`` (``weights.make_weights``' rules);
    ``visual_attention`` in the port's forms: ``query``, ``kv`` = [key | value], ``qkv`` = [query | key | value]."""
    leaves = list(weights._leaves(shapes(c)))
    sizes = [torch.Size(s).numel() for _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    out: dict = {}
    for (path, shape), part in zip(leaves, torch.split(flat, sizes)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (1.0 + weights.STD * part if path[-1] == "gamma" else weights.STD * part).reshape(shape)
    va = out["bert"]["encoder"]["x_layers"]["visual_attention"]
    q, k, v = va["query"], va.pop("key"), va.pop("value")
    va["kv"] = {n: torch.cat([k[n], v[n]], dim=-1) for n in ("kernel", "bias")}
    va["qkv"] = {n: torch.cat([q[n], k[n], v[n]], dim=-1) for n in ("kernel", "bias")}
    return out


def cross_attention(pairs: int, sq: int, sk: int, c: dict) -> dict:
    """One cross block over ``pairs`` pairs, q from the [sq, h] stream, k and v from the [sk, h] one, the keys
    masked: -> {"gemm": [q, kv, o], "attention": [core]}. The core reads q [sq, h] and kv [sk, 2h] and the
    [sk] f32 key mask, and writes ctx [sq, h]."""
    h = c["hidden_size"]
    core = (4 * pairs * sq * sk * h,
            pairs * (sq * h * yardwork.BF16 + sk * 2 * h * yardwork.BF16 + sq * h * yardwork.BF16 + sk * yardwork.F32))
    return {"gemm": [yardwork.gemm(pairs * sq, h, h), yardwork.gemm(pairs * sk, h, 2 * h),
                     yardwork.gemm(pairs * sq, h, h)],
            "attention": [core]}


def _layer(out: dict, pairs: int, s: int, c: dict) -> None:
    out["gemm"] += [yardwork.gemm(m, k, n) for m, k, n in yardwork._encoder_sites(pairs * s, c)]
    out["attention"].append(yardwork.attention_forward(pairs, c["num_attention_heads"], s, c["hidden_size"],
                                                       masked=True))


def score(batch_rows: list[int], c: dict) -> dict:
    """-> {"gemm": [(flops, bytes)], "attention": [...], "model_flops": N} of scoring batches of
    ``batch_rows`` pairs each (``c``: ``dims`` of the configuration)."""
    out = defaultdict(list)
    h, f32 = c["hidden_size"], yardwork.F32
    for pairs in batch_rows:
        for _ in range(c["l_layers"]):
            _layer(out, pairs, QUERY_LEN, c)
        for _ in range(c["r_layers"]):
            _layer(out, pairs, BOXES, c)
        for _ in range(c["x_layers"]):
            for sq, sk in ((QUERY_LEN, BOXES), (BOXES, QUERY_LEN)):
                for cls, ops in cross_attention(pairs, sq, sk, c).items():
                    out[cls] += ops
            _layer(out, pairs, QUERY_LEN, c)
            _layer(out, pairs, BOXES, c)
        boxes = pairs * BOXES
        # the visual encoder's three denses, the pooler and the head's two, f32 out
        sites = [(boxes, FEATURE_DIM, h), (boxes, BOX_DIM, h), (boxes, h, h), (pairs, h, h), (pairs, h, 2 * h),
                 (pairs, 2 * h, 2)]
        out["gemm"] += [yardwork.gemm(m, k, n, out_bytes=f32) for m, k, n in sites]
    return {**out, "model_flops": sum(f for ops in out.values() for f, _ in ops)}
