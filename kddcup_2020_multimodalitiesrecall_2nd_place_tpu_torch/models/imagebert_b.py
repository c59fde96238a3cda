"""ImageBERT-B/C: single-stream 30-token AM-softmax scorer (``imagebert_zk``),
the port of the JAX package's ``models/imagebert_b.py``.

Image token = label path + box path + feature path (``model_triple.py:189-195``):

* label path: shared word-embedding lookup of the [10, 8] label ids, then a
  SAME-padded [1, 8] conv with 768 output channels and **ReLU**
  (``kdd_conv1``), then the mean over the 8-token axis;
* box path: 5 -> 768 linear, no activation (``kdd_dense1``);
* feature path: 1x1 conv 2048 -> 768 with **ReLU** (``kdd_conv2``).

Their sum passes one more 768 -> 768 linear (``kdd_featureemb``). Text and
image embeddings are concatenated BEFORE the embedding LayerNorm (unlike
ImageBERT-A): token-type embeddings cover all 30 positions (segment ids
[0]*20 + [1]*10) and position ids are [0..19] + [20]*10, every box at 20
(``pixelbert.py:580-581, 613-617``). Key masks from len_query/num_boxes
(``model_triple.py:198-201``). Head: AM-softmax with the fed label (the
scorers feed 1), score = probs[:, 1].

The encoder runs at S=30. The JAX package pads to S=32 for the TPU's
sublane tiling (its ``:145-152``); its two padded keys carry -10000, whose
softmax weight is exactly 0 in f32, and nothing reads their rows, so the two
agree to summation order. ImageBERT-C is this model with the sen2forest
query rewrite in the data layer (``Featurizer(sen2forest=True)``).

The label conv is one banded [8H, 8H] product, as the JAX package computes
it (:77-107): out[., w, :] = sum_t emb[., t, :] @ W[t - w + 3]. The band
(75 MB in bf16) is built once, when the parameters are made or loaded
(``label_conv_band``), and stored as ``kdd_conv1``'s ``kernel``, with the
conv bias tiled over the 8 outputs as its ``bias``; in bf16 on the card the
product is ``gemm_bf16``'s "f32" epilogue (bf16 in, f32 accumulation and out,
the JAX dot's rounding), under every attention backend, as the JAX package's
one dot is; in f32 it is the plain f32 product.
"""

from __future__ import annotations

import torch

from ..data.tsv import MAX_BOXES, MAX_LABEL_TOKENS, MAX_QUERY_LEN_AB
from ..ops.attention import mask_to_bias
from ..ops.kernels import gemm_plain
from . import heads
from .core import (
    KERNEL_BLOCKS,
    BertConfig,
    Blocks,
    Params,
    Precision,
    dense,
    dense_init,
    embeddings_init,
    encoder,
    encoder_init,
    layer_norm,
    pooler,
    trunc_normal,
)

TEXT_LEN = MAX_QUERY_LEN_AB  # 20
SEQ_LEN = TEXT_LEN + MAX_BOXES  # 30
BOX_POSITION_ID = 20
FEATURE_DIM = 2048
CONV_TAPS = MAX_LABEL_TOKENS  # 8: kernel width = label tokens a box
CONV_LEFT = 3  # TF SAME padding of an 8-wide kernel over 8 tokens: 3 left, 4 right
# the batch entries the model reads; the engine moves only these to the device
INPUT_KEYS = ("input_ids", "len_query", "num_boxes", "segment_ids", "boxes", "features", "label_ids", "labels")
# every matmul kernel of the tree, cast once to the compute dtype (checkpoint/npz.py); the AM
# head's am_kernel stays f32, as the JAX head runs at HIGHEST precision
MATMUL_KERNELS = (
    ("bert", "encoder", "attention", "qkv"),
    ("bert", "encoder", "attention", "output", "dense"),
    ("bert", "encoder", "ffn", "intermediate"),
    ("bert", "encoder", "ffn", "output", "dense"),
    ("bert", "pooler", "dense"),
    ("kdd_conv1",),
    ("kdd_dense1",),
    ("kdd_conv2",),
    ("kdd_featureemb",),
)


def label_conv_band(weights: torch.Tensor, biases: torch.Tensor) -> Params:
    """kdd_conv1's taps [8, H_in, H_out] and bias [H_out] -> the banded
    ``kernel`` [8 H_in, 8 H_out] (rows (t, h_in), columns (w, h_out); block
    (t, w) is tap t - w + 3, or zero outside the kernel) and the bias tiled
    over the 8 output positions, ``bias`` [8 H_out]."""
    taps, h_in, h_out = weights.shape
    band = torch.zeros(CONV_TAPS, h_in, CONV_TAPS, h_out, dtype=weights.dtype)
    for w in range(CONV_TAPS):
        for t in range(CONV_TAPS):
            if 0 <= t - w + CONV_LEFT < taps:
                band[t, :, w, :] = weights[t - w + CONV_LEFT]
    return {"kernel": band.reshape(CONV_TAPS * h_in, CONV_TAPS * h_out),
            "bias": biases.repeat(CONV_TAPS)}


def from_jax(params: Params) -> Params:
    """``checkpoint.params_from_jax``'s output for a B tree -> the port's
    layout: kdd_conv1's taps (``weights``/``biases``) banded once, stored as
    the ``kernel``/``bias`` that ``cast_matmul_weights`` casts like any dense."""
    conv = params["kdd_conv1"]
    return {**params, "kdd_conv1": label_conv_band(conv["weights"], conv["biases"])}


def init_params(cfg: BertConfig, gen: torch.Generator) -> Params:
    """Random parameters in the port's layout, drawn from ``gen``."""
    h, std = cfg.hidden_size, cfg.initializer_range
    return {
        "bert": {
            "embeddings": embeddings_init(cfg, gen),
            "encoder": encoder_init(cfg, gen),
            "pooler": {"dense": dense_init(h, h, std, gen)},
        },
        "kdd_conv1": label_conv_band(trunc_normal((CONV_TAPS, h, h), 0.02, gen), torch.zeros(h)),
        "kdd_dense1": dense_init(5, h, std, gen),
        "kdd_conv2": dense_init(FEATURE_DIM, h, std, gen),
        "kdd_featureemb": dense_init(h, h, std, gen),
        "cls": {"seq_relationship": heads.am_head_init(cfg, gen)},
    }


def _label_conv(p: Params, emb: torch.Tensor, prec: Precision, blocks: Blocks = KERNEL_BLOCKS) -> torch.Tensor:
    """SAME-padded width-8 conv over the label-token axis, ReLU, then the
    mean: emb [B, 10, 8, H] -> [B, 10, H], through the banded kernel:
    ``blocks.gemm`` in bf16, the plain f32 product in f32 (``gemm_bf16``
    multiplies bf16 only)."""
    b, n, t, h = emb.shape
    x2 = emb.to(prec.compute_dtype).reshape(b * n, t * h).contiguous()
    gemm = blocks.gemm if prec.compute_dtype == torch.bfloat16 else gemm_plain
    out = gemm(x2, p["kernel"], p["bias"], "f32").reshape(b, n, t, -1)
    return torch.relu(out).mean(dim=2)


def image_tokens(p: Params, batch: dict, prec: Precision, blocks: Blocks = KERNEL_BLOCKS) -> torch.Tensor:
    """-> [B, 10, H] f32 image token embeddings before kdd_featureemb."""
    table = p["bert"]["embeddings"]["word_embeddings"]
    lab = _label_conv(p["kdd_conv1"], table[batch["label_ids"].long()], prec, blocks)
    box = dense(p["kdd_dense1"], batch["boxes"], prec)
    feat = torch.relu(dense(p["kdd_conv2"], batch["features"], prec))
    return lab + box + feat


def input_mask(batch: dict) -> torch.Tensor:
    """[B, 30] keep-mask: sequence_mask(len_query, 20) ++ sequence_mask(num_boxes, 10)."""
    dev = batch["len_query"].device
    q = torch.arange(TEXT_LEN, device=dev)[None, :] < batch["len_query"][:, None]
    b = torch.arange(MAX_BOXES, device=dev)[None, :] < batch["num_boxes"][:, None]
    return torch.cat([q, b], dim=1).to(torch.int32)


def embed(p: Params, batch: dict, cfg: BertConfig, prec: Precision, blocks: Blocks = KERNEL_BLOCKS) -> torch.Tensor:
    """-> [B, 30, H] float32 transformer input."""
    emb = p["bert"]["embeddings"]
    img = dense(p["kdd_featureemb"], image_tokens(p, batch, prec, blocks), prec)
    text = emb["word_embeddings"][batch["input_ids"].long()]
    x = torch.cat([text.float(), img.float()], dim=1)
    x = x + emb["token_type_embeddings"][batch["segment_ids"].long()]
    positions = torch.cat([torch.arange(TEXT_LEN), torch.full((MAX_BOXES,), BOX_POSITION_ID)])
    x = x + emb["position_embeddings"][positions.to(x.device)][None]
    return layer_norm(emb["LayerNorm"], x)


def apply(p: Params, batch: dict, cfg: BertConfig, prec: Precision | None = None,
          blocks: Blocks = KERNEL_BLOCKS) -> dict:
    """Inference forward pass (dropout off). ``blocks`` picks the layer and
    label-conv functions: the kernel wrappers, or the plain oracles."""
    prec = prec if prec is not None else Precision.f32()
    x = embed(p, batch, cfg, prec, blocks)
    bias = mask_to_bias(input_mask(batch))  # [B, 30] key-mask rows
    seq = encoder(p["bert"]["encoder"], x, bias, cfg, prec, blocks)
    pooled = pooler(p["bert"]["pooler"], seq, prec)
    probs = heads.am_probs(p["cls"]["seq_relationship"], pooled, batch["labels"])
    return {"sequence": seq, "pooled": pooled, "probs": probs, "score": probs[:, 1]}


def score(p: Params, batch: dict, cfg: BertConfig, prec: Precision | None = None,
          blocks: Blocks = KERNEL_BLOCKS) -> torch.Tensor:
    return apply(p, batch, cfg, prec, blocks)["score"]
