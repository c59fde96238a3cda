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
it (:77-107): out[., w, :] = sum_t emb[., t, :] @ W[t - w + 3]
(``ops/band_conv.py``). To score, the band (75 MB in bf16) is built once,
when the parameters are made or loaded (``label_conv_band``), and stored as
``kdd_conv1``'s ``kernel``, with the conv bias tiled over the 8 outputs as its
``bias``; in bf16 on the card the product is ``gemm_bf16``'s "f32" epilogue
(bf16 in, f32 accumulation and out, the JAX dot's rounding), under every
attention backend, as the JAX package's one dot is; in f32 it is the plain
f32 product. To train, ``train_params`` turns the band back into its 8 taps
(``weights`` [8, H, H], ``biases`` [H], the JAX tree's leaves), which the
train blocks' ``band_conv`` bands on every step, so the band's zero blocks
stay zero and each tap's copies stay tied; ``eval_params`` bands them again.

Training (``apply(train=True)``, the JAX package's ``apply`` with an rng):
dropout on the whole 30-token embedding after its LayerNorm, and each layer's
(attention, FFN) seed pair for the train blocks, which take the key-mask rows
at S=30.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..data.tsv import MAX_BOXES, MAX_LABEL_TOKENS, MAX_QUERY_LEN_AB
from ..ops.attention import mask_to_bias
from ..ops.band_conv import band_taps, conv_band
from ..ops.kernels import gemm_plain
from . import heads
from .core import (
    KERNEL_BLOCKS,
    TRAIN_KERNEL_BLOCKS,
    BertConfig,
    Blocks,
    Params,
    Precision,
    TrainBlocks,
    block_seeds,
    dense,
    dense_init,
    dropout,
    embeddings_init,
    encoder,
    encoder_init,
    layer_norm,
    num_layers,
    pooler,
    token_type_embed,
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
    return {"kernel": conv_band(weights, CONV_LEFT), "bias": biases.repeat(CONV_TAPS)}


def label_conv_taps(conv: Params) -> Params:
    """``label_conv_band`` undone, bit for bit: tap k is block (k, 3) of the
    band, the bias its first H_out entries."""
    h_out = conv["bias"].shape[0] // CONV_TAPS
    return {"weights": band_taps(conv["kernel"], CONV_TAPS, CONV_LEFT), "biases": conv["bias"][:h_out]}


def from_jax(params: Params) -> Params:
    """``checkpoint.params_from_jax``'s output for a B tree -> the port's
    layout: kdd_conv1's taps (``weights``/``biases``) banded once, stored as
    the ``kernel``/``bias`` that ``cast_matmul_weights`` casts like any dense;
    an MLM head ``cls/predictions``, which no loss of B's reads, dropped."""
    conv = params["kdd_conv1"]
    return {**params, "cls": {"seq_relationship": params["cls"]["seq_relationship"]},
            "kdd_conv1": label_conv_band(conv["weights"], conv["biases"])}


def train_params(p: Params) -> Params:
    """The tree a trainer holds: ``kdd_conv1`` as its taps."""
    return {**p, "kdd_conv1": label_conv_taps(p["kdd_conv1"])}


def eval_params(p: Params) -> Params:
    """A trained tree with ``kdd_conv1`` banded again, the form that scores."""
    conv = p["kdd_conv1"]
    return {**p, "kdd_conv1": label_conv_band(conv["weights"].detach(), conv["biases"].detach())}


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


def _label_conv(p: Params, emb: torch.Tensor, prec: Precision,
                blocks: Blocks | TrainBlocks = KERNEL_BLOCKS) -> torch.Tensor:
    """SAME-padded width-8 conv over the label-token axis, ReLU, then the
    mean: emb [B, 10, 8, H] -> [B, 10, H]. Scoring (``blocks`` a ``Blocks``):
    the banded kernel through ``blocks.gemm`` in bf16, the plain f32 product
    in f32 (``gemm_bf16`` multiplies bf16 only). Training (a ``TrainBlocks``):
    ``blocks.band_conv`` on the taps."""
    b, n, t, h = emb.shape
    x2 = emb.to(prec.compute_dtype).reshape(b * n, t * h).contiguous()
    if isinstance(blocks, TrainBlocks):
        out = blocks.band_conv(x2, p["weights"], p["biases"], CONV_LEFT)
    else:
        gemm = blocks.gemm if prec.compute_dtype == torch.bfloat16 else gemm_plain
        out = gemm(x2, p["kernel"], p["bias"].float(), "f32")  # an f32 bias (bf16 in a cast_residual_bf16 tree)
    return torch.relu(out.reshape(b, n, t, -1)).mean(dim=2)


def image_tokens(p: Params, batch: dict, prec: Precision,
                 blocks: Blocks | TrainBlocks = KERNEL_BLOCKS) -> torch.Tensor:
    """-> [B, 10, H] f32 image token embeddings before kdd_featureemb."""
    table = p["bert"]["embeddings"]["word_embeddings"]
    lab = _label_conv(p["kdd_conv1"], F.embedding(batch["label_ids"].long(), table), prec, blocks)
    box = dense(p["kdd_dense1"], batch["boxes"], prec)
    feat = torch.relu(dense(p["kdd_conv2"], batch["features"], prec))
    return lab + box + feat


def input_mask(batch: dict) -> torch.Tensor:
    """[B, 30] keep-mask: sequence_mask(len_query, 20) ++ sequence_mask(num_boxes, 10)."""
    dev = batch["len_query"].device
    q = torch.arange(TEXT_LEN, device=dev)[None, :] < batch["len_query"][:, None]
    b = torch.arange(MAX_BOXES, device=dev)[None, :] < batch["num_boxes"][:, None]
    return torch.cat([q, b], dim=1).to(torch.int32)


def embed(p: Params, batch: dict, cfg: BertConfig, prec: Precision, blocks: Blocks | TrainBlocks = KERNEL_BLOCKS,
          gen: torch.Generator | None = None) -> torch.Tensor:
    """-> [B, 30, H] float32 transformer input; with ``gen``, hidden dropout
    on all 30 tokens after the LayerNorm (the JAX package's :139-141)."""
    emb = p["bert"]["embeddings"]
    img = dense(p["kdd_featureemb"], image_tokens(p, batch, prec, blocks), prec)
    # F.embedding, not indexing: the same gather, and a backward that sums duplicate ids in one sorted pass
    text = F.embedding(batch["input_ids"].long(), emb["word_embeddings"])
    x = torch.cat([text.float(), img.float()], dim=1)
    x = x + token_type_embed(emb["token_type_embeddings"], batch["segment_ids"])
    # made on the device: a copy from pageable host memory cannot be captured into a CUDA graph
    positions = torch.cat([torch.arange(TEXT_LEN, device=x.device),
                           torch.full((MAX_BOXES,), BOX_POSITION_ID, device=x.device)])
    x = x + emb["position_embeddings"][positions][None]
    return dropout(layer_norm(emb["LayerNorm"], x), cfg.hidden_dropout_prob, gen)


def apply(p: Params, batch: dict, cfg: BertConfig, prec: Precision | None = None,
          blocks: Blocks | TrainBlocks | None = None, train: bool = False,
          gen: torch.Generator | None = None) -> dict:
    """Forward pass. Inference (``train=False``): dropout off; ``blocks`` (a
    ``Blocks``) picks the layer and label-conv functions, the kernel wrappers
    or the plain oracles. Training (``train=True``, the tree of
    ``train_params``): dropout from ``gen``, a ``torch.Generator`` on the
    batch's device, which draws each layer's dropout seeds and then the
    embedding mask; ``blocks`` is a ``TrainBlocks``, by default the kernels'."""
    prec = prec if prec is not None else Precision.f32()
    seeds = None
    if train:
        if gen is None:
            raise ValueError("training draws its dropout from a torch.Generator: pass gen=")
        blocks = TRAIN_KERNEL_BLOCKS if blocks is None else blocks
        seeds = block_seeds(gen, num_layers(p["bert"]["encoder"]), 2)
    blocks = KERNEL_BLOCKS if blocks is None else blocks
    x = embed(p, batch, cfg, prec, blocks, gen if train else None)
    bias = mask_to_bias(input_mask(batch))  # [B, 30] key-mask rows
    seq = encoder(p["bert"]["encoder"], x, bias, cfg, prec, blocks, seeds=seeds)
    pooled = pooler(p["bert"]["pooler"], seq, prec)
    probs = heads.am_probs(p["cls"]["seq_relationship"], pooled, batch["labels"])
    return {"sequence": seq, "pooled": pooled, "probs": probs, "score": probs[:, 1]}


def score(p: Params, batch: dict, cfg: BertConfig, prec: Precision | None = None,
          blocks: Blocks | None = None) -> torch.Tensor:
    return apply(p, batch, cfg, prec, blocks)["score"]
