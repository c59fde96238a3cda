"""ImageBERT-A: single-stream 40-token scorer (reference ``imagebert_lds``).

Sequence layout: [20 query wordpieces | 10 RoI-feature tokens | 10 label
tokens]. Query tokens get word+type+position embeddings then LayerNorm;
RoI features pass a 2048->768 linear (``pixelmodel.py:439-442``); label
tokens are mixed 8->1 by the reshape quirk below. The three parts are
concatenated AFTER that postprocessing (``pixelmodel.py:601``), in float32,
so image and label tokens carry no position/type embedding and skip the
embedding LayerNorm. The attention mask is all-ones over all 40 positions:
padding is deliberately not masked (``pixelmodel.py:189-195``), so the
encoder runs with no bias. Head: binary NSP softmax, score = probs[:, 1].
The tree also holds the tied MLM head (``cls/predictions``), which only the
MLM loss reads and no scorer holds (``checkpoint.scoring_params``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..data.tsv import MAX_BOXES, MAX_QUERY_LEN_AB
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
SEQ_LEN = TEXT_LEN + 2 * MAX_BOXES  # 40
FEATURE_DIM = 2048
# the batch entries the model reads; the engine moves only these to the device
INPUT_KEYS = ("input_ids", "segment_ids", "features", "label_ids")
# every matmul kernel of the tree, cast once to the compute dtype (checkpoint/npz.py);
# the NSP head's output_weights stay f32, as the JAX head runs at HIGHEST precision
MATMUL_KERNELS = (
    ("bert", "encoder", "attention", "qkv"),
    ("bert", "encoder", "attention", "output", "dense"),
    ("bert", "encoder", "ffn", "intermediate"),
    ("bert", "encoder", "ffn", "output", "dense"),
    ("bert", "pooler", "dense"),
    ("featureemb",),
)


def init_params(cfg: BertConfig, gen: torch.Generator) -> Params:
    """Random parameters in the port's layout, drawn from ``gen``."""
    emb = embeddings_init(cfg, gen)
    # the 8->1 label mixing vector, named word_embeddings_labelembedding in TF
    emb["word_embeddings_labelembedding"] = trunc_normal((8, 1), cfg.initializer_range, gen)
    return {
        "bert": {
            "embeddings": emb,
            "encoder": encoder_init(cfg, gen),
            "pooler": {"dense": dense_init(cfg.hidden_size, cfg.hidden_size, cfg.initializer_range, gen)},
        },
        "featureemb": dense_init(FEATURE_DIM, cfg.hidden_size, cfg.initializer_range, gen),
        # the MLM head drawn last, so every other tensor of a seed's stream is as it was without it
        "cls": {"seq_relationship": heads.nsp_head_init(cfg, gen), "predictions": heads.mlm_head_init(cfg, gen)},
    }


def _label_mix(emb_table: torch.Tensor, mix: torch.Tensor, label_ids: torch.Tensor) -> torch.Tensor:
    """The reshape4D quirk: [B,10,8] ids -> [B,10,768] mixed embeddings.

    TF's ``reshape(-1, 8) @ mix`` groups 8 *consecutive hidden dims* (C
    order): out[b,n, t*96+g] = sum_j e[b,n,t, g*8+j] * mix[j]. Computed as
    the JAX package computes it (``models/imagebert_a.py`` :67-86): one f32
    contraction of each token's H dims with kron(I_96, mix) [H, 96].
    """
    e = F.embedding(label_ids, emb_table).float()  # [B, 10, 8, H]
    b, n, t, h = e.shape
    g = h // t  # 96 groups of 8 consecutive dims per token
    mix_mat = torch.kron(torch.eye(g, dtype=e.dtype, device=e.device), mix.float())  # [H, g]
    mixed = torch.einsum("bnth,hg->bntg", e, mix_mat)
    return mixed.reshape(b, MAX_BOXES, h)


def embed(p: Params, batch: dict, cfg: BertConfig, prec: Precision,
          gen: torch.Generator | None = None) -> torch.Tensor:
    """-> [B, 40, H] float32 transformer input; with ``gen`` the text part
    gets its hidden dropout."""
    emb = p["bert"]["embeddings"]
    table = emb["word_embeddings"]
    # F.embedding, not indexing: the same gather, and a backward that sums duplicate ids
    # (every padding id 0) in one sorted pass where index_put's accumulate serializes them
    text = F.embedding(batch["input_ids"].long(), table)  # [B, 20, H]
    text = text + token_type_embed(emb["token_type_embeddings"], batch["segment_ids"])
    text = text + emb["position_embeddings"][:TEXT_LEN][None]
    text = dropout(layer_norm(emb["LayerNorm"], text), cfg.hidden_dropout_prob, gen)
    feat = dense(p["featureemb"], batch["features"], prec)  # [B, 10, H]
    label = _label_mix(table, emb["word_embeddings_labelembedding"], batch["label_ids"].long())
    return torch.cat([text.float(), feat.float(), label.float()], dim=1)


def apply(p: Params, batch: dict, cfg: BertConfig, prec: Precision | None = None,
          blocks: Blocks | TrainBlocks | None = None, train: bool = False,
          gen: torch.Generator | None = None) -> dict:
    """Forward pass. Inference (``train=False``): dropout off, as the reference
    zeroes it when not training (pixelmodel.py:178-180); ``blocks`` (a
    ``Blocks``) picks the per-layer block functions, the kernels' or the plain
    oracles. Training (``train=True``, the JAX package's ``apply`` with an
    rng, :116-139): dropout from ``gen``, a ``torch.Generator`` on the batch's
    device, which draws each layer's dropout seeds and then the embedding
    mask; ``blocks`` is a ``TrainBlocks``, by default the kernels'."""
    prec = prec if prec is not None else Precision.f32()
    seeds = None
    if train:
        if gen is None:
            raise ValueError("training draws its dropout from a torch.Generator: pass gen=")
        blocks = TRAIN_KERNEL_BLOCKS if blocks is None else blocks
        seeds = block_seeds(gen, num_layers(p["bert"]["encoder"]), 2)
    blocks = KERNEL_BLOCKS if blocks is None else blocks
    x = embed(p, batch, cfg, prec, gen if train else None)
    seq = encoder(p["bert"]["encoder"], x, None, cfg, prec, blocks=blocks, seeds=seeds)
    pooled = pooler(p["bert"]["pooler"], seq, prec)
    probs = heads.nsp_probs(p["cls"]["seq_relationship"], pooled)
    return {"sequence": seq, "pooled": pooled, "probs": probs, "score": probs[:, 1]}


def score(p: Params, batch: dict, cfg: BertConfig, prec: Precision | None = None,
          blocks: Blocks | None = None) -> torch.Tensor:
    return apply(p, batch, cfg, prec, blocks)["score"]
