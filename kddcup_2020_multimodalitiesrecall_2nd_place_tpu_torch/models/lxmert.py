"""LXMERT: dual-stream cross-modal scorer (reference ``code/lxmert``), the
port of the JAX package's ``models/lxmert.py``.

Architecture (``lxrt/modeling.py:444-608``, defaults ``param.py:79-81``):
9 language layers over the 23-token query (key mask from ``input_mask``),
the visual feature encoder, 5 relational ("r") layers over the 10 visual
tokens (key mask from ``feats_mask``), then 5 cross ("x") layers. Each
x-layer runs both cross directions with **one** shared ``visual_attention``
module (``modeling.py:460-464``), lang <- visn masked by the visn keys and
visn <- lang masked by the lang keys, both from the pre-cross streams, then
self-attention and FFN per stream. Every FFN uses the erf GELU. With
``KMR_FUSED_LAYER=1`` each x-layer's self-attention + FFN, in both streams,
is one fused encoder layer (the JAX package's ``models/lxmert.py`` :301-315);
the L and R stacks keep the two blocks, as there (:245-259). The "pallas"
attention backend takes self-attention only: the first x-layer's cross
attention raises, as ``mha_pallas`` fails there in the JAX package.

Visual token = (LN(visn_fc(feats)) + LN(box_fc(boxes4)) + LN(label_fc(z)))/3
where z mixes each box's 8 label-text embeddings with an 8-tap weight in f32
(``modeling.py:496-533``). Box-label texts are embedded with the same
BertEmbeddings as the query, with per-box position ids 0..7.

Head: the two-layer ``logit_fc`` classifier, score = softmax(logit)[:, -1]
(``tasks/kdd_model.py:102-112, 167-173``), or with ``use_am_head`` the
cosines of the L2-normalised pooled output against the L2-normalised
``logit_W`` [H, 2] (``--taskAMSloss``, :207-210; the JAX package's
``models/lxmert.py`` :330-334), which training with ``am_loss`` reads.

The tree also holds the tied MLM head (``cls/predictions``, the JAX tree's
:121-122), which only the MLM loss on the ``lang`` stream reads and no scorer
holds (``checkpoint.scoring_params``).

Training (``apply(..., train=True, gen=)``, the JAX ``apply`` with an rng):
dropout from ``gen`` on the query embedding, the [B, 10, 8, H] label
embedding and the visual encoder's output (JAX :151-152, :181-182), and per
block dropout seeds: one (attention, FFN) pair per L and R layer and six per
x-layer (two cross, two self-attention, two FFN; JAX :289-315), every block
the train block of ``blocks`` (a ``TrainBlocks``). Its parameters hold
``visual_attention`` as ``query`` and ``kv`` only (``train_params``): the
cross route reads nothing else, and a ``qkv`` copy would get no gradient yet
be decayed. ``eval_params`` rebuilds ``qkv`` for scoring and saving.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops.attention import mask_to_bias
from . import heads
from .core import (
    KERNEL_BLOCKS,
    TRAIN_KERNEL_BLOCKS,
    BertConfig,
    Blocks,
    Params,
    Precision,
    TrainBlocks,
    attention_forms,
    block_seeds,
    dense,
    dense_init,
    dropout,
    dual_cross_attention_blocks,
    embeddings_init,
    encoder,
    encoder_init,
    encoder_layer,
    layer_norm,
    layer_norm_init,
    pooler,
    unbind_layers,
)

ACT = "gelu_erf"
LABEL_TOKENS = 8
# the batch entries the model reads; the engine moves only these to the device
INPUT_KEYS = ("input_ids", "input_mask", "label_ids", "boxes", "features", "feats_mask")

_LAYER_KERNELS = (("attention", "qkv"), ("attention", "output", "dense"),
                  ("ffn", "intermediate"), ("ffn", "output", "dense"))
_X = ("bert", "encoder", "x_layers")
# every matmul kernel of the tree, cast once to the compute dtype (checkpoint/npz.py)
MATMUL_KERNELS = (
    *[("bert", "encoder", stack, *leaf) for stack in ("layer", "r_layers") for leaf in _LAYER_KERNELS],
    *[(*_X, "visual_attention", name) for name in ("qkv", "query", "kv")],
    (*_X, "visual_attention", "output", "dense"),
    *[(*_X, f"{s}_self_att", *leaf) for s in ("lang", "visn") for leaf in (("qkv",), ("output", "dense"))],
    *[(*_X, f"{s}_ffn", *leaf) for s in ("lang", "visn") for leaf in (("intermediate",), ("output", "dense"))],
    *[("bert", "encoder", "visn_fc", name) for name in ("visn_fc", "box_fc", "label_fc")],
    ("bert", "pooler", "dense"),
    ("logit_fc", "fc1"),
    ("logit_fc", "fc2"),
)


@dataclass(frozen=True)
class LxmertConfig:
    bert: BertConfig = BertConfig()
    l_layers: int = 9
    x_layers: int = 5
    r_layers: int = 5
    visual_feat_dim: int = 2048
    visual_pos_dim: int = 4


def _visn_fc_init(lcfg: LxmertConfig, gen: torch.Generator) -> Params:
    h, std = lcfg.bert.hidden_size, lcfg.bert.initializer_range
    return {
        "visn_fc": dense_init(lcfg.visual_feat_dim, h, std, gen),
        "visn_layer_norm": layer_norm_init(h),
        "box_fc": dense_init(lcfg.visual_pos_dim, h, std, gen),
        "box_layer_norm": layer_norm_init(h),
        "label_conv": {"weights": 0.02 * torch.randn(LABEL_TOKENS, generator=gen), "biases": torch.zeros(1)},
        "label_fc": dense_init(h, h, std, gen),
        "label_layer_norm": layer_norm_init(h),
    }


def _x_layers_init(lcfg: LxmertConfig, gen: torch.Generator) -> Params:
    cfg, n = lcfg.bert, lcfg.x_layers
    h, std, lead = cfg.hidden_size, cfg.initializer_range, (n,)
    att = {name: dense_init(h, h, std, gen, lead) for name in ("query", "key", "value")}
    att["output"] = {"dense": dense_init(h, h, std, gen, lead), "LayerNorm": layer_norm_init(h, lead)}
    lang, visn = encoder_init(cfg, gen, n), encoder_init(cfg, gen, n)
    return {
        "visual_attention": attention_forms(att, cross=True),
        "lang_self_att": lang["attention"],
        "visn_self_att": visn["attention"],
        "lang_ffn": lang["ffn"],
        "visn_ffn": visn["ffn"],
    }


def init_params(lcfg: LxmertConfig, gen: torch.Generator) -> Params:
    """Random parameters in the port's layout, drawn from ``gen``."""
    cfg = lcfg.bert
    return {
        "bert": {
            "embeddings": embeddings_init(cfg, gen),
            "encoder": {
                "layer": encoder_init(cfg, gen, lcfg.l_layers),
                "r_layers": encoder_init(cfg, gen, lcfg.r_layers),
                "x_layers": _x_layers_init(lcfg, gen),
                "visn_fc": _visn_fc_init(lcfg, gen),
            },
            "pooler": {"dense": dense_init(cfg.hidden_size, cfg.hidden_size, cfg.initializer_range, gen)},
        },
        "logit_fc": heads.logit_fc_init(cfg, gen),
        # the AM head's [H, 2] weight, xavier normal (JAX :126-127)
        "logit_W": (2.0 / (cfg.hidden_size + 2)) ** 0.5 * torch.randn((cfg.hidden_size, 2), generator=gen),
        # the MLM head drawn last, so every other tensor of a seed's stream is as it was without it
        "cls": {"predictions": heads.mlm_head_init(cfg, gen)},
    }


def _with_visual_attention(p: Params, va: Params) -> Params:
    """A copy of ``p`` with x_layers/visual_attention set to ``va``; every other leaf shared."""
    enc = p["bert"]["encoder"]
    xs = {**enc["x_layers"], "visual_attention": va}
    return {**p, "bert": {**p["bert"], "encoder": {**enc, "x_layers": xs}}}


def train_params(p: Params) -> Params:
    """The tree a trainer holds: ``visual_attention`` without its ``qkv``,
    which no training route reads."""
    va = p["bert"]["encoder"]["x_layers"]["visual_attention"]
    return _with_visual_attention(p, {k: v for k, v in va.items() if k != "qkv"})


def eval_params(p: Params) -> Params:
    """A trained tree with ``visual_attention``'s ``qkv`` rebuilt as
    cat(query, kv), the form the dual route scores with."""
    va = dict(p["bert"]["encoder"]["x_layers"]["visual_attention"])
    va["qkv"] = {n: torch.cat([va["query"][n], va["kv"][n]], dim=-1).detach() for n in ("kernel", "bias")}
    return _with_visual_attention(p, va)


def bert_embed(emb: Params, input_ids: torch.Tensor, out_dtype=None, rate: float = 0.0,
               gen: torch.Generator | None = None) -> torch.Tensor:
    """BertEmbeddings (``modeling.py:269-297``): word + position (0..S-1) +
    type 0, then LayerNorm with f32 internals, emitted in ``out_dtype``; with
    ``gen``, dropout at ``rate``."""
    seq = input_ids.shape[-1]
    # F.embedding, not indexing: the same gather, and a backward that sums duplicate ids
    # (every padding id 0) in one sorted pass where index_put's accumulate serializes them
    x = F.embedding(input_ids.long(), emb["word_embeddings"])
    x = x + emb["position_embeddings"][:seq]
    x = x + emb["token_type_embeddings"][0]
    return dropout(layer_norm(emb["LayerNorm"], x, out_dtype=out_dtype), rate, gen)


def visual_encoder(p: Params, batch: dict, label_emb: torch.Tensor, prec: Precision, rate: float = 0.0,
                   gen: torch.Generator | None = None) -> torch.Tensor:
    """VisualFeatEncoder (``modeling.py:519-533``): (x + y + z) / 3 in f32;
    with ``gen``, dropout at ``rate``."""
    x = layer_norm(p["visn_layer_norm"], dense(p["visn_fc"], batch["features"], prec))
    y = layer_norm(p["box_layer_norm"], dense(p["box_fc"], batch["boxes"], prec))
    # the 8-tap label mix in f32 whatever the activation dtype (JAX ``:166-178``)
    z = torch.einsum("bnth,t->bnh", label_emb.float(), p["label_conv"]["weights"].float())
    z = z + p["label_conv"]["biases"].float()
    z = layer_norm(p["label_layer_norm"], dense(p["label_fc"], z, prec))
    return dropout((x + y + z) / 3.0, rate, gen)


def am_cosines(w: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """The ``logit_W`` head: cos of the pooled output against each class's
    column, both normalised with eps 1e-12 and not clipped (the loss clips,
    ``train/trainer.py``). The [B, H] x [H, 2] product is an elementwise f32
    sum, so no TF32 setting can round it (JAX runs it at HIGHEST)."""
    x = pooled.float()
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
    w = w.float()
    w = w / torch.linalg.vector_norm(w, dim=0, keepdim=True).clamp_min(1e-12)
    return (x[:, :, None] * w[None]).sum(dim=1)


def apply(p: Params, batch: dict, lcfg: LxmertConfig, prec: Precision | None = None,
          blocks: Blocks | TrainBlocks | None = None, train: bool = False, gen: torch.Generator | None = None,
          use_am_head: bool = False) -> dict:
    """Forward pass. Inference (``train=False``): dropout off; ``blocks`` (a
    ``Blocks``) picks the block functions, the kernel wrappers or the plain
    oracles. Training (``train=True``): dropout from ``gen``, a
    ``torch.Generator`` on the batch's device, which draws every block's
    dropout seeds (one draw) and then the embedding masks; ``blocks`` is a
    ``TrainBlocks``, by default the kernels'. ``use_am_head`` scores with the
    ``logit_W`` cosines instead of ``logit_fc``."""
    prec = prec if prec is not None else Precision.f32()
    cfg = lcfg.bert
    enc, emb = p["bert"]["encoder"], p["bert"]["embeddings"]
    xs = enc["x_layers"]
    n_l, n_r = (enc[k]["attention"]["qkv"]["bias"].shape[0] for k in ("layer", "r_layers"))
    n_x = xs["visual_attention"]["query"]["bias"].shape[0]
    l_seeds = r_seeds = None
    x_seeds = [None] * n_x
    if train:
        if gen is None:
            raise ValueError("training draws its dropout from a torch.Generator: pass gen=")
        blocks = TRAIN_KERNEL_BLOCKS if blocks is None else blocks
        # one [layers, 6] draw, so one host sync for every stack; an L or R layer takes the first two
        # seeds of its row, an x-layer all six
        rows = block_seeds(gen, n_l + n_r + n_x, 6)
        l_seeds, r_seeds = [r[:2] for r in rows[:n_l]], [r[:2] for r in rows[n_l:n_l + n_r]]
        x_seeds = rows[n_l + n_r:]
    blocks = KERNEL_BLOCKS if blocks is None else blocks
    rate, drop_gen = cfg.hidden_dropout_prob, gen if train else None
    lang = bert_embed(emb, batch["input_ids"], prec.compute_dtype, rate, drop_gen)
    # [B, 10, 8] label ids embedded with the shared BertEmbeddings, positions 0..7
    label_emb = bert_embed(emb, batch["label_ids"], prec.compute_dtype, rate, drop_gen)
    visn = visual_encoder(enc["visn_fc"], batch, label_emb, prec, rate, drop_gen)
    lang_bias = mask_to_bias(batch["input_mask"])  # [B, 23] key-mask rows
    visn_bias = mask_to_bias(batch["feats_mask"])  # [B, 10]

    lang = encoder(enc["layer"], lang, lang_bias, cfg, prec, blocks, ACT, fuse=False, seeds=l_seeds)
    visn = encoder(enc["r_layers"], visn, visn_bias, cfg, prec, blocks, ACT, fuse=False, seeds=r_seeds)
    # each x-layer: both cross directions, then a self-attention + FFN layer per stream; a training
    # x-layer's six seeds go as JAX's rng_of(0..5): cross lang, cross visn, attention lang, attention
    # visn, FFN lang, FFN visn
    for lp, s in zip(unbind_layers(xs), x_seeds, strict=True):
        lang2, visn2 = dual_cross_attention_blocks(lp["visual_attention"], lang, visn, lang_bias, visn_bias,
                                                   cfg, prec, blocks, seeds=None if s is None else s[:2])
        lang = encoder_layer(lp["lang_self_att"], lp["lang_ffn"], lang2, lang_bias, cfg, prec, blocks, ACT,
                             seeds=None if s is None else s[2::2])
        visn = encoder_layer(lp["visn_self_att"], lp["visn_ffn"], visn2, visn_bias, cfg, prec, blocks, ACT,
                             seeds=None if s is None else s[3::2])

    pooled = pooler(p["bert"]["pooler"], lang, prec)
    logit = am_cosines(p["logit_W"], pooled) if use_am_head else heads.logit_fc(p["logit_fc"], pooled, prec)
    probs = torch.softmax(logit, dim=-1)
    return {"lang": lang, "visn": visn, "pooled": pooled, "logit": logit, "probs": probs,
            "score": probs[:, -1]}


def score(p: Params, batch: dict, lcfg: LxmertConfig, prec: Precision | None = None,
          blocks: Blocks = KERNEL_BLOCKS) -> torch.Tensor:
    return apply(p, batch, lcfg, prec, blocks)["score"]
