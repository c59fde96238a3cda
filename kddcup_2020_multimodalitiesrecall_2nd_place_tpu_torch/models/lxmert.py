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

Head at inference: the two-layer ``logit_fc`` classifier, score =
softmax(logit)[:, -1] (``tasks/kdd_model.py:102-112, 167-173``); the AM head
is off for scoring and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.attention import mask_to_bias
from . import heads
from .core import (
    KERNEL_BLOCKS,
    BertConfig,
    Blocks,
    Params,
    Precision,
    attention_forms,
    dense,
    dense_init,
    dual_cross_attention_blocks,
    embeddings_init,
    encoder,
    encoder_init,
    encoder_layer,
    layer_norm,
    layer_norm_init,
    layer_slice,
    pooler,
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
    }


def bert_embed(emb: Params, input_ids: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """BertEmbeddings (``modeling.py:269-297``): word + position (0..S-1) +
    type 0, then LayerNorm with f32 internals, emitted in ``out_dtype``."""
    seq = input_ids.shape[-1]
    x = emb["word_embeddings"][input_ids.long()]
    x = x + emb["position_embeddings"][:seq]
    x = x + emb["token_type_embeddings"][0]
    return layer_norm(emb["LayerNorm"], x, out_dtype=out_dtype)


def visual_encoder(p: Params, batch: dict, label_emb: torch.Tensor, prec: Precision) -> torch.Tensor:
    """VisualFeatEncoder (``modeling.py:519-533``): (x + y + z) / 3 in f32."""
    x = layer_norm(p["visn_layer_norm"], dense(p["visn_fc"], batch["features"], prec))
    y = layer_norm(p["box_layer_norm"], dense(p["box_fc"], batch["boxes"], prec))
    # the 8-tap label mix in f32 whatever the activation dtype (JAX ``:166-178``)
    z = torch.einsum("bnth,t->bnh", label_emb.float(), p["label_conv"]["weights"].float())
    z = z + p["label_conv"]["biases"].float()
    z = layer_norm(p["label_layer_norm"], dense(p["label_fc"], z, prec))
    return (x + y + z) / 3.0


def apply(p: Params, batch: dict, lcfg: LxmertConfig, prec: Precision | None = None,
          blocks: Blocks = KERNEL_BLOCKS) -> dict:
    """Inference forward pass (dropout off). ``blocks`` picks the block
    functions: the kernel wrappers, or the plain oracles."""
    prec = prec if prec is not None else Precision.f32()
    cfg = lcfg.bert
    enc, emb = p["bert"]["encoder"], p["bert"]["embeddings"]
    lang = bert_embed(emb, batch["input_ids"], prec.compute_dtype)
    # [B, 10, 8] label ids embedded with the shared BertEmbeddings, positions 0..7
    label_emb = bert_embed(emb, batch["label_ids"], prec.compute_dtype)
    visn = visual_encoder(enc["visn_fc"], batch, label_emb, prec)
    lang_bias = mask_to_bias(batch["input_mask"])  # [B, 23] key-mask rows
    visn_bias = mask_to_bias(batch["feats_mask"])  # [B, 10]

    lang = encoder(enc["layer"], lang, lang_bias, cfg, prec, blocks, ACT, fuse=False)
    visn = encoder(enc["r_layers"], visn, visn_bias, cfg, prec, blocks, ACT, fuse=False)
    xs = enc["x_layers"]
    for i in range(xs["visual_attention"]["qkv"]["kernel"].shape[0]):
        lp = layer_slice(xs, i)
        lang2, visn2 = dual_cross_attention_blocks(lp["visual_attention"], lang, visn, lang_bias,
                                                   visn_bias, cfg, prec, blocks)
        lang = encoder_layer(lp["lang_self_att"], lp["lang_ffn"], lang2, lang_bias, cfg, prec, blocks, ACT)
        visn = encoder_layer(lp["visn_self_att"], lp["visn_ffn"], visn2, visn_bias, cfg, prec, blocks, ACT)

    pooled = pooler(p["bert"]["pooler"], lang, prec)
    logit = heads.logit_fc(p["logit_fc"], pooled, prec)
    probs = torch.softmax(logit, dim=-1)
    return {"lang": lang, "visn": visn, "pooled": pooled, "logit": logit, "probs": probs,
            "score": probs[:, -1]}


def score(p: Params, batch: dict, lcfg: LxmertConfig, prec: Precision | None = None,
          blocks: Blocks = KERNEL_BLOCKS) -> torch.Tensor:
    return apply(p, batch, lcfg, prec, blocks)["score"]
