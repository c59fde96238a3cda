"""LXMERT's scoring forward in plain PyTorch, float32 with TF32 off, written
from the description of the solution's model (``code/lxmert/src/lxrt/
modeling.py:444-608``, defaults ``param.py:79-81``; ``tasks/kdd_model.py``):

* language stream: the 23 query tokens through BertEmbeddings (word +
  position 0..22 + token type 0, LayerNorm), keys masked by ``input_mask``
  (-10000 at a masked key);
* visual stream, one token a box: (LN(visn_fc(features)) + LN(box_fc(boxes))
  + LN(label_fc(z))) / 3, where z mixes the box's 8 label-token embeddings
  (the same BertEmbeddings, positions 0..7) with 8 taps and a bias; keys
  masked by ``feats_mask``;
* 9 language ("L") layers, then 5 relational ("R") layers over the visual
  stream: post-LN BERT layers with the erf GELU;
* 5 cross ("x") layers: both directions through one shared
  ``visual_attention`` (lang <- visn under the visual keys' mask, visn <-
  lang under the language keys'), each from the streams as they were before
  the layer; then a self-attention and an FFN layer in each stream;
* the tanh pooler on the language [CLS], the two-layer ``logit_fc`` (dense
  2H, erf GELU, LayerNorm, dense 2) and score = softmax(logit)[:, -1].

Departures from the paper (arXiv:1908.07490), each the solution's: the label
path z and the division by 3 (the paper sums the feature and box terms,
halved); a vocabulary of 21,128 (the solution's ``bert_config.json``); the
score head in place of the pre-training heads.

``visual_attention`` is read as ``query`` and ``kv`` (the key's columns, then
the value's). ``lowp`` puts every matrix product's operands through
``lowp.round_fp8``: the control, the reference at the precision below the
configuration's bf16.
"""

from __future__ import annotations

import math

import torch

from .models import _layer, _mm, dense, layer_norm

MASKED = -10000.0


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _ln(p: dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p["gamma"], p["beta"])


def attention(p: dict, x, q, kv, key_bias, heads: int, lowp: bool) -> torch.Tensor:
    """Post-LN attention of x's queries ``q`` over the keys and values ``kv`` -> LN(x + out(ctx))."""
    b, sq, h = x.shape
    sk = kv.shape[1]
    k, v = kv.split(h, dim=-1)

    def heads_of(t, s):
        return t.reshape(b, s, heads, h // heads).transpose(1, 2)

    scores = _mm(heads_of(q, sq), heads_of(k, sk).transpose(-1, -2), lowp) / math.sqrt(h // heads)
    probs = torch.softmax(scores + key_bias[:, None, None, :], dim=-1)
    out = _mm(probs, heads_of(v, sk), lowp).transpose(1, 2).reshape(b, sq, h)
    return _ln(p["output"]["LayerNorm"], dense(p["output"]["dense"], out, lowp) + x)


def self_attention(p: dict, x, key_bias, heads: int, lowp: bool) -> torch.Tensor:
    qkv = dense(p["qkv"], x, lowp)
    h = x.shape[2]
    return attention(p, x, qkv[..., :h], qkv[..., h:], key_bias, heads, lowp)


def cross_attention(p: dict, x, ctx, key_bias, heads: int, lowp: bool) -> torch.Tensor:
    return attention(p, x, dense(p["query"], x, lowp), dense(p["kv"], ctx, lowp), key_bias, heads, lowp)


def ffn(p: dict, x, lowp: bool) -> torch.Tensor:
    hid = dense(p["output"]["dense"], gelu_erf(dense(p["intermediate"], x, lowp)), lowp)
    return _ln(p["output"]["LayerNorm"], hid + x)


def bert_layer(att: dict, ff: dict, x, key_bias, heads: int, lowp: bool) -> torch.Tensor:
    return ffn(ff, self_attention(att, x, key_bias, heads, lowp), lowp)


def embed(emb: dict, ids: torch.Tensor) -> torch.Tensor:
    """BertEmbeddings over the last axis of ``ids``."""
    x = emb["word_embeddings"][ids] + emb["position_embeddings"][: ids.shape[-1]] + emb["token_type_embeddings"][0]
    return _ln(emb["LayerNorm"], x)


def lxmert_scores(p: dict, inputs: dict, cfg: dict, lowp: bool = False) -> torch.Tensor:
    """inputs: input_ids [B, 23], input_mask [B, 23], label_ids [B, 10, 8], boxes [B, 10, 4], features
    [B, 10, 2048], feats_mask [B, 10]; cfg: the widths and the depths ``l_layers``, ``r_layers``,
    ``x_layers`` -> scores [B]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    heads = cfg["num_attention_heads"]
    emb, enc = p["bert"]["embeddings"], p["bert"]["encoder"]
    lang = embed(emb, inputs["input_ids"])
    vf = enc["visn_fc"]
    conv = vf["label_conv"]
    z = (embed(emb, inputs["label_ids"]) * conv["weights"][:, None]).sum(dim=2) + conv["biases"]
    visn = (_ln(vf["visn_layer_norm"], dense(vf["visn_fc"], inputs["features"], lowp))
            + _ln(vf["box_layer_norm"], dense(vf["box_fc"], inputs["boxes"], lowp))
            + _ln(vf["label_layer_norm"], dense(vf["label_fc"], z, lowp))) / 3.0
    lang_bias = (1.0 - inputs["input_mask"].float()) * MASKED
    visn_bias = (1.0 - inputs["feats_mask"].float()) * MASKED
    for i in range(cfg["l_layers"]):
        layer = _layer(enc["layer"], i)
        lang = bert_layer(layer["attention"], layer["ffn"], lang, lang_bias, heads, lowp)
    for i in range(cfg["r_layers"]):
        layer = _layer(enc["r_layers"], i)
        visn = bert_layer(layer["attention"], layer["ffn"], visn, visn_bias, heads, lowp)
    for i in range(cfg["x_layers"]):
        x = _layer(enc["x_layers"], i)
        va = x["visual_attention"]
        lang, visn = (cross_attention(va, lang, visn, visn_bias, heads, lowp),
                      cross_attention(va, visn, lang, lang_bias, heads, lowp))
        lang = bert_layer(x["lang_self_att"], x["lang_ffn"], lang, lang_bias, heads, lowp)
        visn = bert_layer(x["visn_self_att"], x["visn_ffn"], visn, visn_bias, heads, lowp)
    pooled = torch.tanh(dense(p["bert"]["pooler"]["dense"], lang[:, 0], lowp))
    head = p["logit_fc"]
    logit = dense(head["fc2"], _ln(head["LayerNorm"], gelu_erf(dense(head["fc1"], pooled, lowp))), lowp)
    return torch.softmax(logit, dim=-1)[:, -1]
