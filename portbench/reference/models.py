"""ImageBERT-A's scoring forward and ImageBERT-B's training loss in plain
PyTorch, float32 (TF32 off), written from the reference's description:

* A (``imagebert_lds``, ``pixelmodel.py``): query tokens get word, type and
  position embeddings and a LayerNorm; feature tokens one 2048 -> H dense;
  label tokens the reshape quirk (8 label-token embeddings mixed 8 -> 1 over
  groups of 8 consecutive hidden dims); the 40 tokens concatenated after that,
  no attention mask; 12 post-LN layers (tanh GELU); tanh pooler; NSP softmax,
  score = probs[:, 1].
* B (``imagebert_zk``, ``model_triple.py``): image token = ReLU(SAME 8-tap conv
  over the box's 8 label-token embeddings, mean over the taps' outputs) + box
  dense + ReLU(feature dense), then one H -> H dense; text and image tokens
  concatenated before the embedding LayerNorm, positions 0..19 then 20 for
  every box; key masks from the query length and the box count (-10000);
  dropout on the embeddings, on the attention probabilities and on each
  block's output before its residual; AM-softmax (L2-normalised pooled output
  and kernel, margin 0.35 on the label's class where its cosine exceeds it,
  scale 30) and the mean cross entropy.

``lowp`` puts every matrix product's operands through ``lowp.round_fp8``: the
control, the reference at the precision below the configuration's bf16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import dropout
from .lowp import round_fp8

AM_MARGIN, AM_SCALE = 0.35, 30.0
TEXT_LEN, BOXES, TAPS, CONV_LEFT = 20, 10, 8, 3


def _mm(a: torch.Tensor, b: torch.Tensor, lowp: bool) -> torch.Tensor:
    if lowp:
        a, b = round_fp8(a), round_fp8(b)
    return torch.matmul(a, b)


def dense(p: dict, x: torch.Tensor, lowp: bool) -> torch.Tensor:
    return _mm(x, p["kernel"], lowp) + p["bias"]


def layer_norm(x: torch.Tensor, gamma, beta, eps: float = 1e-12) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * gamma + beta


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _layer(enc: dict, i: int) -> dict:
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return pick(enc)


def encoder_layer(p: dict, x, heads: int, lowp: bool, key_bias=None, seeds=None, rate: float = 0.0):
    """One post-LN layer; with ``seeds`` (attention, FFN) the training dropout."""
    b, s, h = x.shape
    att, ffn = p["attention"], p["ffn"]
    q, k, v = dense(att["qkv"], x, lowp).split(h, dim=-1)

    def heads_of(t):
        return t.reshape(b, s, heads, h // heads).transpose(1, 2)

    scores = _mm(heads_of(q), heads_of(k).transpose(-1, -2), lowp) / math.sqrt(h // heads)
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if seeds is not None:
        probs = torch.where(dropout.probs_keep(seeds[0], rate, b, heads, s, x.device), probs / (1.0 - rate), 0.0)
    ctx = _mm(probs, heads_of(v), lowp).transpose(1, 2).reshape(b, s, h)
    o = dense(att["output"]["dense"], ctx, lowp)
    if seeds is not None:
        o = torch.where(dropout.hidden_keep(seeds[0], rate, b, s, h, "attn", x.device), o / (1.0 - rate), 0.0)
    x = layer_norm(o + x, att["output"]["LayerNorm"]["gamma"], att["output"]["LayerNorm"]["beta"])
    hid = dense(ffn["output"]["dense"], gelu_tanh(dense(ffn["intermediate"], x, lowp)), lowp)
    if seeds is not None:
        hid = torch.where(dropout.hidden_keep(seeds[1], rate, b, s, h, "ffn", x.device), hid / (1.0 - rate), 0.0)
    return layer_norm(hid + x, ffn["output"]["LayerNorm"]["gamma"], ffn["output"]["LayerNorm"]["beta"])


def encoder(enc: dict, x, cfg: dict, lowp: bool, key_bias=None, seeds=None):
    for i in range(cfg["num_hidden_layers"]):
        x = encoder_layer(_layer(enc, i), x, cfg["num_attention_heads"], lowp, key_bias,
                          None if seeds is None else seeds[i], cfg["hidden_dropout_prob"])
    return x


def imagebert_a_scores(p: dict, inputs: dict, cfg: dict, lowp: bool = False) -> torch.Tensor:
    """inputs: input_ids [B, 20], features [B, 10, 2048], label_ids [B, 10, 8] -> scores [B]."""
    emb = p["bert"]["embeddings"]
    table = emb["word_embeddings"]
    text = table[inputs["input_ids"]] + emb["token_type_embeddings"][0] + emb["position_embeddings"][:TEXT_LEN]
    text = layer_norm(text, emb["LayerNorm"]["gamma"], emb["LayerNorm"]["beta"])
    feat = dense(p["featureemb"], inputs["features"], lowp)
    e = table[inputs["label_ids"]]  # [B, 10, 8, H]
    b, n, t, h = e.shape
    mixed = (e.reshape(b, n, t, h // t, t) * emb["word_embeddings_labelembedding"][:, 0]).sum(-1)
    x = torch.cat([text, feat, mixed.reshape(b, n, h)], dim=1)
    x = encoder(p["bert"]["encoder"], x, cfg, lowp)
    pooled = torch.tanh(dense(p["bert"]["pooler"]["dense"], x[:, 0], lowp))
    head = p["cls"]["seq_relationship"]
    logits = pooled @ head["output_weights"].T + head["output_bias"]
    return torch.softmax(logits, dim=-1)[:, 1]


def _label_conv(conv: dict, e: torch.Tensor, lowp: bool) -> torch.Tensor:
    """e [B, 10, 8, H] -> mean over the 8 outputs of ReLU(SAME 8-tap conv)."""
    w = conv["weights"]  # [8 taps, H_in, H_out]
    padded = F.pad(e, (0, 0, CONV_LEFT, TAPS - 1 - CONV_LEFT))  # [B, 10, 15, H]
    out = sum(_mm(padded[:, :, k:k + TAPS], w[k], lowp) for k in range(TAPS)) + conv["biases"]
    return torch.relu(out).mean(dim=2)


def imagebert_b_loss(p: dict, batch: dict, cfg: dict, step_seed: int,
                     lowp: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (the mean AM-softmax cross entropy of one training batch, with the step's dropout; each row's
    probability of class 1)."""
    emb = p["bert"]["embeddings"]
    table = emb["word_embeddings"]
    b = batch["input_ids"].shape[0]
    h = table.shape[1]
    seeds, emb_keep = dropout.step_draws(step_seed, cfg["num_hidden_layers"], (b, TEXT_LEN + BOXES, h),
                                         cfg["hidden_dropout_prob"], table.device)
    lab = _label_conv(p["kdd_conv1"], table[batch["label_ids"]], lowp)
    box = dense(p["kdd_dense1"], batch["boxes"], lowp)
    feat = torch.relu(dense(p["kdd_conv2"], batch["features"], lowp))
    img = dense(p["kdd_featureemb"], lab + box + feat, lowp)
    x = torch.cat([table[batch["input_ids"]], img], dim=1)
    x = x + emb["token_type_embeddings"][batch["segment_ids"]]
    positions = torch.cat([torch.arange(TEXT_LEN), torch.full((BOXES,), TEXT_LEN)]).to(x.device)
    x = layer_norm(x + emb["position_embeddings"][positions], emb["LayerNorm"]["gamma"], emb["LayerNorm"]["beta"])
    rate = cfg["hidden_dropout_prob"]
    x = torch.where(emb_keep, x / (1.0 - rate), 0.0)
    ar = torch.arange(TEXT_LEN + BOXES, device=x.device)
    keep = torch.where(ar < TEXT_LEN, ar[None] < batch["len_query"][:, None],
                       (ar - TEXT_LEN)[None] < batch["num_boxes"][:, None])
    x = encoder(p["bert"]["encoder"], x, cfg, lowp, (1.0 - keep.float()) * -10000.0, seeds)
    pooled = torch.tanh(dense(p["bert"]["pooler"]["dense"], x[:, 0], lowp))
    w = p["cls"]["seq_relationship"]["am_kernel"]
    cos = (F.normalize(pooled, dim=1, eps=1e-12) @ F.normalize(w, dim=0, eps=1e-10)).clamp(-1.0, 1.0)
    one_hot = F.one_hot(batch["labels"].long(), 2).float()
    margin = torch.where((cos * one_hot).sum(-1, keepdim=True) > AM_MARGIN, AM_MARGIN, 0.0)
    logits = (cos - one_hot * margin) * AM_SCALE
    log_probs = torch.log_softmax(logits, dim=-1)
    return -(one_hot * log_probs).sum(-1).mean(), log_probs[:, 1].exp()
