"""Scoring heads.

* The NSP-style binary softmax head of ImageBERT-A (score = probs[:, 1]),
  ``run_pretraining_predict_score.py:479-501``; float32 throughout, as the
  JAX package's ``models/heads.py`` :38-57 runs it at HIGHEST precision.
* The AM-softmax head of ImageBERT-B/C (``model_triple.py:56-106``, the JAX
  package's ``models/heads.py`` :69-94), all in f32: the L2-normalised
  pooled output against the L2-normalised [768, 2] kernel, margin 0.35 and
  scale 30. The margin applies to the *fed* label's class (the scorers feed
  1), and only where that class's cos > 0.35; scores change without it.
* LXMERT's two-layer ``logit_fc`` classifier (dense 2H, erf GELU, LayerNorm,
  dense 2; ``tasks/kdd_model.py:167-173``), as the JAX package's
  ``models/heads.py`` :197-210: its two denses round their inputs to the
  compute dtype, like every ``dense``.

* The tied-embedding MLM head of ImageBERT-A and LXMERT (``cls/predictions``;
  the JAX package's ``models/heads.py`` :156-194): a tanh-GELU transform
  dense and LayerNorm in f32, then the product with the word-embedding table
  over the whole vocabulary plus ``output_bias``.

``nsp_loss`` is ImageBERT-A's training loss, ``cross_entropy`` LXMERT's (on
``logit_fc``, or on ``am_margin_logits`` of its ``logit_W`` cosines),
``am_loss`` ImageBERT-B/C's, plus ``word_match_loss`` when its weight is set
(the reference trained with it off, ``model_triple.py:207-210``), and
``mlm_loss`` the auxiliary MLM term of A and LXMERT."""

from __future__ import annotations

import torch

from ..ops.activations import gelu_erf, gelu_tanh
from .core import BertConfig, Params, Precision, dense, dense_init, layer_norm, layer_norm_init, trunc_normal


def nsp_head_init(cfg: BertConfig, gen: torch.Generator) -> Params:
    return {
        "output_weights": trunc_normal((2, cfg.hidden_size), cfg.initializer_range, gen),
        "output_bias": torch.zeros((2,)),
    }


def nsp_logits(p: Params, pooled: torch.Tensor) -> torch.Tensor:
    return torch.matmul(pooled.float(), p["output_weights"].float().T) + p["output_bias"].float()


def nsp_probs(p: Params, pooled: torch.Tensor) -> torch.Tensor:
    return torch.softmax(nsp_logits(p, pooled), dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of [B, 2] logits against 0/1 labels, in f32."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    one_hot = torch.nn.functional.one_hot(labels.long(), 2).float()
    return -(one_hot * log_probs).sum(dim=-1).mean()


def nsp_loss(p: Params, pooled: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of the NSP head against 0/1 labels (the JAX
    package's ``models/heads.py`` :60-63)."""
    return cross_entropy(nsp_logits(p, pooled), labels)


AM_MARGIN = 0.35
AM_SCALE = 30.0


def am_head_init(cfg: BertConfig, gen: torch.Generator) -> Params:
    """xavier_normal over [H, 2] (model_triple.py:62-63)."""
    fan_in, fan_out = cfg.hidden_size, 2
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return {"am_kernel": std * torch.randn((fan_in, fan_out), generator=gen)}


def am_cosines(p: Params, pooled: torch.Tensor) -> torch.Tensor:
    """cos(theta) per class, clipped to [-1, 1]. The [B, H] x [H, 2] product
    is an elementwise f32 sum, so no TF32 setting can round it."""
    x = pooled.float()
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
    w = p["am_kernel"].float()
    w = w / torch.linalg.vector_norm(w, dim=0, keepdim=True).clamp_min(1e-10)
    return (x[:, :, None] * w[None]).sum(dim=1).clamp(-1.0, 1.0)


def am_margin_logits(cos: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """scale * (cos - margin on the label's class where its cos > margin)."""
    one_hot = torch.nn.functional.one_hot(labels.long(), 2).float()
    gt_score = (cos * one_hot).sum(dim=-1, keepdim=True)
    added_margin = torch.where(gt_score > AM_MARGIN, AM_MARGIN, 0.0)
    return (cos - one_hot * added_margin) * AM_SCALE


def am_probs(p: Params, pooled: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.softmax(am_margin_logits(am_cosines(p, pooled), labels), dim=-1)


def am_loss(p: Params, pooled: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of the AM-margin logits against 0/1 labels (the
    JAX package's ``models/heads.py`` :97-101)."""
    return cross_entropy(am_margin_logits(am_cosines(p, pooled), labels), labels)


WORD_MATCH_POSITIONS = 18


def word_match_head_init(cfg: BertConfig, gen: torch.Generator, n_positions: int = WORD_MATCH_POSITIONS) -> Params:
    """The word-match head (``model_triple.py:108-160``, ``pixelbert.py:268-278``;
    the JAX package's ``models/heads.py`` :114-124): the shared tanh dense
    ``kdd`` and per-position binary classifiers, stacked."""
    h, std = cfg.hidden_size, cfg.initializer_range
    return {
        "kdd": dense_init(h, h, std, gen),
        "output_weights": trunc_normal((n_positions, 2, h), std, gen),
        "output_bias": torch.zeros((n_positions, 2)),
    }


def word_match_loss(p: Params, seq: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                    prec: Precision) -> torch.Tensor:
    """Sequence positions 1..n through the tanh dense and their position's
    classifier; the sum over positions of the batch-mean weighted cross
    entropy (the JAX package's ``models/heads.py`` :127-150). The classifiers'
    [H] x [H, 2] products are elementwise f32 sums (JAX runs them at HIGHEST)."""
    n = p["output_bias"].shape[0]
    h = torch.tanh(dense(p["kdd"], seq[:, 1:1 + n].float(), prec))
    logits = (h[:, :, None, :] * p["output_weights"].float()[None]).sum(dim=-1) + p["output_bias"].float()
    log_probs = torch.log_softmax(logits, dim=-1)
    one_hot = torch.nn.functional.one_hot(labels.long(), 2).float()
    per = -(one_hot * log_probs).sum(dim=-1) * weights.float()  # [B, n]
    return per.mean(dim=0).sum()


def mlm_head_init(cfg: BertConfig, gen: torch.Generator) -> Params:
    """``cls/predictions``: the transform dense (drawn from ``gen``), its
    LayerNorm and the vocabulary-wide output bias (zeros)."""
    h = cfg.hidden_size
    return {
        "transform": {"dense": dense_init(h, h, cfg.initializer_range, gen), "LayerNorm": layer_norm_init(h)},
        "output_bias": torch.zeros((cfg.vocab_size,)),
    }


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 sums and an f32 result: on the card, bf16 operands go
    into one cuBLAS product (``aten::mm.dtype``) with no f32 copies; other
    operands (f32, or on the CPU, where ``mm.dtype`` has no kernel) take the
    f32 product of their values."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _TiedProduct(torch.autograd.Function):
    """h [N, H] @ table [V, H]^T of compute-dtype operands -> [N, V] f32 (the
    JAX dot with preferred_element_type=float32). The backward's products take
    the cotangent in the operands' dtype too (as a bf16 dot on the TPU rounds
    its f32 operand), and return gradients in the operands' dtype."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(h, table)
        return _mm_f32(h, table.T)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h, table = ctx.saved_tensors
        g = g.to(h.dtype)
        return _mm_f32(g, table).to(h.dtype), _mm_f32(g.T, h).to(table.dtype)


def mlm_logits(p: Params, hidden: torch.Tensor, word_embeddings: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[..., H] hidden states -> [..., vocab] f32 logits tied to the word
    embeddings: the transform dense, tanh GELU and LayerNorm in f32, then one
    product of compute-dtype operands with an f32 result, plus ``output_bias``."""
    h = layer_norm(p["transform"]["LayerNorm"], gelu_tanh(dense(p["transform"]["dense"], hidden, prec)))
    dt = prec.compute_dtype
    lead = h.shape[:-1]
    logits = _TiedProduct.apply(h.reshape(-1, h.shape[-1]).to(dt), word_embeddings.to(dt))
    return logits.reshape(*lead, -1) + p["output_bias"].float()


def mlm_loss(logits: torch.Tensor, label_ids: torch.Tensor, label_weights: torch.Tensor,
             weight_sum: torch.Tensor | None = None) -> torch.Tensor:
    """The weighted mean cross entropy of the masked positions' logits against
    their token ids, the weights' sum plus 1e-5 as the denominator
    (``weight_sum`` in place of the weights' sum: a data-parallel rank's
    global one)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    picked = log_probs.gather(-1, label_ids.long()[..., None])[..., 0]
    weights = label_weights.float()
    return (weights * -picked).sum() / ((weights.sum() if weight_sum is None else weight_sum) + 1e-5)


def logit_fc_init(cfg: BertConfig, gen: torch.Generator, num_answers: int = 2) -> Params:
    h = cfg.hidden_size
    return {
        "fc1": dense_init(h, 2 * h, cfg.initializer_range, gen),
        "LayerNorm": layer_norm_init(2 * h),
        "fc2": dense_init(2 * h, num_answers, cfg.initializer_range, gen),
    }


def logit_fc(p: Params, pooled: torch.Tensor, prec: Precision) -> torch.Tensor:
    h = gelu_erf(dense(p["fc1"], pooled, prec))
    h = layer_norm(p["LayerNorm"], h)
    return dense(p["fc2"], h, prec)
