"""Scoring heads.

* The NSP-style binary softmax head of ImageBERT-A (score = probs[:, 1]),
  ``run_pretraining_predict_score.py:479-501``; float32 throughout, as the
  JAX package's ``models/heads.py`` :38-57 runs it at HIGHEST precision.
* LXMERT's two-layer ``logit_fc`` classifier (dense 2H, erf GELU, LayerNorm,
  dense 2; ``tasks/kdd_model.py:167-173``), as the JAX package's
  ``models/heads.py`` :197-210: its two denses round their inputs to the
  compute dtype, like every ``dense``.

The AM-softmax and MLM heads follow with their models."""

from __future__ import annotations

import torch

from ..ops.activations import gelu_erf
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
