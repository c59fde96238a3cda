"""The NSP-style binary softmax head of ImageBERT-A (score = probs[:, 1]),
``run_pretraining_predict_score.py:479-501``; float32 throughout, as the
JAX package's ``models/heads.py`` :38-57 runs it at HIGHEST precision.
The AM-softmax, MLM and LXMERT heads follow with their models."""

from __future__ import annotations

import torch

from .core import BertConfig, Params, trunc_normal


def nsp_head_init(cfg: BertConfig, gen: torch.Generator) -> Params:
    return {
        "output_weights": trunc_normal((2, cfg.hidden_size), cfg.initializer_range, gen),
        "output_bias": torch.zeros((2,)),
    }


def nsp_logits(p: Params, pooled: torch.Tensor) -> torch.Tensor:
    return torch.matmul(pooled.float(), p["output_weights"].float().T) + p["output_bias"].float()


def nsp_probs(p: Params, pooled: torch.Tensor) -> torch.Tensor:
    return torch.softmax(nsp_logits(p, pooled), dim=-1)
