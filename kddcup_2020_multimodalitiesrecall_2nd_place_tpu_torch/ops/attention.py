"""Eager multi-head attention for short cross-modal sequences (10-43 tokens).

BERT semantics (reference ``pixelmodel.py:640-833``): scores = QK^T / sqrt(Dh)
+ bias, softmax over keys, no padding mask unless a bias is given
(ImageBERT-A gives none). Softmax runs in float32 whatever the compute
dtype: with 2-class heads downstream, a bf16 softmax would burn the whole
1e-3 parity budget. The probabilities are rounded to the value dtype before
the PV product, as the JAX package's XLA and Pallas paths both do.
"""

from __future__ import annotations

import torch


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H] -> [B, N, S, H/N]."""
    b, s, h = x.shape
    return x.reshape(b, s, num_heads, h // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, N, S, Hd] -> [B, S, N*Hd]."""
    b, n, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, n * hd)


def mha(
    q: torch.Tensor,  # [B, N, F, Hd]
    k: torch.Tensor,  # [B, N, T, Hd]
    v: torch.Tensor,  # [B, N, T, Hd]
    bias: torch.Tensor | None = None,  # additive, broadcastable to [B, N, F, T]
) -> torch.Tensor:
    """f32 scores and softmax on the given (possibly bf16) q/k/v; the output
    has v's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[.., T] 1/0 keep-mask -> additive bias with -10000 at masked slots
    (the reference's ``(1 - mask) * -10000``, ``pixelmodel.py:787-798``)."""
    return ((1.0 - mask.float()) * -10000.0).to(dtype)
