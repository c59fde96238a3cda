"""Both shared-weight cross directions of an LXMERT x-layer, the port of
``dual_cross_attention_block_pallas`` (JAX package
``ops/pallas_attention.py:912``): one ``visual_attention`` module applied
lang <- visn (masked by the visn keys) and visn <- lang (masked by the lang
keys), both reading the pre-cross streams (``lxmert/src/lxrt/modeling.py``
:460-464). Returns (lang_out [B, F, H], visn_out [B, T, H]).

Because the weights are shared, each stream needs its q (as the query
stream) and its k, v (as the other direction's key stream) from the same
weights: one [H, 3H] product per stream gives all three, at the Pallas
body's rounding points. On the card it is seven launches, against the ten
of two ``cross_attention_block`` calls:

1. ``gemm`` x2 (bias epilogue): lqkv, vqkv = bf16(stream @ Wqkv + bqkv)
2. ``attn_core_dual``: both directions in one launch, grid (heads, B, 2)
3. ``gemm`` x2 (residual epilogue): out-proj + the stream's residual, f32
4. ``layernorm`` x2 -> bf16

Bound on H100 at (F, T) = (23, 10), H=768, N=12: operations, 157.1 MFLOP a
pair (QKV projections 116.8, attention 1.4, out-projections 38.9) against
~101 KB of activations in and out. The design is that of the cross block,
with each stream read by one projection instead of two.

On a CPU tensor every step runs its kernel's plain version;
``dual_cross_attention_block_plain`` is the independent oracle: two plain
cross blocks, which is what the JAX package runs by default (``models/core.py``
:418-421).
"""

from __future__ import annotations

import torch

from ..utils.observability import span
from .attention_block import key_bias_rows
from .cross_attention_block import cross_attention_block_plain
from .library import attn_core_dual, gemm, layernorm


def dual_cross_attention_block(l, v, wqkv, bqkv, wo, bo, gamma, beta, num_heads: int,
                               lang_bias=None, visn_bias=None,
                               eps: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
    """l [B, F, H], v [B, T, H] (bf16 on CUDA); lang_bias [B, F] and visn_bias
    [B, T] (or [B, 1, 1, S]) key masks, both or neither -> (lang_out, visn_out);
    span ``block.dual_cross_attention``."""
    if (lang_bias is None) != (visn_bias is None):
        raise ValueError("dual_cross_attention_block takes both key masks or neither")
    b, f, h = l.shape
    t = v.shape[1]
    with span("block.dual_cross_attention"):
        l2d, v2d = l.reshape(b * f, h), v.reshape(b * t, h)
        lqkv = gemm(l2d, wqkv, bqkv, "bias")
        vqkv = gemm(v2d, wqkv, bqkv, "bias")
        ctx_l, ctx_v = attn_core_dual(lqkv, vqkv, key_bias_rows(lang_bias, b, f),
                                      key_bias_rows(visn_bias, b, t), b, f, t, num_heads)
        outs = []
        for ctx, x2d, rows in ((ctx_l, l2d, f), (ctx_v, v2d, t)):
            y = gemm(ctx, wo, bo, "residual", residual=x2d)
            outs.append(layernorm(y, gamma, beta, eps, out_dtype=l.dtype).reshape(b, rows, h))
    if l.is_cuda:
        dual_cross_attention_block.launches += 1
    return outs[0], outs[1]


dual_cross_attention_block.launches = 0


def dual_cross_attention_block_plain(l, v, wqkv, bqkv, wo, bo, gamma, beta, num_heads: int,
                                     lang_bias=None, visn_bias=None,
                                     eps: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
    """The same pair of blocks in plain PyTorch, on any device, in l's dtype."""
    if (lang_bias is None) != (visn_bias is None):
        raise ValueError("dual_cross_attention_block takes both key masks or neither")
    h = l.shape[2]
    w = (wqkv[:, :h], bqkv[:h], wqkv[:, h:], bqkv[h:], wo, bo, gamma, beta)
    return (cross_attention_block_plain(l, v, *w, num_heads, visn_bias, eps),
            cross_attention_block_plain(v, l, *w, num_heads, lang_bias, eps))
