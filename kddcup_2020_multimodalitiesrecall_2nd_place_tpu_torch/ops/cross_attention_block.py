"""Fused post-LN cross-attention block, the port of
``cross_attention_block_pallas`` (JAX package ``ops/pallas_attention.py:713``):

    y = LN(x + concat_h softmax(Q_h K_h^T / sqrt(Dh) + bias) V_h @ Wo + bo)

with Q from x [B, F, H] through Wq [H, H], and K, V from ctx [B, T, H]
through one [H, 2H] product; the bias masks ctx's keys ([B, T] or
[B, 1, 1, T]) or is a full head-shared [B, 1, F, T] one. LXMERT's x-layers run
it at (F, T) = (23, 10) (lang <- visn) and (10, 23) (visn <- lang), with one
set of weights for both. On the card it is five launches of the
hand-written kernels in ``kernels.py``:

1. ``gemm`` (bias epilogue): q = bf16(x @ Wq + bq)                   [B*F, H]
2. ``gemm`` (bias epilogue): kv = bf16(ctx @ Wkv + bkv)              [B*T, 2H]
3. ``attn_core_cross``: exact per-head softmax, probs and ctx -> bf16 [B*F, H]
4. ``gemm`` (residual epilogue): y = ctx @ Wo + bo + x, in f32       [B*F, H]
5. ``layernorm``: LN(y) -> bf16                                       [B*F, H]

Bound on H100 at (F, T) = (23, 10), H=768, N=12: operations, 78.6 MFLOP a
pair (Q 27.1, KV 23.6, attention 0.7, out-proj 27.1) against ~86 KB of
activations in and out. The design puts the three projections on the tensor
cores and keeps the small attention in shared memory, one CTA per (pair,
head); the q/kv/ctx/y intermediates make one round trip through device
memory each, which the TPU kernel kept in VMEM (later work, PERF.md).

On a CPU tensor every step runs its kernel's plain version;
``cross_attention_block_plain`` is the independent oracle (the JAX package's
unfused XLA path, ``models/core.py`` :342-360).
"""

from __future__ import annotations

import torch

from ..utils.observability import span
from .attention import merge_heads, mha_xla, split_heads
from .attention_block import attention_bias, mha_bias
from .kernels import layernorm_plain
from .library import attn_core_cross, gemm, layernorm


def cross_attention_block(x, ctx, wq, bq, wkv, bkv, wo, bo, gamma, beta, num_heads: int,
                          bias=None, eps: float = 1e-12) -> torch.Tensor:
    """x [B, F, H], ctx [B, T, H] (bf16 on CUDA), bias masking ctx's keys
    ([B, T] or [B, 1, 1, T]) or a full [B, 1, F, T] one -> [B, F, H] in x's dtype;
    span ``block.cross_attention``."""
    b, f, h = x.shape
    t = ctx.shape[1]
    with span("block.cross_attention"):
        x2d = x.reshape(b * f, h)
        q = gemm(x2d, wq, bq, "bias")
        kv = gemm(ctx.reshape(b * t, h), wkv, bkv, "bias")
        o = attn_core_cross(q, kv, attention_bias(bias, b, f, t), b, f, t, num_heads)
        y = gemm(o, wo, bo, "residual", residual=x2d)
        out = layernorm(y, gamma, beta, eps, out_dtype=x.dtype)
    if x.is_cuda:
        cross_attention_block.launches += 1
    return out.reshape(b, f, h)


cross_attention_block.launches = 0


def cross_attention_block_plain(x, ctx, wq, bq, wkv, bkv, wo, bo, gamma, beta, num_heads: int,
                                bias=None, eps: float = 1e-12) -> torch.Tensor:
    """The same block in plain PyTorch, on any device, in x's dtype."""
    dt = x.dtype
    b, t, h = ctx.shape
    q = (torch.matmul(x.float(), wq.to(dt).float()) + bq.float()).to(dt)
    kv = (torch.matmul(ctx.float(), wkv.to(dt).float()) + bkv.float()).to(dt)
    k, v = kv.split(h, dim=-1)
    bias = mha_bias(attention_bias(bias, b, x.shape[1], t))
    o = merge_heads(mha_xla(split_heads(q, num_heads), split_heads(k, num_heads), split_heads(v, num_heads), bias))
    y = torch.matmul(o.float(), wo.to(dt).float()) + bo.float() + x.float()
    return layernorm_plain(y, gamma, beta, eps, out_dtype=dt)
