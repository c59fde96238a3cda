"""Fused post-LN self-attention block, the port of ``attention_block_pallas``
(JAX package ``ops/pallas_attention.py:479``):

    y = LN(x + concat_h softmax(Q_h K_h^T / sqrt(Dh) + bias) V_h @ Wo + bo)

with Q, K, V from one [H, 3H] product and the bias none, a key mask ([B, S]
or [B, 1, 1, S]) or a full head-shared [B, 1, S, S] one, as in JAX's
``attention_block_pallas``. On the card it is four launches of
the hand-written kernels in ``kernels.py``:

1. ``gemm`` (bias epilogue): qkv = bf16(x @ Wqkv + bqkv)          [B*S, 3H]
2. ``attn_core``: exact per-head softmax, probs and ctx -> bf16    [B*S, H]
   (its key-mask instance for a key mask, its full-bias one for [B, 1, S, S])
3. ``gemm`` (residual epilogue): y = ctx @ Wo + bo + x, in f32    [B*S, H]
4. ``layernorm``: LN(y) -> bf16                                    [B*S, H]

Bound on H100 at ImageBERT-A's shapes (S=40, H=768, N=12): operations,
193.7 MFLOP a pair, 98% of them in the two projections; the block moves
~130 KB a pair at a single-pass minimum, far below the ~295 bytes-per-FLOP
balance point. The design puts both projections on the tensor cores and
keeps the small S=40 attention in shared memory, one CTA per (pair, head).
Unlike the TPU kernel, the qkv/ctx/y intermediates make one round trip
through device memory each; fusing them away is later work (PERF.md).

On a CPU tensor every step runs its kernel's plain version, so the CPU
tests exercise the same composition; ``attention_block_plain`` is the
independent oracle (the JAX package's unfused XLA path, ``models/core.py``
:331-360) that the tests and ``chip_smoke.py`` hold the block against.
"""

from __future__ import annotations

import torch

from ..utils.observability import span
from .attention import merge_heads, mha_xla, split_heads
from .kernels import layernorm_plain
from .library import attn_core, gemm, layernorm


def is_compact(bias: torch.Tensor | None) -> bool:
    """None, or a bias over the keys only: [B, S] rows or [B, 1, 1, S]."""
    return bias is None or bias.dim() == 2 or (bias.dim() == 4 and bias.shape[1] == bias.shape[2] == 1)


def key_bias_rows(bias: torch.Tensor | None, b: int, s: int) -> torch.Tensor | None:
    """None, [B, S] or [B, 1, 1, S] additive key mask -> f32 [B, S] rows."""
    if bias is None:
        return None
    if bias.shape not in ((b, s), (b, 1, 1, s)):
        raise ValueError(f"expected a key-mask bias [B, S] or [B, 1, 1, S], got {tuple(bias.shape)}")
    return bias.reshape(b, s).float().contiguous()


def attention_bias(bias: torch.Tensor | None, b: int, sq: int, sk: int) -> torch.Tensor | None:
    """The bias of an attention block in the form ``attn_core`` takes: None; a
    key mask ([B, Sk] or [B, 1, 1, Sk]) -> f32 [B, Sk] rows; a head-shared bias
    that broadcasts to [B, 1, Sq, Sk] -> f32 [B, Sq, Sk] (JAX's
    ``broadcast_to(bias, (b, 1, sq, sk))``, ``ops/pallas_attention.py`` :544, :780)."""
    if is_compact(bias):
        return key_bias_rows(bias, b, sk)
    if bias.dim() != 4 or any(n not in (1, want) for n, want in zip(bias.shape, (b, 1, sq, sk))):
        raise ValueError(f"expected a key mask or a bias that broadcasts to [B, 1, Sq, Sk] = "
                         f"{(b, 1, sq, sk)}, got {tuple(bias.shape)}")
    return bias.float().expand(b, 1, sq, sk).reshape(b, sq, sk).contiguous()


def mha_bias(rows: torch.Tensor | None) -> torch.Tensor | None:
    """``attention_bias``'s [B, Sk] or [B, Sq, Sk] -> the [B, 1, 1 or Sq, Sk] bias of ``mha_xla``."""
    if rows is None:
        return None
    return rows[:, None, None, :] if rows.dim() == 2 else rows[:, None]


def attention_block(x, wqkv, bqkv, wo, bo, gamma, beta, num_heads: int, bias=None,
                    eps: float = 1e-12) -> torch.Tensor:
    """x [B, S, H] (bf16 on CUDA) -> [B, S, H] in x's dtype; span ``block.attention``."""
    b, s, h = x.shape
    with span("block.attention"):
        x2d = x.reshape(b * s, h)
        qkv = gemm(x2d, wqkv, bqkv, "bias")
        ctx = attn_core(qkv, attention_bias(bias, b, s, s), b, s, num_heads)
        y = gemm(ctx, wo, bo, "residual", residual=x2d)
        out = layernorm(y, gamma, beta, eps, out_dtype=x.dtype)
    if x.is_cuda:
        attention_block.launches += 1
    return out.reshape(b, s, h)


attention_block.launches = 0


def attention_block_plain(x, wqkv, bqkv, wo, bo, gamma, beta, num_heads: int, bias=None,
                          eps: float = 1e-12) -> torch.Tensor:
    """The same block in plain PyTorch, on any device, in x's dtype."""
    dt = x.dtype
    qkv = (torch.matmul(x.float(), wqkv.to(dt).float()) + bqkv.float()).to(dt)
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    bias = mha_bias(attention_bias(bias, x.shape[0], x.shape[1], x.shape[1]))
    ctx = merge_heads(mha_xla(q, k, v, bias))
    y = torch.matmul(ctx.float(), wo.to(dt).float()) + bo.float() + x.float()
    return layernorm_plain(y, gamma, beta, eps, out_dtype=dt)
