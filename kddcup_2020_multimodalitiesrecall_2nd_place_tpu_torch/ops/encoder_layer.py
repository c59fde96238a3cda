"""Fused post-LN encoder layer, the port of ``encoder_layer_pallas`` (JAX
package ``ops/pallas_layer.py:128``): the self-attention block then the FFN
block of one layer,

    a   = LN1(x + concat_h softmax(Q_h K_h^T / sqrt(Dh) + bias) V_h @ Wo + bo)
    out = LN2(a + gelu(a @ W1 + b1) @ W2 + b2)

with the attention output ``a`` and the GELU intermediate kept on chip, as
the TPU kernel kept them in VMEM. A whole layer's 14 MB of bf16 weights do
not fit a CTA's 227 KB of shared memory, so on the card it is three launches
of the hand-written kernels in ``kernels.py``:

1. ``gemm`` (bias epilogue): qkv = bf16(x @ Wqkv + bqkv)             [B*S, 3H]
2. ``attn_core``: exact per-head softmax, the bias, ctx -> bf16       [B*S, H]
3. ``layer_tail``: out-projection + residual, LN1, FFN in 192-column
   chunks, LN2 -> bf16; LN1's output and the GELU chunks never leave
   shared memory                                                    [B*S, H]

It replaces the seven launches of the attention and FFN blocks and two of
their [B*S, H] round trips, plus the [B*S, I] GELU one. Bound on H100 at
ImageBERT-B's B=512, S=30: operations, ~219 GFLOP a layer (0.22 ms at the
bf16 peak), against ~50 MB of activations and 14 MB of weights. It rounds
where the two-block path rounds (qkv, probs, ctx, LN1 output, GELU output,
LN2 output in bf16), so the two routes agree to summation order.

On a CPU tensor every step runs its kernel's plain version;
``encoder_layer_plain`` is the independent oracle, the two plain blocks in
sequence (the JAX package's unfused path, ``models/core.py`` :627-628).
"""

from __future__ import annotations

import torch

from .attention_block import attention_bias, attention_block_plain
from .ffn_block import ffn_block_plain
from .library import attn_core, gemm, layer_tail


def encoder_layer(x, wqkv, bqkv, wo, bo, gamma1, beta1, w1, b1, w2, b2, gamma2, beta2,
                  num_heads: int, bias=None, approximate_gelu: bool = True,
                  eps: float = 1e-12) -> torch.Tensor:
    """x [B, S, H] (bf16 on CUDA); bias None, a [B, S] or [B, 1, 1, S] key mask,
    or a full [B, 1, S, S] one -> [B, S, H] in x's dtype."""
    b, s, h = x.shape
    x2d = x.reshape(b * s, h)
    qkv = gemm(x2d, wqkv, bqkv, "bias")
    ctx = attn_core(qkv, attention_bias(bias, b, s, s), b, s, num_heads)
    out = layer_tail(ctx, x2d, wo, bo, gamma1, beta1, w1, b1, w2, b2, gamma2, beta2, approximate_gelu, eps)
    if x.is_cuda:
        encoder_layer.launches += 1
    return out.reshape(b, s, h)


encoder_layer.launches = 0


def encoder_layer_plain(x, wqkv, bqkv, wo, bo, gamma1, beta1, w1, b1, w2, b2, gamma2, beta2,
                        num_heads: int, bias=None, approximate_gelu: bool = True,
                        eps: float = 1e-12) -> torch.Tensor:
    """The same layer in plain PyTorch, on any device, in x's dtype."""
    a = attention_block_plain(x, wqkv, bqkv, wo, bo, gamma1, beta1, num_heads, bias, eps)
    return ffn_block_plain(a, w1, b1, w2, b2, gamma2, beta2, approximate_gelu, eps)
