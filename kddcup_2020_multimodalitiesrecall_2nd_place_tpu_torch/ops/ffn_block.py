"""Fused post-LN feed-forward block, the port of ``ffn_block_pallas`` (JAX
package ``ops/pallas_ffn.py:79``):

    y = LN(x + gelu(x @ W1 + b1) @ W2 + b2)

GELU is tanh (ImageBERT) or erf (LXMERT; ``erff`` here, where the TPU
needed the polynomial ``_erf_as``). On the card it is three launches of the
hand-written kernels in ``kernels.py``:

1. ``gemm`` (GELU epilogue): h = bf16(gelu(x @ W1 + b1))     [B*S, I]
2. ``gemm`` (residual epilogue): y = h @ W2 + b2 + x, in f32 [B*S, H]
3. ``layernorm``: LN(y) -> bf16                              [B*S, H]

Bound on H100 at ImageBERT-A's shapes (H=768, I=3072): operations, 377.5
MFLOP a pair against ~61 KB of activations in and out. The design runs both
products on the tensor cores with GELU and the residual fused into their
epilogues; the [B*S, I] GELU output makes one round trip through device
memory, which the TPU kernel kept in VMEM (later work, PERF.md).

On a CPU tensor every step runs its kernel's plain version;
``ffn_block_plain`` is the independent oracle (the JAX package's unfused
path, ``models/core.py`` :497-504).
"""

from __future__ import annotations

import torch

from ..utils.observability import span
from .activations import gelu_erf, gelu_tanh
from .kernels import layernorm_plain
from .library import gemm, layernorm


def ffn_block(x, w1, b1, w2, b2, gamma, beta, approximate_gelu: bool = True,
              eps: float = 1e-12) -> torch.Tensor:
    """x [B, S, H] (bf16 on CUDA) -> [B, S, H] in x's dtype; span ``block.ffn``."""
    b, s, h = x.shape
    with span("block.ffn"):
        x2d = x.reshape(b * s, h)
        hmid = gemm(x2d, w1, b1, "gelu_tanh" if approximate_gelu else "gelu_erf")
        y = gemm(hmid, w2, b2, "residual", residual=x2d)
        out = layernorm(y, gamma, beta, eps, out_dtype=x.dtype)
    if x.is_cuda:
        ffn_block.launches += 1
    return out.reshape(b, s, h)


ffn_block.launches = 0


def ffn_block_plain(x, w1, b1, w2, b2, gamma, beta, approximate_gelu: bool = True,
                    eps: float = 1e-12) -> torch.Tensor:
    """The same block in plain PyTorch, on any device, in x's dtype."""
    dt = x.dtype
    act = gelu_tanh if approximate_gelu else gelu_erf
    hmid = act(torch.matmul(x.float(), w1.to(dt).float()) + b1.float()).to(dt)
    y = torch.matmul(hmid.float(), w2.to(dt).float()) + b2.float() + x.float()
    return layernorm_plain(y, gamma, beta, eps, out_dtype=dt)
