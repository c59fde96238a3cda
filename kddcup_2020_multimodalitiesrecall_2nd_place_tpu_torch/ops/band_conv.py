"""A SAME-padded width-T conv over T positions as one banded product:
ImageBERT-B's label conv (``kdd_conv1``), as the JAX package computes it
(``models/imagebert_b.py`` :77-107, one dot outside any Pallas kernel).

    out[., w, :] = sum_t x[., t, :] @ W[t - w + left] + b

With the positions flattened into the contraction this is x2 [M, T H_in] @
band [T H_in, T H_out], where block (t, w) of the band is tap t - w + left, or
zero outside the kernel (``conv_band``); tap k is block (k, left)
(``band_taps``).

Scoring holds the band built once (``models/imagebert_b.py``). Training holds
the taps, so their zero blocks stay zero and each tap's copies stay tied: the
band is built from them on every forward, as the JAX package builds it on
every call.

* ``band_conv_train``: an autograd Function. Forward: the band in x2's dtype
  from the f32 taps, one ``gemm`` with the "f32" epilogue (bf16 in, f32 sums
  and out on the card). Backward: the cotangent rounded to x2's dtype, as the
  train blocks round theirs; dx = d @ band^T on ``gemm``'s transposed-weight
  mode; the band's gradient x2^T d in f32 (``train_blocks.weight_grads``),
  folded onto the T taps by summing each tap's diagonal of blocks, and the
  bias's gradient the column sums folded over the T positions. The taps'
  gradients stay f32.
* ``band_conv_train_plain``: the same forward in plain differentiable torch,
  its gradient from autograd (the oracle; it rounds the band's gradient to
  x2's dtype at its cast, as the JAX dot's transpose does).

On CPU tensors ``gemm`` runs its plain version.
"""

from __future__ import annotations

import torch

from .library import gemm
from .train_blocks import weight_grads


def conv_band(weights: torch.Tensor, left: int) -> torch.Tensor:
    """Taps [T, H_in, H_out] -> the band [T H_in, T H_out]: rows (t, h_in),
    columns (w, h_out), block (t, w) tap t - w + left or zero. Differentiable
    (the JAX package's construction, ``models/imagebert_b.py`` :91-101)."""
    t, h_in, h_out = weights.shape
    taps = weights.unbind(0)
    zero = weights.new_zeros(h_in, h_out)
    cols = [torch.stack([taps[i - w + left] if 0 <= i - w + left < t else zero for i in range(t)])
            for w in range(t)]
    return torch.stack(cols, 2).reshape(t * h_in, t * h_out)


def band_taps(band: torch.Tensor, taps: int, left: int) -> torch.Tensor:
    """``conv_band`` undone: the band [T H_in, T H_out] -> its taps [T, H_in,
    H_out], tap k read from block (k, left), bit for bit."""
    h_in, h_out = band.shape[0] // taps, band.shape[1] // taps
    return band.reshape(taps, h_in, taps, h_out)[:, :, left, :].contiguous()


def _fold(dband: torch.Tensor, taps: int, left: int) -> torch.Tensor:
    """The band's gradient [T H_in, T H_out] -> the taps' [T, H_in, H_out]:
    tap k's is the sum of blocks (t, w) with t - w = k - left."""
    h_in, h_out = dband.shape[0] // taps, dband.shape[1] // taps
    d4 = dband.view(taps, h_in, taps, h_out)
    return torch.stack([torch.diagonal(d4, offset=left - k, dim1=0, dim2=2).sum(-1) for k in range(taps)])


class _BandConvTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weights, bias, left):
        taps = weights.shape[0]
        band = conv_band(weights.to(x2.dtype), left)
        ctx.save_for_backward(x2, band)
        ctx.cfg = (taps, left)
        return gemm(x2, band, bias.float().repeat(taps), "f32")

    @staticmethod
    def backward(ctx, dout):
        x2, band = ctx.saved_tensors
        taps, left = ctx.cfg
        d = dout.to(x2.dtype).contiguous()
        dx = gemm(d, band, None, "bias", trans_b=True)
        dband, dbias = weight_grads(x2, d)
        return dx, _fold(dband, taps, left), dbias.view(taps, -1).sum(0), None


def band_conv_train(x2: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor, left: int) -> torch.Tensor:
    """x2 [M, T H_in] (bf16 on CUDA), f32 taps [T, H_in, H_out] and bias
    [H_out] -> the conv before its activation, [M, T H_out] f32."""
    return _BandConvTrain.apply(x2.contiguous(), weights, bias, left)


def band_conv_train_plain(x2: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor, left: int) -> torch.Tensor:
    """The same in plain differentiable torch, on any device."""
    band = conv_band(weights.to(x2.dtype), left)
    return torch.matmul(x2.float(), band.float()) + bias.float().repeat(weights.shape[0])
