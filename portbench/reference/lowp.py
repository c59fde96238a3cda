"""The control's arithmetic: the reference at the precision below the
configuration's bf16 matrix products, fp8. Each operand of a product is scaled
so that its largest magnitude meets the format's largest finite value, rounded
to float8 e4m3 and scaled back (per-tensor scaling, as fp8 training and
serving do it); in a backward pass the incoming gradient is rounded the same
way to e5m2."""

from __future__ import annotations

import torch


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)
