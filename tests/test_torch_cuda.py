"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it also runs where only the port's dependencies are installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Band on bf16 outputs, elementwise: |d| <= 1.6e-2 + 2^-6 * |plain|, two
bf16 ulps of the plain value above a 1.6e-2 floor (the chip_smoke.py band):
the kernels round where the plain versions round, but their 768- and
3072-long sums run in another order than torch's, which can flip one bf16
rounding of an output or of an intermediate.
"""

import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import kernels
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention import mask_to_bias
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention_block import (
    attention_block,
    attention_block_plain,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.ffn_block import ffn_block, ffn_block_plain
from torch_parity import attn_inputs, cuda, ffn_inputs  # noqa: F401  (cuda: fixture)

CARD_ATOL, CARD_RTOL = 1.6e-2, 2.0**-6


def within_band(got, want, atol=CARD_ATOL, rtol=CARD_RTOL) -> bool:
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    return bool(torch.isfinite(got).all()) and bool(((got - want).abs() <= atol + rtol * want.abs()).all())


FULL = dict(b=8, s=40, h=768)


def _to(arrays, device, dtypes):
    return [torch.from_numpy(a).to(device=device, dtype=dt) for a, dt in zip(arrays, dtypes)]


@pytest.mark.parametrize(
    "s,with_bias",
    [(40, False), (40, True), (30, True), (23, True), (10, False)],
    ids=["A", "A-mask", "BC-mask", "lxmert-lang-mask", "lxmert-visn"],
)
def test_cuda_attention_block_matches_plain(cuda, s, with_bias):
    """ImageBERT-A's S=40, and the S=30/23/10 the other models will bring
    (S not a multiple of 4 exercises the kernel's row padding)."""
    x, ws, mask = attn_inputs(4, with_bias=with_bias, **{**FULL, "s": s})
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    wt = _to(ws, cuda, [torch.bfloat16, torch.float32, torch.bfloat16] + [torch.float32] * 3)
    bias = None if mask is None else mask_to_bias(torch.from_numpy(mask).to(cuda))
    got = attention_block(xt, *wt, 12, bias)
    want = attention_block_plain(xt, *wt, 12, bias)
    assert within_band(got, want)


@pytest.mark.parametrize("approximate", [True, False])
def test_cuda_ffn_block_matches_plain(cuda, approximate):
    x, ws = ffn_inputs(5, i=3072, **FULL)
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    wt = _to(ws, cuda, [torch.bfloat16, torch.float32, torch.bfloat16] + [torch.float32] * 3)
    got = ffn_block(xt, *wt, approximate_gelu=approximate)
    want = ffn_block_plain(xt, *wt, approximate_gelu=approximate)
    assert within_band(got, want)


def test_cuda_gemm_ragged_rows(cuda):
    """M = 333 rows: the ragged tile edge is masked on load and store."""
    g = torch.Generator(device="cpu").manual_seed(6)
    a = torch.randn(333, 768, generator=g).to(cuda, torch.bfloat16)
    w = (0.05 * torch.randn(768, 2304, generator=g)).to(cuda, torch.bfloat16)
    bias = torch.randn(2304, generator=g).to(cuda)
    res = torch.randn(333, 2304, generator=g).to(cuda, torch.bfloat16)
    for epi in ("bias", "gelu_tanh", "gelu_erf", "residual"):
        r = res if epi == "residual" else None
        got = kernels.gemm(a, w, bias, epi, r)
        want = kernels.gemm_plain(a, w, bias, epi, r)
        if epi == "residual":  # f32 out: summation order only
            assert within_band(got, want, atol=1e-3, rtol=0.0), epi
        else:
            assert within_band(got, want), epi


def test_cuda_tensors_launch_or_raise(cuda):
    """A CUDA tensor the kernels do not take raises; it never runs the plain version."""
    x, ws, _ = attn_inputs(7, **FULL)
    wt = _to(ws, cuda, [torch.bfloat16, torch.float32, torch.bfloat16] + [torch.float32] * 3)
    before = attention_block.launches
    with pytest.raises(ValueError, match="dtype"):
        attention_block(torch.from_numpy(x).to(cuda), *wt, 12)  # f32 activations
    x2d = torch.from_numpy(x).to(cuda, torch.bfloat16).reshape(-1, 768)
    with pytest.raises(ValueError, match="N %"):
        kernels.gemm(x2d, wt[0][:, :100].contiguous(), wt[1][:100].contiguous())
    assert attention_block.launches == before
    attention_block(x2d.reshape(8, 40, 768), *wt, 12)
    torch.cuda.synchronize()
    assert attention_block.launches == before + 1
