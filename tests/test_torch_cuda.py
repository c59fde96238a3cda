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

import dataclasses
import itertools

import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import dropout, kernels, train_blocks
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention import mask_to_bias
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention_block import (
    attention_block,
    attention_block_plain,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.cross_attention_block import (
    cross_attention_block,
    cross_attention_block_plain,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.dual_cross_attention_block import (
    dual_cross_attention_block,
    dual_cross_attention_block_plain,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.encoder_layer import (
    encoder_layer,
    encoder_layer_plain,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.ffn_block import ffn_block, ffn_block_plain
from torch_parity import attn_inputs, cuda, ffn_inputs  # noqa: F401  (cuda: fixture)

from chip_smoke import gemm_sites

CARD_ATOL, CARD_RTOL = 1.6e-2, 2.0**-6
F32_OUT_BAND = 1e-3  # f32 outputs of the GEMM (summation order only), abs


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


# Every gemm_bf16 launch shape (M, N, K) of the driven paths (chip_smoke.py:gemm_sites: B*S rows of
# ImageBERT-A, -B and LXMERT at B=512, training at B=256, the label conv), and M = 333 at each (N, K)
_SITE_SHAPES = sorted({(m, n, k) for _, _, m, n, k, *_ in gemm_sites()})
GEMM_SHAPES = _SITE_SHAPES + sorted({(333, n, k) for _, n, k in _SITE_SHAPES})


@pytest.mark.parametrize("trans_b", [False, True], ids=["w", "wT"])
@pytest.mark.parametrize("epilogue", list(kernels.EPILOGUES))
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES, ids=[f"{m}x{n}x{k}" for m, n, k in GEMM_SHAPES])
def test_cuda_gemm_ragged_rows(cuda, m, n, k, epilogue, trans_b):
    """Every epilogue in both weight layouts at each (M, N, K) the paths launch and at M = 333: B*S
    rows need not fill the 128-row tile, so rows past M are zero-filled on load, read as zero from the
    residual and aux, and never stored. Bands: two bf16 ulps on bf16 outputs, F32_OUT_BAND on f32."""
    g = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w = (k**-0.5 * torch.randn(*((n, k) if trans_b else (k, n)), generator=g, device=cuda)).to(torch.bfloat16)
    bias = torch.randn(n, generator=g, device=cuda)
    res = torch.randn(m, n, generator=g, device=cuda).to(torch.bfloat16) if epilogue == "residual" else None
    aux = torch.randn(m, n, generator=g, device=cuda) if epilogue in kernels.AUX_IN else None
    got = kernels.gemm(a, w, bias, epilogue, res, aux, trans_b)
    want = kernels.gemm_plain(a, w, bias, epilogue, res, aux, trans_b)
    if epilogue in kernels.SAVE:
        assert got[0].shape == (m, n) and within_band(got[0], want[0])
        assert within_band(got[1], want[1], atol=F32_OUT_BAND, rtol=0.0)
    elif epilogue in kernels.F32_OUT:
        assert got.dtype == torch.float32 and within_band(got, want, atol=F32_OUT_BAND, rtol=0.0)
    else:
        assert got.shape == (m, n) and within_band(got, want)


def test_cuda_tensors_launch_or_raise(cuda):
    """A CUDA tensor the kernels do not take raises; it never runs the plain version."""
    x, ws, _ = attn_inputs(7, **FULL)
    wt = _to(ws, cuda, [torch.bfloat16, torch.float32, torch.bfloat16] + [torch.float32] * 3)
    before = attention_block.launches
    with pytest.raises(ValueError, match="dtype"):
        attention_block(torch.from_numpy(x).to(cuda), *wt, 12)  # f32 activations
    x2d = torch.from_numpy(x).to(cuda, torch.bfloat16).reshape(-1, 768)
    gemms = kernels.gemm.launches
    with pytest.raises(ValueError, match="N %"):
        kernels.gemm(x2d, wt[0][:, :100].contiguous(), wt[1][:100].contiguous())
    with pytest.raises(ValueError, match="K % 64"):  # a multiple of 32 (the rule before), not of the 64-deep stage
        kernels.gemm(x2d[:, :96].contiguous(), wt[0][:96].contiguous(), wt[1])
    assert attention_block.launches == before and kernels.gemm.launches == gemms
    attention_block(x2d.reshape(8, 40, 768), *wt, 12)
    torch.cuda.synchronize()
    assert attention_block.launches == before + 1


# LXMERT's x-layer shapes: lang F=23, visn T=10, H=768, 12 heads
LENGTHS = [(23, 10), (10, 23)]
LENGTH_IDS = ["lang<-visn", "visn<-lang"]
MASKS = ["no-mask", "mask", "all-masked-row"]


def _cross_case(device, seed, f, t, masks, b=8, h=768):
    """x [b, f, H] and ctx [b, t, H] bf16, the cross weights (wq, bq, wkv, bkv,
    wo, bo, gamma, beta), and the two streams' key-mask biases: None, ragged
    (at least one live key a row), or ragged with pair 0's keys all masked."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, f, h, generator=g).to(device, torch.bfloat16)
    ctx = torch.randn(b, t, h, generator=g).to(device, torch.bfloat16)
    ws = []
    for name, shape in (("wq", (h, h)), ("bq", (h,)), ("wkv", (h, 2 * h)), ("bkv", (2 * h,)),
                        ("wo", (h, h)), ("bo", (h,)), ("gamma", (h,)), ("beta", (h,))):
        noise = torch.randn(*shape, generator=g)
        if name == "gamma":
            ws.append((1.0 + 0.1 * noise).to(device))
        elif name.startswith("w"):
            ws.append((0.8 / shape[0] ** 0.5 * noise).to(device, torch.bfloat16))
        else:
            ws.append((0.05 * noise).to(device))
    biases = [None, None]
    if masks != "no-mask":
        biases = []
        for s in (f, t):
            m = (torch.rand(b, s, generator=g) > 0.3).float()
            m[:, 0] = 1.0
            if masks == "all-masked-row":
                m[0] = 0.0
            biases.append(mask_to_bias(m).to(device))
    return x, ctx, ws, biases


def _fused(ws):
    wq, bq, wkv, bkv, *rest = ws
    return [torch.cat([wq, wkv], dim=1), torch.cat([bq, bkv]), *rest]


@pytest.mark.parametrize("masks", MASKS)
@pytest.mark.parametrize("f,t", LENGTHS, ids=LENGTH_IDS)
def test_cuda_attn_core_cross_and_dual_match_plain(cuda, f, t, masks):
    g = torch.Generator(device="cpu").manual_seed(8)
    b, h = 8, 768
    lqkv, vqkv = (torch.randn(b * s, 3 * h, generator=g).to(cuda, torch.bfloat16) for s in (f, t))
    _, _, _, (lb, vb) = _cross_case(cuda, 9, f, t, masks)
    q, kv = lqkv[:, :h].contiguous(), vqkv[:, h:].contiguous()
    got = kernels.attn_core_cross(q, kv, vb, b, f, t, 12)
    assert within_band(got, kernels.attn_core_cross_plain(q, kv, vb, b, f, t, 12))
    for g_, w_ in zip(kernels.attn_core_dual(lqkv, vqkv, lb, vb, b, f, t, 12),
                      kernels.attn_core_dual_plain(lqkv, vqkv, lb, vb, b, f, t, 12)):
        assert within_band(g_, w_)


def test_cuda_attn_core_self_is_the_cross_case(cuda):
    """The self-attention entry point equals the cross one on the same buffer, bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(10)
    qkv = torch.randn(8 * 40, 3 * 768, generator=g).to(cuda, torch.bfloat16)
    got = kernels.attn_core(qkv, None, 8, 40, 12)
    want = kernels.attn_core_cross(qkv[:, :768].contiguous(), qkv[:, 768:].contiguous(), None, 8, 40, 40, 12)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("masks", MASKS)
@pytest.mark.parametrize("f,t", LENGTHS, ids=LENGTH_IDS)
def test_cuda_cross_blocks_match_plain(cuda, f, t, masks):
    x, ctx, ws, (lb, vb) = _cross_case(cuda, 11, f, t, masks)
    got = cross_attention_block(x, ctx, *ws, 12, vb)
    assert within_band(got, cross_attention_block_plain(x, ctx, *ws, 12, vb))
    got_l, got_v = dual_cross_attention_block(x, ctx, *_fused(ws), 12, lb, vb)
    want_l, want_v = dual_cross_attention_block_plain(x, ctx, *_fused(ws), 12, lb, vb)
    assert within_band(got_l, want_l) and within_band(got_v, want_v)


def test_cuda_cross_tensors_launch_or_raise(cuda):
    """CUDA tensors the new wrappers do not take raise, and never run the plain version."""
    x, ctx, ws, (lb, vb) = _cross_case(cuda, 12, 23, 10, "mask")
    counted = (kernels.attn_core_cross, kernels.attn_core_dual, cross_attention_block, dual_cross_attention_block)
    before = [w.launches for w in counted]
    with pytest.raises(ValueError, match="dtype"):
        cross_attention_block(x.float(), ctx.float(), *ws, 12, vb)  # f32 activations
    with pytest.raises(ValueError, match="expected cuda"):
        dual_cross_attention_block(x, ctx, *_fused(ws), 12, lb.cpu(), vb)  # a key mask left on the CPU
    with pytest.raises(ValueError, match="S <="):
        long = torch.zeros(8 * 65, 768, device=cuda, dtype=torch.bfloat16)
        kernels.attn_core_cross(long, torch.zeros(8 * 10, 1536, device=cuda, dtype=torch.bfloat16), None,
                                8, 65, 10, 12)
    with pytest.raises(ValueError, match="kv shape"):
        kernels.attn_core_cross(x.reshape(-1, 768), ctx.reshape(-1, 768), vb, 8, 23, 10, 12)
    assert [w.launches for w in counted] == before
    cross_attention_block(x, ctx, *ws, 12, vb)
    dual_cross_attention_block(x, ctx, *_fused(ws), 12, lb, vb)
    torch.cuda.synchronize()
    assert [w.launches for w in counted] == [n + 1 for n in before]


# The attention core's lengths: every S the models use (S=40, 30, 23, 10), the tile edges of its
# 16-row fragments (1, 16, 48) and the longest it takes (64), at an odd batch of pairs
CORE_LENGTHS = [1, 10, 16, 23, 30, 40, 48, 64]
CORE_PAIRS = [(23, 10), (10, 23), (1, 64), (64, 1), (48, 16), (30, 40)]


def _core_case(device, seed, b, sq, sk, masks, h=768):
    """q rows [b*sq, 3H] and k/v rows [b*sk, 3H] bf16 (two QKV buffers), and the key biases of
    both streams: None, ragged (key 0 live), or ragged with pair 0's keys all masked."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv_q, qkv_k = (torch.randn(b * s, 3 * h, generator=g).to(device, torch.bfloat16) for s in (sq, sk))
    biases = [None, None]
    if masks != "no-mask":
        biases = []
        for s in (sq, sk):
            m = (torch.rand(b, s, generator=g) > 0.3).float()
            m[:, 0] = 1.0
            if masks == "all-masked-row":
                m[0] = 0.0
            biases.append(mask_to_bias(m).to(device))
    return qkv_q, qkv_k, biases


@pytest.mark.parametrize("masks", MASKS)
@pytest.mark.parametrize("s", CORE_LENGTHS)
def test_cuda_attn_core_lengths_match_plain(cuda, s, masks):
    """Self-attention on the tensor cores at each length, 5 pairs: rows past S are padding of the
    16-row tiles, keys past S are -inf, an all-masked row is an ordinary softmax."""
    qkv, _, (bias, _) = _core_case(cuda, 23, 5, s, s, masks)
    got = kernels.attn_core(qkv, bias, 5, s, 12)
    assert got.shape == (5 * s, 768)
    assert within_band(got, kernels.attn_core_plain(qkv, bias, 5, s, 12))


@pytest.mark.parametrize("masks", MASKS)
@pytest.mark.parametrize("sq,sk", CORE_PAIRS, ids=[f"{a}<-{b}" for a, b in CORE_PAIRS])
def test_cuda_attn_core_cross_lengths_match_plain(cuda, sq, sk, masks):
    """Cross-attention with Sq != Sk (q and k/v at their own row strides), and the dual launch
    doing both directions, 5 pairs."""
    qkv_q, qkv_k, (qb, kb) = _core_case(cuda, 24, 5, sq, sk, masks)
    q, kv = qkv_q[:, :768].contiguous(), qkv_k[:, 768:].contiguous()
    got = kernels.attn_core_cross(q, kv, kb, 5, sq, sk, 12)
    assert got.shape == (5 * sq, 768)
    assert within_band(got, kernels.attn_core_cross_plain(q, kv, kb, 5, sq, sk, 12))
    for g_, w_ in zip(kernels.attn_core_dual(qkv_q, qkv_k, qb, kb, 5, sq, sk, 12),
                      kernels.attn_core_dual_plain(qkv_q, qkv_k, qb, kb, 5, sq, sk, 12)):
        assert within_band(g_, w_)


# ImageBERT-B/C's fused encoder layer (KMR_FUSED_LAYER=1) and its label conv. The four shapes of
# the layer: (S, key mask, tanh GELU); "all-masked-tail" gives every other pair no box, so all
# its keys past the query are masked, as an ImageBERT-B pair with no box
LAYER_CASES = [(40, "no-mask", True), (30, "all-masked-tail", True), (23, "mask", False), (10, "mask", False)]
LAYER_IDS = ["S40-tanh", "S30-mask-tanh", "S23-mask-erf", "S10-mask-erf"]


def _layer_case(device, seed, s, masks, b=8, h=768, i=3072):
    """x [b, s, H] bf16, the layer's weights (wqkv, bqkv, wo, bo, g1, be1,
    w1, b1, w2, b2, g2, be2) and its key-mask bias [b, s] or None."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, s, h, generator=g).to(device, torch.bfloat16)
    ws = []
    for name, shape in (("wqkv", (h, 3 * h)), ("bqkv", (3 * h,)), ("wo", (h, h)), ("bo", (h,)), ("gamma", (h,)),
                        ("beta", (h,)), ("w1", (h, i)), ("b1", (i,)), ("w2", (i, h)), ("b2", (h,)),
                        ("gamma", (h,)), ("beta", (h,))):
        noise = torch.randn(*shape, generator=g)
        if name == "gamma":
            ws.append((1.0 + 0.1 * noise).to(device))
        elif name.startswith("w"):
            ws.append((0.8 / shape[0] ** 0.5 * noise).to(device, torch.bfloat16))
        else:
            ws.append((0.05 * noise).to(device))
    bias = None
    if masks != "no-mask":
        m = (torch.rand(b, s, generator=g) > 0.3).float()
        m[:, 0] = 1.0
        if masks == "all-masked-tail":
            m[::2, 20:] = 0.0
        bias = mask_to_bias(m).to(device)
    return x, ws, bias


@pytest.mark.parametrize("s,masks,tanh", LAYER_CASES, ids=LAYER_IDS)
def test_cuda_encoder_layer_and_tail_match_plain(cuda, s, masks, tanh):
    x, ws, bias = _layer_case(cuda, 13, s, masks)
    got = encoder_layer(x, *ws, 12, bias, approximate_gelu=tanh)
    assert within_band(got, encoder_layer_plain(x, *ws, 12, bias, approximate_gelu=tanh))
    ctx = torch.randn(x.shape[0] * s, 768, generator=torch.Generator().manual_seed(14)).to(cuda, torch.bfloat16)
    x2d = x.reshape(-1, 768)
    got = kernels.layer_tail(ctx, x2d, *ws[2:], approximate_gelu=tanh)
    assert within_band(got, kernels.layer_tail_plain(ctx, x2d, *ws[2:], approximate_gelu=tanh))


def test_cuda_layer_tail_ragged_rows(cuda):
    """M = 333 rows: the last 32-row tile is zero-filled on load and masked on store, and its
    cluster's second CTA holds no row at all."""
    x, ws, _ = _layer_case(cuda, 15, 37, "no-mask", b=9)
    x2d = x.reshape(-1, 768)
    ctx = torch.randn(333, 768, generator=torch.Generator().manual_seed(16)).to(cuda, torch.bfloat16)
    got = kernels.layer_tail(ctx, x2d, *ws[2:])
    assert got.shape == (333, 768)
    assert within_band(got, kernels.layer_tail_plain(ctx, x2d, *ws[2:]))


# layer_tail's row counts: one row, a whole and a ragged 64-row cluster tile, M = 333, ImageBERT-B's
# 15,360 (B=512, S=30)
TAIL_ROWS = [1, 64, 65, 333, 15360]


@pytest.mark.parametrize("tanh", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("m", TAIL_ROWS)
def test_cuda_layer_tail_rows_match_plain(cuda, m, tanh):
    """Rows past M arrive as zeros and are never stored, whichever CTA of a cluster holds them."""
    _, ws, _ = _layer_case(cuda, 25, 1, "no-mask", b=1)
    g = torch.Generator().manual_seed(26)
    ctx, x2d = (torch.randn(m, 768, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
    got = kernels.layer_tail(ctx, x2d, *ws[2:], approximate_gelu=tanh)
    assert got.shape == (m, 768)
    assert within_band(got, kernels.layer_tail_plain(ctx, x2d, *ws[2:], approximate_gelu=tanh))


@pytest.mark.parametrize("i", [64, 256, 320, 448, 3072])
def test_cuda_layer_tail_ffn_widths(cuda, i):
    """Any I % 64 == 0: the FFN runs in chunks of the kernel's width, the last one narrower."""
    x, ws, _ = _layer_case(cuda, 27, 30, "no-mask", b=3, i=i)
    ctx = torch.randn(90, 768, generator=torch.Generator().manual_seed(28)).to(cuda, torch.bfloat16)
    x2d = x.reshape(-1, 768)
    got = kernels.layer_tail(ctx, x2d, *ws[2:])
    assert within_band(got, kernels.layer_tail_plain(ctx, x2d, *ws[2:]))


def test_cuda_gemm_f32_epilogue_label_conv(cuda):
    """The banded label conv's shape: [B*10, 8H] @ [8H, 8H] -> f32, the JAX dot's rounding."""
    g = torch.Generator(device="cpu").manual_seed(17)
    a = torch.randn(8 * 10, 8 * 768, generator=g).to(cuda, torch.bfloat16)
    w = (0.02 * torch.randn(8 * 768, 8 * 768, generator=g)).to(cuda, torch.bfloat16)
    bias = torch.randn(8 * 768, generator=g).to(cuda)
    got = kernels.gemm(a, w, bias, "f32")
    assert got.dtype == torch.float32
    assert within_band(got, kernels.gemm_plain(a, w, bias, "f32"), atol=1e-3, rtol=0.0)


def test_cuda_layer_tensors_launch_or_raise(cuda):
    """CUDA tensors the fused layer does not take raise, and never run the plain version."""
    x, ws, bias = _layer_case(cuda, 18, 30, "mask")
    counted = (kernels.layer_tail, encoder_layer)
    before = [w.launches for w in counted]
    with pytest.raises(ValueError, match="dtype"):
        encoder_layer(x.float(), *ws, 12, bias)  # f32 activations
    with pytest.raises(ValueError, match="I %"):
        kernels.layer_tail(x.reshape(-1, 768), x.reshape(-1, 768), *ws[2:6], ws[6][:, :100].contiguous(),
                           ws[7][:100].contiguous(), ws[8][:100].contiguous(), *ws[9:])
    with pytest.raises(ValueError, match="expected cuda"):
        kernels.layer_tail(x.reshape(-1, 768), x.reshape(-1, 768), *ws[2:5], ws[5].cpu(), *ws[6:])
    assert [w.launches for w in counted] == before
    encoder_layer(x, *ws, 12, bias)
    torch.cuda.synchronize()
    assert [w.launches for w in counted] == [n + 1 for n in before]


@pytest.mark.parametrize("s,masks,tanh", LAYER_CASES, ids=LAYER_IDS)
def test_cuda_encoder_layer_equals_two_blocks(cuda, s, masks, tanh):
    """The fused layer rounds as the two-block route does: its products
    accumulate in gemm_bf16's k order and its LayerNorms repeat layernorm.cu's
    arithmetic, so the two routes agree bit for bit."""
    x, ws, bias = _layer_case(cuda, 19, s, masks)
    fused = encoder_layer(x, *ws, 12, bias, approximate_gelu=tanh)
    two = ffn_block(attention_block(x, *ws[:6], 12, bias), *ws[6:], approximate_gelu=tanh)
    torch.cuda.synchronize()
    assert torch.equal(fused, two)


# The attention backends' kernels (csrc/mha.cu): bare attention on [B, N, S, 64] views and on the
# packed [B, S, H] layout, bf16 (tensor cores, a warp a (pair, head)) and f32 (CUDA cores). Cases:
# (S, bias, N) with the bias as the models make it: none (ImageBERT-A), a [B,1,1,S] key mask with some
# pairs' tail keys all masked (ImageBERT-B), a full [B,1,S,S] bias, a per-head [B,N,S,S] bias (mha
# only), and S=64, the longest the kernel takes; then the ragged shapes, every N of {1, 3, 12} at every
# S of {1, 16, 17, 23} (one row past a 16-row tile, an odd head count), the bias kinds in turn
MHA_CASES = [(40, "none", 12), (30, "key", 12), (30, "query-key", 12), (30, "heads", 12), (64, "key", 12),
             (7, "none", 12)]
MHA_IDS = ["S40", "S30-key-mask", "S30-B1SS", "S30-BNSS", "S64-key-mask", "S7"]
MHA_BIAS_KINDS = ["none", "key", "query-key", "heads"]
MHA_RAGGED = [(s, MHA_BIAS_KINDS[i % 4], n) for i, (n, s) in enumerate(itertools.product((1, 3, 12), (1, 16, 17, 23)))]
MHA_CASES += MHA_RAGGED
MHA_IDS += [f"N{n}-S{s}-{kind}" for s, kind, n in MHA_RAGGED]
MHA_F32_BAND = 1e-5


def _mha_case(device, seed, s, bias_kind, dtype, b=6, n=12):
    """q, k, v as packed [b, s, n * 64] buffers and as contiguous [b, n, s, 64]
    heads, in dtype, and the f32 bias (or None)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    packed = [torch.randn(b, s, n * 64, generator=g).to(device, dtype) for _ in range(3)]
    heads = [t.reshape(b, s, n, 64).transpose(1, 2).contiguous() for t in packed]
    bias = None
    if bias_kind != "none":
        m = (torch.rand(b, s, generator=g) > 0.3).float()
        m[:, 0] = 1.0
        m[::2, s // 2:] = 0.0
        bias = mask_to_bias(m)[:, None, None, :]
        if bias_kind == "query-key":
            bias = bias + torch.randn(b, 1, s, s, generator=g)
        elif bias_kind == "heads":
            bias = bias + torch.randn(b, n, s, s, generator=g)
        bias = bias.to(device)
    return packed, heads, bias


def _mha_band(dtype):
    return {"atol": MHA_F32_BAND, "rtol": 0.0} if dtype == torch.float32 else {}


def _check_mha(packed, heads, bias, n, dtype):
    got = kernels.mha(*heads, bias)
    assert got.dtype == dtype and got.shape == heads[0].shape
    assert within_band(got, kernels.mha_plain(*heads, bias), **_mha_band(dtype))
    if bias is None or bias.shape[1] == 1:
        got = kernels.mha_packed(*packed, n, bias)
        assert got.dtype == dtype and got.shape == packed[0].shape
        assert within_band(got, kernels.mha_packed_plain(*packed, n, bias), **_mha_band(dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("s,bias_kind,n", MHA_CASES, ids=MHA_IDS)
def test_cuda_mha_matches_plain(cuda, s, bias_kind, n, dtype):
    packed, heads, bias = _mha_case(cuda, 20, s, bias_kind, dtype, n=n)
    _check_mha(packed, heads, bias, n, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("bias_kind", ["key", "query-key"])
def test_cuda_mha_all_keys_masked(cuda, bias_kind, dtype):
    """Pairs whose every key is masked (-10000) get an ordinary softmax over
    the masked scores: finite, and equal to the plain path within the band."""
    packed, heads, bias = _mha_case(cuda, 23, 30, bias_kind, dtype, n=3)
    bias = bias.clone()
    bias[::3] = -10000.0
    _check_mha(packed, heads, bias, 3, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_mha_ragged_items(cuda, dtype):
    """B*N = 21 (pairs, heads) items: odd, and one more than a multiple of the
    items a CTA of the bf16 kernel holds, so its last CTA has one live warp."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import _build

    b, n = 7, 3
    assert b * n % _build.load("mha").kmr_mha_warps() == 1
    packed, heads, bias = _mha_case(cuda, 24, 17, "key", dtype, b=b, n=n)
    _check_mha(packed, heads, bias, n, dtype)


def test_cuda_mha_reads_strided_views(cuda):
    """The "pallas" route hands mha the split_heads views of one [B, S, 3H]
    projection; the kernel reads them in place, bit-equal to contiguous copies,
    and mha_packed on the packed buffers equals mha on the head views."""
    g = torch.Generator(device="cpu").manual_seed(21)
    qkv = torch.randn(6, 30, 3 * 768, generator=g).to(cuda, torch.bfloat16)
    views = [t.reshape(6, 30, 12, 64).transpose(1, 2) for t in qkv.chunk(3, dim=-1)]
    bias = mask_to_bias((torch.rand(6, 30, generator=g) > 0.3).float()).to(cuda)[:, None, None, :]
    got = kernels.mha(*views, bias)
    want = kernels.mha(*[v.contiguous() for v in views], bias)
    packed = kernels.mha_packed(*[t.contiguous() for t in qkv.chunk(3, dim=-1)], 12, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(packed, got.transpose(1, 2).reshape(6, 30, 768))


def test_cuda_mha_launch_or_raise(cuda):
    """Shapes and types the mha kernels do not take raise, naming the shape,
    and never run the plain version; cross attention (k longer or shorter
    than q) raises as the JAX kernel fails."""
    counted = (kernels.mha, kernels.mha_packed)
    before = [w.launches for w in counted]
    q = torch.zeros(2, 12, 30, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"head dim 64, got q \(2, 12, 30, 32\)"):
        kernels.mha(*[torch.zeros(2, 12, 30, 32, device=cuda, dtype=torch.bfloat16)] * 3)
    with pytest.raises(ValueError, match=r"S <= 64, got q \(2, 12, 65, 64\)"):
        kernels.mha(*[torch.zeros(2, 12, 65, 64, device=cuda, dtype=torch.bfloat16)] * 3)
    with pytest.raises(ValueError, match="bf16 or f32"):
        kernels.mha(*[q.half()] * 3)
    with pytest.raises(ValueError, match="one shape"):
        kernels.mha(q, q[:, :, :10], q[:, :, :10])
    with pytest.raises(ValueError, match="one shape"):
        kernels.mha_packed(q[:, 0], q[:, 0, :10], q[:, 0, :10], 1)
    with pytest.raises(ValueError, match="does not broadcast"):
        kernels.mha(q, q, q, torch.zeros(2, 1, 1, 29, device=cuda))
    with pytest.raises(ValueError, match="expected cuda"):
        kernels.mha(q, q, q, torch.zeros(2, 1, 1, 30))
    assert [w.launches for w in counted] == before
    kernels.mha(q, q, q)
    kernels.mha_packed(q.transpose(1, 2).reshape(2, 30, 768), *[q.transpose(1, 2).reshape(2, 30, 768)] * 2, 12)
    torch.cuda.synchronize()
    assert [w.launches for w in counted] == [n + 1 for n in before]


def test_cuda_pallas_packed_export_round_trip(cuda, tmp_path):
    """One full-width ImageBERT-A layer exported with the "pallas_packed"
    backend on the card, reloaded: bit-equal to the engine's default route on
    the same batch, through the same kernels."""
    import numpy as np

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.batchspec import example_batch
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.serving import export_scorer, load_scorer, save_scorer

    spec = get_model("imagebert_a", overrides={"num_hidden_layers": 1})
    params = spec.init_params(0)
    engine = ScoringEngine(spec, params, device=cuda, precision=Precision.bf16())
    assert engine.attention_backend == "pallas_packed"
    batch = example_batch("imagebert_a", spec.config, 8, np.random.default_rng(22))
    meta = save_scorer(tmp_path / "art", export_scorer(spec, params, 8, Precision.bf16(), "pallas_packed", cuda),
                       spec, 8, "pallas_packed")
    assert meta["custom_ops"] == ["kmr::attn_core", "kmr::gemm", "kmr::layernorm"] and meta["device"] == "cuda:0"
    scorer = load_scorer(tmp_path / "art")
    before = kernels.gemm.launches
    got = scorer(batch)
    torch.cuda.synchronize()
    assert kernels.gemm.launches == before + 4
    want = engine.score_batch(batch).float().cpu().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(scorer({k: v[:5] for k, v in batch.items()}), want[:5])


# ---- the training kernels (csrc/ln_train.cu, csrc/attn_train.cu, gemm_bf16's transposed-weight mode) ----

TRAIN_RATES = [0.0, 0.1, 0.5]
# (trans_b, epilogue, M, N, K, with bias): the products of the train blocks' forward and backward
GEMM_TRAIN_CASES = [
    (False, "gelu_tanh_save", 333, 3072, 768, True), (False, "gelu_erf_save", 333, 3072, 768, True),
    (False, "f32", 333, 768, 3072, True), (True, "bias", 333, 768, 768, False),
    (True, "gelu_bwd_tanh", 333, 3072, 768, False), (True, "gelu_bwd_erf", 333, 3072, 768, False),
    (True, "residual_f32", 333, 768, 3072, False), (True, "residual_f32", 333, 768, 2304, False),
]


def rel_l2(got, want) -> float:
    torch.cuda.synchronize()
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("trans_b,epilogue,m,n,k,with_bias", GEMM_TRAIN_CASES)
def test_cuda_gemm_train_epilogues(cuda, trans_b, epilogue, m, n, k, with_bias):
    g = torch.Generator(device="cpu").manual_seed(8)
    a = torch.randn(m, k, generator=g).to(cuda, torch.bfloat16)
    w = (0.05 * torch.randn(*((n, k) if trans_b else (k, n)), generator=g)).to(cuda, torch.bfloat16)
    bias = torch.randn(n, generator=g).to(cuda) if with_bias else None
    aux = torch.randn(m, n, generator=g).to(cuda) if epilogue in kernels.AUX_IN else None
    got = kernels.gemm(a, w, bias, epilogue, aux=aux, trans_b=trans_b)
    want = kernels.gemm_plain(a, w, bias, epilogue, aux=aux, trans_b=trans_b)
    if epilogue in kernels.SAVE:
        assert within_band(got[0], want[0]) and within_band(got[1], want[1], atol=1e-3, rtol=0.0)
    elif epilogue == "f32":
        assert within_band(got, want, atol=1e-3, rtol=0.0)
    else:
        assert within_band(got, want)


@pytest.mark.parametrize("rate", TRAIN_RATES)
def test_cuda_ln_train_matches_plain(cuda, rate):
    g = torch.Generator(device="cpu").manual_seed(9)
    m, h, rows = 8 * 40, 768, 4 * 40
    hh = torch.randn(m, h, generator=g).to(cuda)
    x = torch.randn(m, h, generator=g).to(cuda, torch.bfloat16)
    dy = torch.randn(m, h, generator=g).to(cuda, torch.bfloat16)
    gamma, beta = (1.0 + 0.1 * torch.randn(h, generator=g)).to(cuda), (0.1 * torch.randn(h, generator=g)).to(cuda)
    assert within_band(kernels.ln_train(hh, x, gamma, beta, 77, rate, rows),
                       kernels.ln_train_plain(hh, x, gamma, beta, 77, rate, rows))
    got = kernels.ln_train_bwd(hh, x, dy, gamma, 77, rate, rows)
    want = kernels.ln_train_bwd_plain(hh, x, dy, gamma, 77, rate, rows)
    assert within_band(got[0], want[0], atol=1e-4, rtol=1e-4)  # dz, f32
    assert within_band(got[1], want[1])  # dh, bf16
    assert within_band(got[2], want[2], atol=1e-3, rtol=1e-4) and within_band(got[3], want[3], atol=1e-3, rtol=1e-4)
    # the same units dropped: dh is 0 exactly where the hash drops
    assert torch.equal(got[1] == 0, want[1] == 0)
    if rate > 0:
        assert torch.equal(got[1] == 0, ~dropout.hidden_keep(77, rate, m, h, rows, cuda))


def _attn_train_case(device, seed, b=8, s=40, n=12, identity_v=False):
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(b * s, 3 * n * 64, generator=g)
    if identity_v:  # each head's V rows are the identity: ctx = the dropped probs themselves
        v = torch.zeros(b, s, n, 64)
        v[:, torch.arange(s), :, torch.arange(s)] = 1.0
        qkv[:, 2 * n * 64:] = v.reshape(b * s, n * 64)
    m = (torch.rand(b, s, generator=g) > 0.3).float()
    m[:, 0] = 1.0
    dctx = torch.randn(b * s, n * 64, generator=g)
    return qkv.to(device, torch.bfloat16), mask_to_bias(m).to(device), dctx.to(device, torch.bfloat16)


@pytest.mark.parametrize("block", [8, 4])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("rate", TRAIN_RATES)
def test_cuda_attn_train_matches_plain(cuda, rate, with_mask, block):
    qkv, bias, dctx = _attn_train_case(cuda, 10)
    bias = bias if with_mask else None
    args = (8, 40, 12, 55, rate, block)
    assert within_band(kernels.attn_train(qkv, bias, *args), kernels.attn_train_plain(qkv, bias, *args))
    assert within_band(kernels.attn_train_bwd(qkv, dctx, bias, *args),
                       kernels.attn_train_bwd_plain(qkv, dctx, bias, *args))


def test_cuda_attn_train_drops_the_hash_units(cuda):
    """With V = I per head, ctx holds the dropped probabilities: the kernel zeroes
    exactly the units of head h's draw, at rate 0.5."""
    qkv, _, _ = _attn_train_case(cuda, 11, identity_v=True)
    b, s, n = 8, 40, 12
    got = kernels.attn_train(qkv, None, b, s, n, 123, 0.5, 8).reshape(b, s, n, 64)[..., :s].permute(0, 2, 1, 3)
    want = kernels.attn_train_plain(qkv, None, b, s, n, 123, 0.5, 8).reshape(b, s, n, 64)[..., :s].permute(0, 2, 1, 3)
    keep = dropout.cross_probs_keep(123, 0.5, b, n, s, s, 8, cuda)
    torch.cuda.synchronize()
    assert torch.equal(got == 0, ~keep) and torch.equal(want == 0, ~keep)


# the train attention kernels on the tensor cores: 16-row tiles, so lengths on each side of 16 and 32,
# the longest, and a one-key row; head counts 1, 3 and 12; B * N = 7 * 3 = 21 forward items, one more
# than a multiple of the forward's items a CTA, so its last CTA has one live warp
TRAIN_LENGTHS = [1, 15, 16, 17, 33, 40, 64]
TRAIN_PAIRS = [(23, 10), (10, 23), (64, 1), (1, 64)]
TRAIN_MASKS = ["no-mask", "all-masked-pair"]
TRAIN_HEADS = [(8, 12, 4), (7, 3, 7), (7, 1, 1)]  # (B, N, block)


def _attn_train_edge_case(device, seed, b, sq, sk, n, masks):
    """q [b*sq, 3H] (self: the QKV buffer), kv [b*sk, 2H], a ragged key mask of sk keys with pair 0's keys
    all masked (or None), dctx [b*sq, H]; H = n * 64."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = n * 64
    qkv, kv, dctx = (torch.randn(*shape, generator=g) for shape in ((b * sq, 3 * h), (b * sk, 2 * h), (b * sq, h)))
    bias = None
    if masks != "no-mask":
        m = (torch.rand(b, sk, generator=g) > 0.3).float()
        m[:, 0] = 1.0
        m[0] = 0.0
        bias = mask_to_bias(m).to(device)
    return [z.to(device, torch.bfloat16) for z in (qkv, kv)] + [bias, dctx.to(device, torch.bfloat16)]


@pytest.mark.parametrize("masks", TRAIN_MASKS)
@pytest.mark.parametrize("rate", TRAIN_RATES)
@pytest.mark.parametrize("s", TRAIN_LENGTHS)
def test_cuda_attn_train_lengths_match_plain(cuda, s, rate, masks):
    """Self-attention forward and backward at each length, 8 pairs, 12 heads: query rows past S are
    padding of the 16-row tiles, keys past S are -inf and draw nothing, an all-masked pair gets an
    ordinary softmax."""
    qkv, _, bias, dctx = _attn_train_edge_case(cuda, 30, 8, s, s, 12, masks)
    args = (8, s, 12, 55, rate, 4)
    got = kernels.attn_train(qkv, bias, *args)
    assert got.shape == (8 * s, 768)
    assert within_band(got, kernels.attn_train_plain(qkv, bias, *args))
    assert within_band(kernels.attn_train_bwd(qkv, dctx, bias, *args),
                       kernels.attn_train_bwd_plain(qkv, dctx, bias, *args))


@pytest.mark.parametrize("masks", TRAIN_MASKS)
@pytest.mark.parametrize("rate", TRAIN_RATES)
@pytest.mark.parametrize("f,t", TRAIN_PAIRS, ids=[f"{a}<-{b}" for a, b in TRAIN_PAIRS])
def test_cuda_attn_train_cross_lengths_match_plain(cuda, f, t, rate, masks):
    """Cross attention with Sq != Sk (queries and keys padded apart), forward and backward, 8 pairs."""
    qkv, kv, bias, dctx = _attn_train_edge_case(cuda, 31, 8, f, t, 12, masks)
    q = qkv[:, :768].contiguous()
    args = (8, f, t, 12, 55, rate, 8)
    assert within_band(kernels.attn_train_cross(q, kv, bias, *args), kernels.attn_train_cross_plain(q, kv, bias, *args))
    got = kernels.attn_train_cross_bwd(q, kv, dctx, bias, *args)
    want = kernels.attn_train_cross_bwd_plain(q, kv, dctx, bias, *args)
    assert got[0].shape == (8 * f, 768) and got[1].shape == (8 * t, 2 * 768)
    assert within_band(got[0], want[0]) and within_band(got[1], want[1])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,n,block", TRAIN_HEADS, ids=[f"B{b}-N{n}" for b, n, _ in TRAIN_HEADS])
def test_cuda_attn_train_head_counts_match_plain(cuda, b, n, block, rate):
    """Any head count, and B * N forward items that leave the last CTA ragged; self at S=17 and cross at
    40<-23, with the key mask."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import _build

    if b == 7 and n == 3:
        assert b * n % _build.load("attn_train").kmr_attn_train_fwd_warps() == 1
    h = n * 64
    qkv, _, bias, dctx = _attn_train_edge_case(cuda, 32, b, 17, 17, n, "all-masked-pair")
    args = (b, 17, n, 9, rate, block)
    assert within_band(kernels.attn_train(qkv, bias, *args), kernels.attn_train_plain(qkv, bias, *args))
    assert within_band(kernels.attn_train_bwd(qkv, dctx, bias, *args),
                       kernels.attn_train_bwd_plain(qkv, dctx, bias, *args))
    qkv, kv, bias, dctx = _attn_train_edge_case(cuda, 33, b, 40, 23, n, "all-masked-pair")
    q = qkv[:, :h].contiguous()
    args = (b, 40, 23, n, 9, rate, block)
    assert within_band(kernels.attn_train_cross(q, kv, bias, *args), kernels.attn_train_cross_plain(q, kv, bias, *args))
    for got, want in zip(kernels.attn_train_cross_bwd(q, kv, dctx, bias, *args),
                         kernels.attn_train_cross_bwd_plain(q, kv, dctx, bias, *args)):
        assert within_band(got, want)


def test_cuda_attn_train_is_deterministic(cuda):
    """No atomics: two runs of each entry point give the same bits."""
    qkv, kv, bias, dctx = _attn_train_edge_case(cuda, 34, 8, 40, 23, 12, "all-masked-pair")
    q = qkv[:, :768].contiguous()
    self_qkv, _, self_bias, self_dctx = _attn_train_edge_case(cuda, 35, 8, 40, 40, 12, "all-masked-pair")

    def cross_bwd():
        dq, dkv = kernels.attn_train_cross_bwd(q, kv, dctx, bias, 8, 40, 23, 12, 3, 0.1, 8)
        return torch.cat([dq.flatten(), dkv.flatten()])

    runs = [
        lambda: kernels.attn_train(self_qkv, self_bias, 8, 40, 12, 3, 0.1, 8),
        lambda: kernels.attn_train_bwd(self_qkv, self_dctx, self_bias, 8, 40, 12, 3, 0.1, 8),
        lambda: kernels.attn_train_cross(q, kv, bias, 8, 40, 23, 12, 3, 0.1, 8),
        cross_bwd,
    ]
    for run in runs:
        first, second = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.parametrize("s", [17, 64])
def test_cuda_attn_train_drops_the_hash_units_at_tile_edges(cuda, s):
    """With V = I per head, ctx holds the dropped probabilities; with dctx = I per head, dV holds their
    transpose: the forward and backward kernels zero exactly the units of head h's draw, at rate 0.5, at a
    length one past a tile and at the longest, and the backward recomputes the forward's dropped
    probabilities bit for bit."""
    b, n = 8, 12
    qkv, _, _, _ = _attn_train_edge_case(cuda, 36, b, s, s, n, "no-mask")
    eye = torch.zeros(b, s, n, 64, device=cuda)
    eye[:, torch.arange(s), :, torch.arange(s)] = 1.0
    eye = eye.reshape(b * s, n * 64).to(torch.bfloat16)
    qkv[:, 2 * n * 64:] = eye
    keep = dropout.cross_probs_keep(123, 0.5, b, n, s, s, 8, cuda)
    probs = []
    for fn in (kernels.attn_train, kernels.attn_train_plain):
        probs.append(fn(qkv, None, b, s, n, 123, 0.5, 8).reshape(b, s, n, 64)[..., :s].permute(0, 2, 1, 3))
        torch.cuda.synchronize()
        assert torch.equal(probs[-1] == 0, ~keep)
    dvs = []
    for fn in (kernels.attn_train_bwd, kernels.attn_train_bwd_plain):
        dv = fn(qkv, eye, None, b, s, n, 123, 0.5, 8)[:, 2 * n * 64:]
        dvs.append(dv.reshape(b, s, n, 64)[..., :s].permute(0, 2, 3, 1))  # [b, n, query, key]
        torch.cuda.synchronize()
        assert torch.equal(dvs[-1] == 0, ~keep)
    assert torch.equal(probs[0], dvs[0])  # the kernels' forward and backward probsd


def _train_block_case(device, kind, seed, b=8, s=40, h=768, i=3072):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, s, h, generator=g).to(device, torch.bfloat16)
    shapes = [(h, i), (i,), (i, h), (h,)] if kind == "ffn" else [(h, 3 * h), (3 * h,), (h, h), (h,)]
    ws = [(0.02 * torch.randn(*sh, generator=g)).to(device) for sh in shapes]
    ws += [(1.0 + 0.1 * torch.randn(h, generator=g)).to(device), (0.1 * torch.randn(h, generator=g)).to(device)]
    dy = torch.randn(b, s, h, generator=g).to(device, torch.bfloat16)
    return x, ws, dy


def _block_grads(fn, x, ws, dy):
    xt, wt = x.clone().requires_grad_(), [w.clone().requires_grad_() for w in ws]
    y = fn(xt, *wt)
    y.backward(dy)
    return y.detach(), [t.grad for t in (xt, *wt)]


# kernel Function vs the plain oracle's autograd, bf16: the oracle rounds its weight and GELU
# gradients to bf16 at its casts, the Function keeps them f32, so the gradients agree in relative L2
TRAIN_GRAD_REL_L2 = 2e-2


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["ffn", "attn"])
def test_cuda_train_blocks_match_the_oracle(cuda, kind, rate):
    x, ws, dy = _train_block_case(cuda, kind, 12)
    if kind == "ffn":
        fns = [lambda x, *w, f=f: f(x, *w, 42, dropout_rate=rate)
               for f in (train_blocks.ffn_block_train, train_blocks.ffn_block_train_plain)]
    else:
        mask = torch.ones(8, 40, device=cuda)
        mask[1, 30:] = 0.0
        bias = mask_to_bias(mask)
        fns = [lambda x, *w, f=f: f(x, *w, 12, 42, bias=bias, attn_dropout_rate=rate, hidden_dropout_rate=rate)
               for f in (train_blocks.attention_block_train, train_blocks.attention_block_train_plain)]
    (y, grads), (wy, wgrads) = (_block_grads(f, x, ws, dy) for f in fns)
    assert within_band(y, wy)
    assert grads[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in grads[1:])
    errs = [rel_l2(g, w) for g, w in zip(grads, wgrads)]
    assert max(errs) <= TRAIN_GRAD_REL_L2, errs


def test_cuda_train_blocks_launch_or_raise(cuda):
    x, ws, dy = _train_block_case(cuda, "ffn", 13)
    counters = (train_blocks.ffn_block_train, train_blocks.ffn_block_train_backward, kernels.gemm,
                kernels.ln_train, kernels.ln_train_bwd)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError, match="dtype"):
        train_blocks.ffn_block_train(x.float(), *ws, 1)  # f32 activations on the card
    _block_grads(lambda x, *w: train_blocks.ffn_block_train(x, *w, 1, dropout_rate=0.1), x, ws, dy)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 2 + 4, 1, 1]


# ---- ImageBERT-B/C training: S=30 with its key masks, the label conv's Function, the weight gradients ----


def _b_key_bias(device, b, seed):
    """ImageBERT-B's [b, 30] key-mask bias: query lengths 2..20, box counts 0..10, pair 0 with no box
    (its 10 image keys all masked) and pair 1 with all 10."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    len_query = torch.randint(2, 21, (b,), generator=g)
    num_boxes = torch.randint(0, 11, (b,), generator=g)
    num_boxes[0], num_boxes[1] = 0, 10
    keep = torch.cat([torch.arange(20)[None] < len_query[:, None], torch.arange(10)[None] < num_boxes[:, None]], 1)
    return mask_to_bias(keep.float()).to(device)


@pytest.mark.parametrize("rate", TRAIN_RATES)
def test_cuda_attn_train_b_masks_match_plain(cuda, rate):
    """attn_train forward and backward at S=30 (16-row tiles pad it to 32) with B's masks, a pair whose
    every box key is masked among them."""
    qkv, _, _, dctx = _attn_train_edge_case(cuda, 37, 8, 30, 30, 12, "no-mask")
    bias = _b_key_bias(cuda, 8, 38)
    assert bool((bias[0, 20:] == -10000.0).all())
    args = (8, 30, 12, 55, rate, 8)
    assert within_band(kernels.attn_train(qkv, bias, *args), kernels.attn_train_plain(qkv, bias, *args))
    assert within_band(kernels.attn_train_bwd(qkv, dctx, bias, *args),
                       kernels.attn_train_bwd_plain(qkv, dctx, bias, *args))


def test_cuda_b_train_block_matches_the_oracle(cuda):
    """The attention train block at S=30 with B's masks, forward and the 7 gradients."""
    x, ws, dy = _train_block_case(cuda, "attn", 14, s=30)
    bias = _b_key_bias(cuda, 8, 39)
    fns = [lambda x, *w, f=f: f(x, *w, 12, 42, bias=bias, attn_dropout_rate=0.1, hidden_dropout_rate=0.1)
           for f in (train_blocks.attention_block_train, train_blocks.attention_block_train_plain)]
    (y, grads), (wy, wgrads) = (_block_grads(f, x, ws, dy) for f in fns)
    assert within_band(y, wy)
    errs = [rel_l2(g, w) for g, w in zip(grads, wgrads)]
    assert max(errs) <= TRAIN_GRAD_REL_L2, errs


def test_cuda_band_conv_matches_its_plain_version(cuda):
    """ImageBERT-B's label conv as its training Function, [333, 8H] @ the band built from 8 f32 taps: the
    f32 output within F32_OUT_BAND, dx in the ulp band, the taps' and bias's gradients (f32 in the
    Function, bf16 at the oracle's casts) in relative L2; two gemm launches, forward and dx."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import band_conv

    g = torch.Generator(device="cpu").manual_seed(40)
    x = torch.randn(333, 8 * 768, generator=g).to(cuda, torch.bfloat16)
    taps, bias = (0.02 * torch.randn(8, 768, 768, generator=g)).to(cuda), (0.1 * torch.randn(768, generator=g)).to(cuda)
    dy = torch.randn(333, 8 * 768, generator=g).to(cuda)
    before = kernels.gemm.launches
    (y, grads), (wy, wgrads) = (_block_grads(lambda *a, f=f: f(*a, 3), x, [taps, bias], dy)
                                for f in (band_conv.band_conv_train, band_conv.band_conv_train_plain))
    torch.cuda.synchronize()
    assert kernels.gemm.launches - before == 2
    assert y.dtype == torch.float32 and within_band(y, wy, atol=F32_OUT_BAND, rtol=0.0)
    assert grads[0].dtype == torch.bfloat16 and within_band(grads[0], wgrads[0])
    assert all(gr.dtype == torch.float32 for gr in grads[1:])
    errs = [rel_l2(gr, w) for gr, w in zip(grads[1:], wgrads[1:])]
    assert max(errs) <= TRAIN_GRAD_REL_L2, errs


@pytest.mark.parametrize("m,k,n", [(7680, 768, 2304), (7680, 3072, 768), (2560, 6144, 6144)],
                         ids=["B-qkv", "B-ffn-down", "label-conv"])
def test_cuda_weight_grads_match_f32(cuda, m, k, n):
    """The weight-gradient glue on bf16 operands (one f32-out product, no f32 copies) against the f32
    product of the same bf16 values, TF32 off: summation order only."""
    g = torch.Generator(device="cpu").manual_seed(41)
    a, d = (torch.randn(m, c, generator=g).to(cuda, torch.bfloat16) for c in (k, n))
    dw, db = train_blocks.weight_grads(a, d)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = a.float().T @ d.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert dw.dtype == db.dtype == torch.float32 and dw.shape == (k, n)
    assert rel_l2(dw, want) <= 1e-5
    torch.testing.assert_close(db, d.float().sum(0), atol=1e-3, rtol=1e-5)


# ---- the train cross-attention kernels (csrc/attn_train.cu's cross entry points) and block ----


def _cross_train_case(device, seed, f, t, b=8, n=12):
    """q [b*f, H], kv [b*t, 2H], a key mask of kv's keys (pair 0 with every key masked), dctx."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = n * 64
    q, kv, dctx = (torch.randn(*shape, generator=g) for shape in ((b * f, h), (b * t, 2 * h), (b * f, h)))
    m = (torch.rand(b, t, generator=g) > 0.3).float()
    m[:, 0] = 1.0
    m[0] = 0.0
    return [z.to(device, torch.bfloat16) for z in (q, kv)] + [mask_to_bias(m).to(device), dctx.to(device, torch.bfloat16)]


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("f,t", LENGTHS, ids=LENGTH_IDS)
@pytest.mark.parametrize("rate", TRAIN_RATES)
def test_cuda_attn_train_cross_matches_plain(cuda, rate, f, t, with_mask):
    q, kv, bias, dctx = _cross_train_case(cuda, 14, f, t)
    bias = bias if with_mask else None
    args = (8, f, t, 12, 55, rate, 4)
    assert within_band(kernels.attn_train_cross(q, kv, bias, *args), kernels.attn_train_cross_plain(q, kv, bias, *args))
    got = kernels.attn_train_cross_bwd(q, kv, dctx, bias, *args)
    want = kernels.attn_train_cross_bwd_plain(q, kv, dctx, bias, *args)
    assert got[0].shape == (8 * f, 768) and got[1].shape == (8 * t, 2 * 768)
    assert within_band(got[0], want[0]) and within_band(got[1], want[1])


@pytest.mark.parametrize("f,t", LENGTHS, ids=LENGTH_IDS)
def test_cuda_attn_train_cross_drops_the_hash_units(cuda, f, t):
    """With V = I per head (the first min(t, 64) keys), ctx holds the dropped probabilities: the kernel
    zeroes exactly the units of head h's [block, F, T] draw, at rate 0.5."""
    q, kv, _, _ = _cross_train_case(cuda, 15, f, t)
    b, n, d = 8, 12, min(t, 64)
    v = torch.zeros(b, t, n, 64, device=cuda)
    v[:, torch.arange(d), :, torch.arange(d)] = 1.0
    kv[:, 768:] = v.reshape(b * t, 768).to(torch.bfloat16)
    keep = dropout.cross_probs_keep(123, 0.5, b, n, f, t, 8, cuda)[..., :d]
    for fn in (kernels.attn_train_cross, kernels.attn_train_cross_plain):
        probs = fn(q, kv, None, b, f, t, n, 123, 0.5, 8).reshape(b, f, n, 64)[..., :d].permute(0, 2, 1, 3)
        torch.cuda.synchronize()
        assert torch.equal(probs == 0, ~keep)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("f,t", LENGTHS, ids=LENGTH_IDS)
def test_cuda_cross_train_block_matches_the_oracle(cuda, f, t, rate):
    g = torch.Generator(device="cpu").manual_seed(16)
    h = 768
    x, c = (torch.randn(8, s, h, generator=g).to(cuda, torch.bfloat16) for s in (f, t))
    shapes = [(h, h), (h,), (h, 2 * h), (2 * h,), (h, h), (h,)]
    ws = [(0.02 * torch.randn(*sh, generator=g)).to(cuda) for sh in shapes]
    ws += [(1.0 + 0.1 * torch.randn(h, generator=g)).to(cuda), (0.1 * torch.randn(h, generator=g)).to(cuda)]
    dy = torch.randn(8, f, h, generator=g).to(cuda, torch.bfloat16)
    mask = torch.ones(8, t, device=cuda)
    mask[0] = 0.0
    mask[1, t // 2:] = 0.0
    bias = mask_to_bias(mask)
    out = []
    for fn in (train_blocks.cross_attention_block_train, train_blocks.cross_attention_block_train_plain):
        leaves = [x.clone().requires_grad_(), c.clone().requires_grad_(), *(w.clone().requires_grad_() for w in ws)]
        y = fn(*leaves, 12, 42, bias=bias, attn_dropout_rate=rate, hidden_dropout_rate=rate)
        y.backward(dy)
        out.append((y.detach(), [z.grad for z in leaves]))
    (y, grads), (wy, wgrads) = out
    assert within_band(y, wy)
    assert grads[0].dtype == grads[1].dtype == torch.bfloat16 and all(z.dtype == torch.float32 for z in grads[2:])
    errs = [rel_l2(z, w) for z, w in zip(grads, wgrads)]
    assert max(errs) <= TRAIN_GRAD_REL_L2, errs


def test_cuda_cross_train_block_launch_or_raise(cuda):
    q, kv, _, dctx = _cross_train_case(cuda, 17, 23, 10)
    with pytest.raises(ValueError, match="dtype"):
        kernels.attn_train_cross(q.float(), kv, None, 8, 23, 10, 12, 1, 0.1, 8)
    with pytest.raises(ValueError, match="S <="):
        kernels.attn_train_cross(q, kv, None, 8, 65, 10, 12, 1, 0.1, 8)
    counters = (train_blocks.cross_attention_block_train, train_blocks.cross_attention_block_train_backward,
                kernels.gemm, kernels.attn_train_cross, kernels.attn_train_cross_bwd, kernels.ln_train,
                kernels.ln_train_bwd)
    before = [z.launches for z in counters]
    g = torch.Generator(device="cpu").manual_seed(18)
    x, c = (torch.randn(8, s, 768, generator=g).to(cuda, torch.bfloat16).requires_grad_() for s in (23, 10))
    ws = [(0.02 * torch.randn(*sh, generator=g)).to(cuda).requires_grad_()
          for sh in ((768, 768), (768,), (768, 1536), (1536,), (768, 768), (768,))]
    ws += [torch.ones(768, device=cuda, requires_grad=True), torch.zeros(768, device=cuda, requires_grad=True)]
    train_blocks.cross_attention_block_train(x, c, *ws, 12, 1, attn_dropout_rate=0.1).sum().backward()
    torch.cuda.synchronize()
    assert [z.launches - b for z, b in zip(counters, before)] == [1, 1, 3 + 6, 2, 1, 1, 1]


# A full head-shared attention bias ([B, 1, S, S] / [B, 1, F, T] at the blocks, [B, Sq, Sk] at the
# cores): the full-bias instance of attn_core / attn_core_cross at the 16-row tiles' edges, and a key
# mask spread over every query, which must give the key-mask instance's output bit for bit
FULL_BIAS_LENGTHS = [1, 17, 40, 64]
FULL_BIAS_PAIRS = [(64, 1), (1, 64), (23, 10), (10, 23)]


def _full_bias(device, seed, b, sq, sk, all_masked_row=False):
    g = torch.Generator(device="cpu").manual_seed(seed)
    bias = torch.randn(b, sq, sk, generator=g)
    masked = torch.rand(b, sq, sk, generator=g) < 0.25
    masked[..., 0] = False
    if all_masked_row:
        masked[0, 0] = True  # pair 0's first query: every key at -10000, an ordinary softmax
    return bias.masked_fill(masked, -10000.0).to(device)


@pytest.mark.parametrize("s", FULL_BIAS_LENGTHS)
def test_cuda_attn_core_full_bias_matches_plain(cuda, s):
    qkv, _, _ = _core_case(cuda, 31, 5, s, s, "no-mask")
    bias = _full_bias(cuda, 32, 5, s, s, all_masked_row=True)
    assert within_band(kernels.attn_core(qkv, bias, 5, s, 12), kernels.attn_core_plain(qkv, bias, 5, s, 12))


@pytest.mark.parametrize("sq,sk", FULL_BIAS_PAIRS, ids=[f"{a}<-{b}" for a, b in FULL_BIAS_PAIRS])
def test_cuda_attn_core_cross_full_bias_matches_plain(cuda, sq, sk):
    qkv_q, qkv_k, _ = _core_case(cuda, 33, 5, sq, sk, "no-mask")
    q, kv = qkv_q[:, :768].contiguous(), qkv_k[:, 768:].contiguous()
    bias = _full_bias(cuda, 34, 5, sq, sk, all_masked_row=True)
    assert within_band(kernels.attn_core_cross(q, kv, bias, 5, sq, sk, 12),
                       kernels.attn_core_cross_plain(q, kv, bias, 5, sq, sk, 12))


@pytest.mark.parametrize("sq,sk", [(s, s) for s in FULL_BIAS_LENGTHS] + FULL_BIAS_PAIRS,
                         ids=[f"{s}" for s in FULL_BIAS_LENGTHS] + [f"{a}<-{b}" for a, b in FULL_BIAS_PAIRS])
def test_cuda_key_mask_as_full_bias_equals_key_mask(cuda, sq, sk):
    """The key-mask and no-bias instances are untouched by the full-bias one: a key mask spread over
    every query (and zeros for no bias) through the full-bias instance gives their output bit for bit."""
    qkv_q, qkv_k, (_, kb) = _core_case(cuda, 35, 5, sq, sk, "all-masked-row")
    q, kv = qkv_q[:, :768].contiguous(), qkv_k[:, 768:].contiguous()
    for compact, spread in ((kb, kb[:, None, :].expand(5, sq, sk).contiguous()),
                            (None, torch.zeros(5, sq, sk, device=cuda))):
        assert torch.equal(kernels.attn_core_cross(q, kv, spread, 5, sq, sk, 12),
                           kernels.attn_core_cross(q, kv, compact, 5, sq, sk, 12))
        if sq == sk:
            assert torch.equal(kernels.attn_core(qkv_q, spread, 5, sq, 12), kernels.attn_core(qkv_q, compact, 5, sq, 12))


@pytest.mark.parametrize("f,t", LENGTHS, ids=LENGTH_IDS)
def test_cuda_blocks_take_a_full_bias(cuda, f, t):
    """The attention block with a [B, 1, S, S] bias and the cross block with a [B, 1, F, T] one, on the
    kernels (one attn_core / attn_core_cross launch each), against their plain oracles."""
    x, ws, _ = attn_inputs(36, **{**FULL, "s": f})
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    wt = _to(ws, cuda, [torch.bfloat16, torch.float32, torch.bfloat16] + [torch.float32] * 3)
    bias = _full_bias(cuda, 37, FULL["b"], f, f)[:, None]
    before = kernels.attn_core.launches
    assert within_band(attention_block(xt, *wt, 12, bias), attention_block_plain(xt, *wt, 12, bias))
    assert kernels.attn_core.launches == before + 1
    lang, visn, cw, _ = _cross_case(cuda, 38, f, t, "no-mask")
    bias = _full_bias(cuda, 39, 8, f, t)[:, None]
    before = kernels.attn_core_cross.launches
    assert within_band(cross_attention_block(lang, visn, *cw, 12, bias),
                       cross_attention_block_plain(lang, visn, *cw, 12, bias))
    assert kernels.attn_core_cross.launches == before + 1


# The host loaders feeding a scoring engine on the card: the native span loader and the per-example
# Python path give the same batches, so the kernels give the same scores
CARD_TINY = {"hidden_size": 128, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 256}


def test_cuda_loaders_feed_the_engine_bit_equal(cuda, tmp_path):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import VOCAB_PATH
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import Featurizer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.synthetic import SYNTHETIC_LABELS, make_testb_tsv
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine, ScoringStats
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.tokenization import FullTokenizer

    p = tmp_path / "pairs.tsv"
    p.write_text("\n".join(make_testb_tsv(70, seed=3, pairs_per_query=9)) + "\n")
    fz = Featurizer(FullTokenizer.google_style(VOCAB_PATH), SYNTHETIC_LABELS)
    spec = get_model("imagebert_a", overrides=CARD_TINY)
    engine = ScoringEngine(spec, spec.init_params(1), device=cuda)
    assert engine.attention_backend == "pallas_packed"
    results = {}
    for name, kw in (("native", {}), ("python", {"use_native": False})):
        stats = ScoringStats()
        before = kernels.attn_core.launches
        results[name] = engine.score_files([p], fz, 16, stats=stats, **kw)
        assert (stats.pairs, stats.pipeline.errors, stats.batches) == (70, 1, 5)
        # 2 layers a batch that the host launches: each ring slot's eager batch and its CUDA graph's capture; the
        # fifth batch is a replay, which launches on the device alone
        assert kernels.attn_core.launches - before == 2 * 4
    assert results["native"] == results["python"]


def test_cuda_device_fusion_equals_dict_path(cuda):
    """build_submission_vectorized on the card (float64) gives the dict path's rows, on tables whose
    products sit under 1-3 queries with top-2 gaps on both sides of 0.92."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch import ensemble
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ensemble import vectorized

    g = torch.Generator(device="cpu").manual_seed(5)
    tables = [{}, {}, {}, {}]
    for pid in range(300):
        homes = torch.randperm(40, generator=g)[: int(torch.randint(1, 4, (1,), generator=g))].tolist()
        best = 1.0 + torch.rand(1, generator=g).item()
        gap = [0.5, 0.91, 0.93, 1.5][int(torch.randint(0, 4, (1,), generator=g))]
        for i, q in enumerate(homes):
            m = best if i == 0 else best - gap
            for j, t in enumerate(tables):
                t.setdefault(f"q{q}", {})[f"p{pid}"] = m + 0.01 * (j - 1.5) * torch.rand(1, generator=g).item()
    fused = ensemble.fuse(*tables)
    want = ensemble.top5_rows(ensemble.dedup_filter(fused), fused.merge)
    assert vectorized.build_submission_vectorized(*tables, device=cuda) == want


# ---- the tied MLM head of ImageBERT-A and LXMERT (no kernel of its own; the train blocks around it) ----

MLM_ROWS = 256  # masked positions: one tenth of a B=256 step's 2560
# the head's gradients, card vs CPU: a few flipped bf16 roundings of the transform's output move them by
# a few 1e-4 in relative L2, against the 2e-2 of a whole train block
MLM_GRAD_REL_L2 = 1e-3


def test_cuda_mlm_head_matches_its_cpu_run(cuda):
    """The MLM head and loss at full width (H=768, vocab 21128) on the card, bf16 operands into f32
    products, forward and backward, against the same function on the CPU on the same inputs. The f32
    sums run in another order, which also flips some bf16 roundings of the transform's output before
    the tied product (one ulp, 2^-8 relative): logits within F32_OUT_BAND, the loss within 1e-4
    relative, the gradients within MLM_GRAD_REL_L2."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model, heads

    cfg = get_model("imagebert_a").config
    g = torch.Generator(device="cpu").manual_seed(61)
    p = heads.mlm_head_init(cfg, g)
    p["output_bias"] = 0.02 * torch.randn(cfg.vocab_size, generator=g)
    hidden = torch.randn(MLM_ROWS, cfg.hidden_size, generator=g)
    table = 0.02 * torch.randn(cfg.vocab_size, cfg.hidden_size, generator=g)
    ids = torch.randint(0, cfg.vocab_size, (MLM_ROWS,), generator=g)
    weights = (torch.rand(MLM_ROWS, generator=g) > 0.3).float()
    runs = []
    for device in (cuda, torch.device("cpu")):
        leaves = [t.to(device).requires_grad_() for t in (hidden, table, p["transform"]["dense"]["kernel"],
                                                           p["output_bias"])]
        tree = {"transform": {"dense": {"kernel": leaves[2], "bias": p["transform"]["dense"]["bias"].to(device)},
                              "LayerNorm": {k: v.to(device) for k, v in p["transform"]["LayerNorm"].items()}},
                "output_bias": leaves[3]}
        logits = heads.mlm_logits(tree, leaves[0], leaves[1], Precision.bf16())
        loss = heads.mlm_loss(logits, ids.to(device), weights.to(device))
        runs.append((logits.detach(), loss.detach(), torch.autograd.grad(loss, leaves)))
    (lg, ls, gs), (lw, lsw, gw) = runs
    assert lg.dtype == torch.float32 and lg.shape == (MLM_ROWS, cfg.vocab_size)
    assert (lg.cpu() - lw).abs().max().item() <= F32_OUT_BAND
    assert abs(ls.item() - lsw.item()) <= 1e-4 * abs(lsw.item())
    errs = [rel_l2(a.cpu(), b) for a, b in zip(gs, gw)]
    assert max(errs) <= MLM_GRAD_REL_L2, errs


@pytest.mark.parametrize("model", ["imagebert_a", "lxmert"])
def test_cuda_mlm_step_kernel_route_matches_plain_route(cuda, model):
    """One step with the MLM loss on (a 2-layer model at full width, B=32, dropout 0.1): the train
    kernels' route against the plain blocks' route in bf16, the loss within 1e-2 and every gradient,
    ``cls/predictions`` and the word embeddings (gathered and tied) included, within TRAIN_GRAD_REL_L2."""
    import numpy as np

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.core import (
        TRAIN_KERNEL_BLOCKS,
        TRAIN_PLAIN_BLOCKS,
    )
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer, recipe_for
    from torch_parity import imagebert_a_batch

    b, rows = 32, 10
    r = np.random.default_rng(62)
    if model == "imagebert_a":
        spec = get_model(model, overrides={"num_hidden_layers": 2})
        batch, text = imagebert_a_batch(b, spec.config.vocab_size, 63), 20
    else:
        spec = get_model(model, overrides={"l_layers": 1, "x_layers": 1, "r_layers": 1})
        vocab, text = spec.config.bert.vocab_size, 23
        n_query, n_boxes = r.integers(3, 24, b), r.integers(1, 11, b)
        batch = {"input_ids": r.integers(0, vocab, (b, text)).astype(np.int32),
                 "input_mask": (np.arange(text)[None] < n_query[:, None]).astype(np.int32),
                 "label_ids": r.integers(0, vocab, (b, 10, 8)).astype(np.int32),
                 "boxes": r.random((b, 10, 4)).astype(np.float32),
                 "features": r.standard_normal((b, 10, 2048)).astype(np.float32),
                 "feats_mask": (np.arange(10)[None] < n_boxes[:, None]).astype(np.float32)}
    vocab = spec.config.vocab_size if model == "imagebert_a" else spec.config.bert.vocab_size
    batch.update(labels=r.integers(0, 2, b).astype(np.int32),
                 masked_lm_positions=r.integers(1, text - 1, (b, rows)).astype(np.int32),
                 masked_lm_ids=r.integers(0, vocab, (b, rows)).astype(np.int32),
                 masked_lm_weights=(r.random((b, rows)) > 0.3).astype(np.float32))
    tc = dataclasses.replace(recipe_for(model), mlm_loss_weight=1.0)
    out = []
    for blocks in (TRAIN_KERNEL_BLOCKS, TRAIN_PLAIN_BLOCKS):
        trainer = Trainer(spec, tc, precision=Precision.bf16(), device=cuda, blocks=blocks)
        state = trainer.init_state(seed=64)
        grads, metrics = trainer.grads(state, trainer.to_device(batch), seed=65)
        out.append((metrics, dict(zip(state.optimizer.names, grads))))
    (mk, gk), (mp, gp) = out
    for key in ("loss", "mlm_loss"):
        assert abs(mk[key].item() - mp[key].item()) <= 1e-2, key
    for name in ("cls/predictions/output_bias", "cls/predictions/transform/dense/kernel",
                 "bert/embeddings/word_embeddings"):
        assert gk[name].abs().max().item() > 0, name
    errs = {name: rel_l2(gk[name], gp[name]) for name in gk if gp[name].abs().max().item() > 0}
    assert max(errs.values()) <= TRAIN_GRAD_REL_L2, sorted(errs.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("model", ["imagebert_a", "imagebert_b"])
def test_cuda_train_step_gradients_repeat_bit_equal(cuda, model):
    """Three runs of one step on the same params, batch and dropout seed (a 2-layer model at full width,
    B=256, the MLM loss on for A) give the same gradients bit for bit: no op of the step sums in a varying
    order, which a resumed run's bit-equality on the card rests on (the token-type rows are picked by a
    select, whose backward sums in a fixed order)."""
    import numpy as np

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer, recipe_for
    from torch_parity import imagebert_a_batch, imagebert_b_batch

    b = 256
    spec = get_model(model, overrides={"num_hidden_layers": 2})
    vocab = spec.config.vocab_size
    tc = recipe_for(model)
    if model == "imagebert_a":
        r = np.random.default_rng(66)
        batch = imagebert_a_batch(b, vocab, 67)
        batch.update(masked_lm_positions=r.integers(1, 19, (b, 10)).astype(np.int32),
                     masked_lm_ids=r.integers(0, vocab, (b, 10)).astype(np.int32),
                     masked_lm_weights=(r.random((b, 10)) > 0.3).astype(np.float32))
        tc = dataclasses.replace(tc, mlm_loss_weight=1.0)
    else:
        batch = imagebert_b_batch(b, vocab, 67)
    batch["labels"] = np.random.default_rng(68).integers(0, 2, b).astype(np.int32)
    trainer = Trainer(spec, tc, precision=Precision.bf16(), device=cuda)
    state = trainer.init_state(seed=69)
    dev_batch = trainer.to_device(batch)
    first, _ = trainer.grads(state, dev_batch, seed=70)
    for _ in range(2):
        again, _ = trainer.grads(state, dev_batch, seed=70)
        differ = [n for n, x, y in zip(state.optimizer.names, first, again, strict=True) if not torch.equal(x, y)]
        assert not differ, differ


def _scoring_batch(model: str, spec, b: int, seed: int) -> dict:
    """A seeded batch of ``model``'s serving layout (LXMERT's masks ragged), labels 0/1 and a valid mask."""
    import numpy as np

    from torch_parity import imagebert_a_batch, imagebert_b_batch

    r = np.random.default_rng(seed)
    if model == "lxmert":
        vocab = spec.config.bert.vocab_size
        n_query, n_boxes = r.integers(3, 24, b), r.integers(1, 11, b)
        batch = {"input_ids": r.integers(0, vocab, (b, 23)).astype(np.int32),
                 "input_mask": (np.arange(23)[None] < n_query[:, None]).astype(np.int32),
                 "label_ids": r.integers(0, vocab, (b, 10, 8)).astype(np.int32),
                 "boxes": r.random((b, 10, 4)).astype(np.float32),
                 "features": r.standard_normal((b, 10, 2048)).astype(np.float32),
                 "feats_mask": (np.arange(10)[None] < n_boxes[:, None]).astype(np.float32)}
    elif model == "imagebert_a":
        batch = imagebert_a_batch(b, spec.config.vocab_size, seed + 1)
    else:
        batch = imagebert_b_batch(b, spec.config.vocab_size, seed + 1)
    batch["labels"] = r.integers(0, 2, b).astype(np.int32)
    batch["valid"] = np.ones(b, dtype=bool)
    return batch


def test_cuda_live_teacher_equals_the_engine(cuda):
    """The live teacher (a 2-layer ImageBERT-B at full width, B=64) scores through the scoring blocks'
    kernels, whatever attention backend the process holds, at the fed label 1: its probabilities on the
    card equal ``ScoringEngine.score_batch`` on the same params and batch with labels 1, bit for bit."""
    import numpy as np

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention_block import attention_block as block
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import LiveTeacher

    spec = get_model("imagebert_b", overrides={"num_hidden_layers": 2})
    params = spec.init_params(71)
    batch = _scoring_batch("imagebert_b", spec, 64, 72)
    teacher = LiveTeacher(spec, params, device=cuda)
    block.launches = 0
    got = teacher.attach(batch)
    torch.cuda.synchronize()
    assert block.launches == 2 and teacher.engine.attention_backend == "pallas_packed"
    want = ScoringEngine(spec, params, device=cuda).score_batch({**batch, "labels": np.ones(64, np.int32)})
    prob = got["teacher_prob"]
    assert prob.device.type == "cuda" and prob.dtype == torch.float32 and not prob.is_inference()
    assert torch.equal(prob, want.float())


def test_cuda_distillation_step_gradients_within_the_training_band(cuda):
    """One pure-soft distillation step of a 2-layer ImageBERT-B student at full width (B=256, B's recipe,
    T=2, dropout 0.1) on the kernel route, the plain route in bf16 and the f32 truth: every gradient of the
    kernel route within 5e-2 relative L2 of the truth, or within 1.25 x the bf16 plain route's own error
    (chip_smoke.py's rule for a step), the distillation loss within 1e-2."""
    import numpy as np

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.core import (
        TRAIN_KERNEL_BLOCKS,
        TRAIN_PLAIN_BLOCKS,
    )
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.train import Trainer, recipe_for

    spec = get_model("imagebert_b", overrides={"num_hidden_layers": 2})
    params = spec.init_params(73)
    batch = _scoring_batch("imagebert_b", spec, 256, 74)
    r = np.random.default_rng(75)
    batch["teacher_prob"] = torch.from_numpy(r.random(256).astype(np.float32)).to(cuda)
    batch["teacher_weight"] = np.ones(256, np.float32)
    tc = dataclasses.replace(recipe_for("imagebert_b"), distill_weight=1.0, distill_temperature=2.0,
                             hard_loss_weight=0.0)
    out = []
    for prec, blocks in ((Precision.bf16(), TRAIN_KERNEL_BLOCKS), (Precision.bf16(), TRAIN_PLAIN_BLOCKS),
                         (Precision.f32(), TRAIN_PLAIN_BLOCKS)):
        trainer = Trainer(spec, tc, precision=prec, device=cuda, blocks=blocks)
        state = trainer.init_state(params)
        grads, metrics = trainer.grads(state, trainer.to_device(batch), seed=76)
        out.append((metrics["distill_loss"].item(), grads, state.optimizer.names))
    (lk, gk, names), (_, gp, _), (lt, gt, _) = out
    assert abs(lk - lt) <= 1e-2
    failed = [n for n, a, p, t in zip(names, gk, gp, gt) if rel_l2(a, t) > max(5e-2, 1.25 * rel_l2(p, t))]
    assert not failed, failed


@pytest.mark.parametrize("model", ["imagebert_a", "imagebert_b", "lxmert"])
def test_cuda_imported_checkpoint_scores_equal_the_npz_route(cuda, tmp_path, model):
    """The reference's forms (``tests/torch_tf_bundle_writer.py``: A's TF1 bundle, B's with EMA shadows
    and snappy index blocks, LXMERT's ``BEST.pth`` with its transposed torch weights) and the npz tree of
    the same weights, each through ``load_checkpoint`` and ``ScoringEngine`` on the card (2-layer models,
    LXMERT 1/1/1, at full width, B=64): the scores bit-equal."""
    import numpy as np

    import torch_tf_bundle_writer as writer
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.checkpoint import (
        load_checkpoint,
        params_to_jax,
        save_npz,
    )
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine

    overrides = {"l_layers": 1, "x_layers": 1, "r_layers": 1} if model == "lxmert" else {"num_hidden_layers": 2}
    spec = get_model(model, overrides=overrides)
    tree = params_to_jax(spec.init_params(77))
    if model == "imagebert_a":
        ref = tmp_path / "ImageBertKDD.ckpt-1"
        writer.write_tf_bundle(ref, writer.imagebert_a_tf_names(tree), tensor_crcs=False)
    elif model == "imagebert_b":
        ref = tmp_path / "b.ckpt-251"
        raw = params_to_jax(spec.init_params(78))
        writer.write_tf_bundle(ref, writer.with_ema_shadows(writer.imagebert_b_tf_names(raw),
                                                            writer.imagebert_b_tf_names(tree)),
                               snappy=True, tensor_crcs=False)
    else:
        ref = tmp_path / "BEST.pth"
        tree["cls"]["seq_relationship"] = {"kernel": np.full((768, 2), 0.01, np.float32),
                                           "bias": np.zeros(2, np.float32)}
        torch.save({k: torch.from_numpy(v) for k, v in writer.lxmert_torch_names(tree).items()}, ref)
    save_npz(tmp_path / "tree.npz", tree)
    batch = _scoring_batch(model, spec, 64, 79)
    scores = [ScoringEngine(spec, load_checkpoint(model, path, spec), device=cuda).score_batch(batch)
              for path in (ref, tmp_path / "tree.npz")]
    assert torch.isfinite(scores[0]).all() and torch.equal(scores[0], scores[1])


# ---- the two-tower: its towers at S=20 (query) and S=10 (product) under key masks, the exact top-k ----


def _tower_bias(device, b, s, seed):
    """A tower's [b, s] key-mask bias: lengths 1..s, pair 0 with every key masked (a product with no box),
    pair 1 with none, pair 2 with one key (a one-token query)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    lengths[0], lengths[1], lengths[2] = 0, s, 1
    return mask_to_bias((torch.arange(s)[None] < lengths[:, None]).float()).to(device)


@pytest.mark.parametrize("s", [20, 10], ids=["query-S20", "product-S10"])
def test_cuda_tower_blocks_match_plain(cuda, s):
    """The attention and FFN blocks and the fused layer (KMR_FUSED_LAYER=1's) at the towers' lengths, tanh
    GELU, with an all-masked pair: the kernels within the ulp band of their plain versions (16-row tiles pad
    S=20 to 32)."""
    x, ws, _ = _layer_case(cuda, 90 + s, s, "mask")
    bias = _tower_bias(cuda, 8, s, 91 + s)
    assert bool((bias[0] == -10000.0).all())
    att, ffn = ws[:6], ws[6:]
    assert within_band(attention_block(x, *att, 12, bias), attention_block_plain(x, *att, 12, bias))
    assert within_band(ffn_block(x, *ffn, approximate_gelu=True), ffn_block_plain(x, *ffn, approximate_gelu=True))
    assert within_band(encoder_layer(x, *ws, 12, bias, approximate_gelu=True),
                       encoder_layer_plain(x, *ws, 12, bias, approximate_gelu=True))


@pytest.mark.parametrize("s", [20, 10], ids=["query-S20", "product-S10"])
def test_cuda_tower_train_blocks_match_the_oracle(cuda, s):
    """The attention and FFN train blocks at the towers' lengths and dropout 0 (the towers train without
    dropout), the attention block under a key mask with an all-masked pair: y in the ulp band and every
    gradient within TRAIN_GRAD_REL_L2 of the plain oracle's autograd; attn_train and attn_train_bwd alone
    in the ulp band."""
    bias = _tower_bias(cuda, 8, s, 92 + s)
    for kind in ("attn", "ffn"):
        x, ws, dy = _train_block_case(cuda, kind, 93 + s, s=s)
        if kind == "ffn":
            fns = [lambda x, *w, f=f: f(x, *w, 0, dropout_rate=0.0)
                   for f in (train_blocks.ffn_block_train, train_blocks.ffn_block_train_plain)]
        else:
            fns = [lambda x, *w, f=f: f(x, *w, 12, 0, bias=bias, attn_dropout_rate=0.0, hidden_dropout_rate=0.0)
                   for f in (train_blocks.attention_block_train, train_blocks.attention_block_train_plain)]
        (y, grads), (wy, wgrads) = (_block_grads(f, x, ws, dy) for f in fns)
        assert within_band(y, wy), kind
        errs = [rel_l2(g, w) for g, w in zip(grads, wgrads)]
        assert max(errs) <= TRAIN_GRAD_REL_L2, (kind, errs)
    qkv, _, _, dctx = _attn_train_edge_case(cuda, 94 + s, 8, s, s, 12, "no-mask")
    args = (8, s, 12, 0, 0.0, 8)
    assert within_band(kernels.attn_train(qkv, bias, *args), kernels.attn_train_plain(qkv, bias, *args))
    assert within_band(kernels.attn_train_bwd(qkv, dctx, bias, *args),
                       kernels.attn_train_bwd_plain(qkv, dctx, bias, *args))


def test_cuda_top_k_products_matches_its_cpu_run(cuda, tmp_path):
    """The exact top-k on the card (bf16 operands, f32 sums out of ``torch.mm``) equal to its CPU run on the
    same bf16 catalog, ties included: values on a 1/8 grid make every score exact on both, and 5000 rows
    drawn from 300 tie many of them; through ``top_k_products`` (chunks of 1024, ``num_valid`` 4900) and
    ``recall_chunked`` over a packed catalog (float16 slabs cast on the device)."""
    import numpy as np

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data import (
        CatalogDataset,
        build_catalog,
        recall_chunked,
    )
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.two_tower import top_k_products

    g = torch.Generator(device="cpu").manual_seed(95)
    base = torch.randint(-16, 17, (300, 128), generator=g) / 8.0
    cat = base[torch.randint(0, 300, (5000,), generator=g)].to(torch.bfloat16)
    q = torch.randint(-16, 17, (64, 128), generator=g) / 8.0
    want = top_k_products(q, cat, k=50, chunk=1024, num_valid=4900)
    got = top_k_products(q.to(cuda), cat.to(cuda), k=50, chunk=1024, num_valid=4900)
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])
    assert (got[1] < 4900).all() and len(set(want[0][0].tolist())) < 50  # ties among the top 50
    build_catalog(({"product_id": np.int64(i), "embedding": row} for i, row in enumerate(cat.float().numpy())),
                  tmp_path / "cat", shard_size=1500)
    ds = CatalogDataset(tmp_path / "cat")
    s_cpu, i_cpu = recall_chunked(q.numpy(), ds, k=50, chunk_rows=1024, device="cpu")
    s_gpu, i_gpu = recall_chunked(q.numpy(), ds, k=50, chunk_rows=1024, device=cuda)
    assert np.array_equal(i_cpu, i_gpu) and np.array_equal(s_cpu, s_gpu)


def test_cuda_tower_embeddings_match_plain(cuda):
    """Both towers at full width (4 + 4 layers, embed_dim 128) through ``TowerEngine`` on the card (the fused
    blocks, the label conv's and the projections' gemm, N=128) against the plain bf16 route on the same
    weights and batch (B=64, products with no box among them): unit embeddings within 2e-2 elementwise."""
    import numpy as np

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import PLAIN_BLOCKS, get_model, two_tower
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention import attention_backend
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import TowerEngine

    spec = get_model("two_tower")
    assert (spec.config.bert.hidden_size, spec.config.bert.num_hidden_layers, spec.config.embed_dim) == (768, 4, 128)
    engine = TowerEngine(spec, spec.init_params(96), device=cuda)
    r = np.random.default_rng(97)
    batch = {"input_ids": r.integers(0, 21128, (64, 20)).astype(np.int32),
             "len_query": r.integers(1, 21, (64,)).astype(np.int32),
             "boxes": r.standard_normal((64, 10, 5)).astype(np.float32),
             "features": r.standard_normal((64, 10, 2048)).astype(np.float32),
             "label_ids": r.integers(0, 21128, (64, 10, 8)).astype(np.int32),
             "num_boxes": r.integers(0, 11, (64,)).astype(np.int32)}
    batch["num_boxes"][:4] = 0
    before = kernels.gemm.launches
    for side, fn in (("query", two_tower.embed_query), ("product", two_tower.embed_product)):
        got = engine.embed(side, batch)
        with torch.inference_mode(), attention_backend("pallas_packed"):
            want = fn(engine.params, engine.side_to_device(side, batch), spec.config, engine.precision, PLAIN_BLOCKS)
        assert got.shape == (64, 128) and within_band(got, want, atol=2e-2, rtol=0.0), side
    assert kernels.gemm.launches - before == 2 * 16 + 1 + 2  # 4 + 4 layers' products, the label conv, 2 projections


# ---- the int8 serving path, data parallelism and best_mha (kernel-free checks that need the card) -------------


@pytest.mark.parametrize("shape", [(20480, 768, 3072), (20480, 3072, 768), (512, 5, 768), (512, 768, 2), (7, 64, 48),
                                   (16, 37, 40)])
def test_cuda_dense_q8_matches_its_cpu_run(cuda, shape):
    """``dense_q8`` on the card = on the CPU within 1e-6 relative (the int32 sums are exact; the padding to
    ``torch._int_mm``'s shape rules adds zero products): the FFN shapes at B=512, B's box dense (K=5), a 2-wide
    head, 16 rows or fewer."""
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.quant import dense_q8, int8_matmul, quantize_kernel

    m, k, n = shape
    g = torch.Generator().manual_seed(3)
    x, w, b = torch.randn(m, k, generator=g), torch.randn(k, n, generator=g) / k**0.5, torch.randn(n, generator=g)
    p = {**quantize_kernel(w), "bias": b}
    want = dense_q8(p, x)
    got = dense_q8({key: v.to(cuda) for key, v in p.items()}, x.to(cuda)).cpu()
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
    a8 = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    assert torch.equal(int8_matmul(a8.to(cuda), p["kernel_q8"].to(cuda)).cpu(), int8_matmul(a8, p["kernel_q8"]))


def test_cuda_best_mha_times_both_routes_and_picks(cuda):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(64, 12, 40, 64, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    route = attention.backend_choice(q)
    choice, t_kernel, t_xla = attention._backend_choice((*q.shape, False, str(q.dtype)))
    assert route == choice and route in ("pallas", "xla") and t_kernel > 0 and t_xla > 0
    out = attention.best_mha(q, k, v)
    assert within_band(out, attention.mha_xla(q, k, v))


def test_cuda_recall_sharded_one_rank_is_top_k_products(cuda):
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models.two_tower import recall_sharded, top_k_products

    g = torch.Generator().manual_seed(5)
    q = torch.randn(8, 128, generator=g).to(cuda)
    cat = torch.randn(5001, 128, generator=g).to(cuda, torch.bfloat16)
    cat[100] = cat[7]  # a tie
    s, i = recall_sharded(q, cat, k=10, chunk=1024)
    ws, wi = top_k_products(q, cat, k=10, chunk=1024)
    assert torch.equal(i, wi) and torch.equal(s, ws)


def test_cuda_int8_scores_track_bf16(cuda):
    """ImageBERT-A at a 2-layer, 768-wide config in both int8 modes on the engine's default route (the bf16
    residual tree): finite, and within 5e-2 of the bf16 kernels' scores."""
    import numpy as np

    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.data.batchspec import example_batch
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import get_model
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.quant import quantize_for_serving
    from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.parallel import ScoringEngine

    spec = get_model("imagebert_a", overrides={"num_hidden_layers": 2})
    params = spec.init_params(0)
    batch = example_batch("imagebert_a", spec.config, 64, np.random.default_rng(0))
    bf16 = ScoringEngine(spec, params).score_batch(batch).float()
    for mode in ("int8", "int8-ffn"):
        q8 = ScoringEngine(spec, quantize_for_serving(spec, params, mode, bf16_residual=True)).score_batch(batch)
        assert bool(torch.isfinite(q8).all()) and float((q8.float() - bf16).abs().max()) < 5e-2, mode
