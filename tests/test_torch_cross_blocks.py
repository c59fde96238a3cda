"""The port's cross-attention and dual-cross-attention blocks against the JAX
package's Pallas kernels.

On the CPU the Pallas kernels run in interpret mode and the port's wrappers
run their kernels' plain versions; both are held to the same numpy inputs,
at LXMERT's stream lengths (F, T) = (23, 10) and (10, 23), in both Pallas
variants ("loop": a softmax per head; "headpack": several heads packed into
one lane tile with a shared max). Budgets, as in ``test_torch_blocks.py``:
f32 <= 1e-5 (both sides compute in f32 and differ only in summation order);
bf16 <= 1.6e-2 abs on LayerNorm outputs of magnitude up to ~4, one bf16 ulp
of the largest outputs: both sides round the same intermediates to bf16 (q,
kv, probs, ctx), so a summation-order difference can flip one rounding.
The CUDA kernels themselves are held to these plain versions on the card by
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_attention import (
    cross_attention_block_pallas,
    dual_cross_attention_block_pallas,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import kernels
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention import mask_to_bias
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.cross_attention_block import (
    cross_attention_block,
    cross_attention_block_plain,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.dual_cross_attention_block import (
    dual_cross_attention_block,
    dual_cross_attention_block_plain,
)
from torch_parity import weights

N = 4  # heads at the small width H=64
BUDGET = {"f32": 1e-5, "bf16": 1.6e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
LENGTHS = [(23, 10), (10, 23)]
LENGTH_IDS = ["lang<-visn", "visn<-lang"]


def cross_inputs(seed, f, t, b=3, h=64, with_bias=False):
    """x [b, f, H], ctx [b, t, H], the block weights (wq, bq, wkv, bkv, wo, bo,
    gamma, beta) and, with_bias, 0/1 key masks of both streams (at least one
    live key a row)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, f, h)).astype(np.float32)
    ctx = rng.standard_normal((b, t, h)).astype(np.float32)
    ws = weights(rng, [("wq", (h, h)), ("bq", (h,)), ("wkv", (h, 2 * h)), ("bkv", (2 * h,)),
                       ("wo", (h, h)), ("bo", (h,)), ("gamma", (h,)), ("beta", (h,))])
    masks = None
    if with_bias:
        masks = []
        for s in (f, t):
            m = (rng.random((b, s)) > 0.3).astype(np.float32)
            m[:, 0] = 1.0
            masks.append(m)
    return x, ctx, ws, masks


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a).astype(jnp.float32))


def _fused_qkv(ws):
    """(wq, bq, wkv, bkv, *rest) -> (wqkv, bqkv, *rest) as torch f32."""
    wq, bq, wkv, bkv, *rest = [_torch(w) for w in ws]
    return [torch.cat([wq, wkv], dim=1), torch.cat([bq, bkv]), *rest]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("f,t", LENGTHS, ids=LENGTH_IDS)
@pytest.mark.parametrize("variant", ["loop", "headpack"])
def test_cross_attention_block_matches_pallas(variant, f, t, with_bias, dtype):
    x, ctx, ws, masks = cross_inputs(0, f, t, with_bias=with_bias)
    ctx_mask = None if masks is None else masks[1]
    jax_bias = None if ctx_mask is None else jax_mask_to_bias(jnp.asarray(ctx_mask))[:, None, None, :]
    want = cross_attention_block_pallas(
        jnp.asarray(x).astype(JNP[dtype]), jnp.asarray(ctx).astype(JNP[dtype]), *map(jnp.asarray, ws), N,
        jax_bias, block_b=2, variant=variant, interpret=True,
    )
    bias = None if ctx_mask is None else mask_to_bias(_torch(ctx_mask))[:, None, None, :]
    xt, ct, wt = _torch(x, TORCH[dtype]), _torch(ctx, TORCH[dtype]), [_torch(w) for w in ws]
    got = cross_attention_block(xt, ct, *wt, N, bias)
    oracle = cross_attention_block_plain(xt, ct, *wt, N, bias)
    assert got.dtype == TORCH[dtype] and got.shape == (3, f, 64)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=BUDGET[dtype], rtol=0)
    np.testing.assert_allclose(_f32(oracle), _f32(want), atol=BUDGET[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("f,t", LENGTHS, ids=LENGTH_IDS)
@pytest.mark.parametrize("variant", ["loop", "headpack"])
def test_dual_cross_attention_block_matches_pallas(variant, f, t, with_bias, dtype):
    l, v, ws, masks = cross_inputs(1, f, t, with_bias=with_bias)
    jb = [None, None] if masks is None else [jax_mask_to_bias(jnp.asarray(m)) for m in masks]
    want = dual_cross_attention_block_pallas(
        jnp.asarray(l).astype(JNP[dtype]), jnp.asarray(v).astype(JNP[dtype]), *map(jnp.asarray, ws), N,
        lang_bias=jb[0], visn_bias=jb[1], block_b=2, variant=variant, interpret=True,
    )
    tb = [None, None] if masks is None else [mask_to_bias(_torch(m)) for m in masks]
    lt, vt, wt = _torch(l, TORCH[dtype]), _torch(v, TORCH[dtype]), _fused_qkv(ws)
    got = dual_cross_attention_block(lt, vt, *wt, N, *tb)
    oracle = dual_cross_attention_block_plain(lt, vt, *wt, N, *tb)
    for g, o, w in zip(got, oracle, want):
        assert g.dtype == TORCH[dtype]
        np.testing.assert_allclose(_f32(g), _f32(w), atol=BUDGET[dtype], rtol=0)
        np.testing.assert_allclose(_f32(o), _f32(w), atol=BUDGET[dtype], rtol=0)


@pytest.mark.parametrize("with_bias", [False, True])
def test_dual_equals_two_cross_blocks(with_bias):
    """The dual block is the two shared-weight cross directions, exactly: in
    f32 on the CPU both routes run the same plain arithmetic."""
    l, v, ws, masks = cross_inputs(2, 23, 10, with_bias=with_bias)
    tb = [None, None] if masks is None else [mask_to_bias(_torch(m)) for m in masks]
    lt, vt, wt = _torch(l), _torch(v), [_torch(w) for w in ws]
    got_l, got_v = dual_cross_attention_block(lt, vt, *_fused_qkv(ws), N, *tb)
    torch.testing.assert_close(got_l, cross_attention_block(lt, vt, *wt, N, tb[1]), rtol=0, atol=1e-6)
    torch.testing.assert_close(got_v, cross_attention_block(vt, lt, *wt, N, tb[0]), rtol=0, atol=1e-6)


def test_attn_core_entry_points_agree():
    """The self-attention core is the cross core with q, k, v taken from one
    buffer, and the dual core is two cross cores."""
    rng = np.random.default_rng(3)
    b, f, t, h = 2, 23, 10, 128
    lqkv, vqkv = (_torch(rng.standard_normal((b * s, 3 * h)).astype(np.float32)) for s in (f, t))
    lb, vb = (mask_to_bias(_torch((rng.random((b, s)) > 0.4).astype(np.float32))) for s in (f, t))
    self_ctx = kernels.attn_core(lqkv, lb, b, f, 2)
    torch.testing.assert_close(self_ctx, kernels.attn_core_cross(lqkv[:, :h], lqkv[:, h:], lb, b, f, f, 2),
                               rtol=0, atol=0)
    ctx_l, ctx_v = kernels.attn_core_dual(lqkv, vqkv, lb, vb, b, f, t, 2)
    torch.testing.assert_close(ctx_l, kernels.attn_core_cross(lqkv[:, :h], vqkv[:, h:], vb, b, f, t, 2),
                               rtol=0, atol=0)
    torch.testing.assert_close(ctx_v, kernels.attn_core_cross(vqkv[:, :h], lqkv[:, h:], lb, b, t, f, 2),
                               rtol=0, atol=0)
    assert ctx_l.shape == (b * f, h) and ctx_v.shape == (b * t, h)


def test_wrappers_reject_bad_arguments():
    x, ctx, ws, _ = cross_inputs(4, 23, 10)
    xt, ct, wt = _torch(x), _torch(ctx), [_torch(w) for w in ws]
    with pytest.raises(ValueError, match="key-mask"):
        cross_attention_block(xt, ct, *wt, N, torch.zeros(3, 23))  # a mask over x's positions
    with pytest.raises(ValueError, match="broadcasts"):
        cross_attention_block_plain(xt, ct, *wt, N, torch.zeros(3, 1, 10, 23))  # [B, 1, T, F], not [B, 1, F, T]
    lb = torch.zeros(3, 23)
    for fn in (dual_cross_attention_block, dual_cross_attention_block_plain):
        with pytest.raises(ValueError, match="both key masks or neither"):
            fn(xt, ct, *_fused_qkv(ws), N, lb, None)
        with pytest.raises(ValueError, match="key-mask"):
            fn(xt, ct, *_fused_qkv(ws), N, lb, torch.zeros(3, 23))  # visn mask of the wrong length
    q = xt.reshape(69, 64)
    with pytest.raises(ValueError, match="both key masks or neither"):
        kernels.attn_core_dual(q, q, lb, None, 3, 23, 23, N)


def test_cpu_calls_count_no_launches():
    x, ctx, ws, masks = cross_inputs(5, 10, 23, with_bias=True)
    counted = (*kernels.WRAPPERS, cross_attention_block, dual_cross_attention_block)
    before = [w.launches for w in counted]
    xt, ct = _torch(x, torch.bfloat16), _torch(ctx, torch.bfloat16)
    cross_attention_block(xt, ct, *[_torch(w) for w in ws], N, mask_to_bias(_torch(masks[1])))
    dual_cross_attention_block(xt, ct, *_fused_qkv(ws), N, *[mask_to_bias(_torch(m)) for m in masks])
    assert [w.launches for w in counted] == before
