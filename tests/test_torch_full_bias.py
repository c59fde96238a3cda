"""A full head-shared attention bias through the port's fused blocks.

The JAX package's ``attention_block_pallas`` takes a [B, 1, S, S] bias and
``cross_attention_block_pallas`` a [B, 1, F, T] one (``ops/pallas_attention.py``
:544, :780), besides the compact key masks. The port's blocks send such a bias
to the full-bias instance of ``attn_core`` / ``attn_core_cross``; on the CPU the
wrappers run their plain versions, held here to the Pallas kernels in interpret
mode on the same numpy inputs. Budget: f32 <= 1e-5 (both sides compute in f32
and differ only in summation order). The dual-cross route takes compact biases
only, as JAX's ``models/core.py`` :383-395 gates it; with a full bias it runs the
two cross blocks, bit for bit. The CUDA instance is held to the plain version on
the card by ``test_torch_cuda.py``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_attention import (
    attention_block_pallas,
    cross_attention_block_pallas,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import Precision, core
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import kernels
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention import attention_backend
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention_block import (
    attention_bias,
    attention_block,
    attention_block_plain,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.cross_attention_block import (
    cross_attention_block,
    cross_attention_block_plain,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.encoder_layer import (
    encoder_layer,
    encoder_layer_plain,
)
from torch_parity import weights

B, S, H, N = 2, 8, 128, 2  # the case that reproduced the fault
F32 = 1e-5


def _torch(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _full_bias(rng, b, sq, sk):
    """A random [b, 1, sq, sk] bias with -10000 on some (query, key) entries
    (key 0 stays live for every query)."""
    bias = rng.standard_normal((b, 1, sq, sk)).astype(np.float32)
    masked = rng.random((b, 1, sq, sk)) < 0.25
    masked[..., 0] = False
    bias[masked] = -10000.0
    return bias


def _self_inputs(seed, b=B, s=S, h=H):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    ws = weights(rng, [("wqkv", (h, 3 * h)), ("bqkv", (3 * h,)), ("wo", (h, h)), ("bo", (h,)),
                       ("gamma", (h,)), ("beta", (h,))])
    return x, ws, _full_bias(rng, b, s, s)


def _cross_inputs(seed, f, t, b=B, h=H):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, f, h)).astype(np.float32)
    ctx = rng.standard_normal((b, t, h)).astype(np.float32)
    ws = weights(rng, [("wq", (h, h)), ("bq", (h,)), ("wkv", (h, 2 * h)), ("bkv", (2 * h,)),
                       ("wo", (h, h)), ("bo", (h,)), ("gamma", (h,)), ("beta", (h,))])
    return x, ctx, ws, _full_bias(rng, b, f, t)


@pytest.mark.parametrize("variant", ["loop", "headpack"])
def test_attention_block_full_bias_matches_pallas(variant):
    x, ws, bias = _self_inputs(0)
    want = attention_block_pallas(jnp.asarray(x), *map(jnp.asarray, ws), N, jnp.asarray(bias),
                                  block_b=2, variant=variant, interpret=True)
    xt, wt, bt = _torch(x), [_torch(w) for w in ws], _torch(bias)
    with attention_backend("pallas_packed"):
        got = attention_block(xt, *wt, N, bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32, rtol=0)
    np.testing.assert_allclose(attention_block_plain(xt, *wt, N, bt).numpy(), np.asarray(want), atol=F32, rtol=0)


def test_attention_block_bias_broadcasts_like_jax():
    """A [1, 1, S, S] bias broadcasts over the pairs as JAX's ``broadcast_to`` does."""
    x, ws, bias = _self_inputs(1)
    one = bias[:1]
    want = attention_block_pallas(jnp.asarray(x), *map(jnp.asarray, ws), N, jnp.asarray(one),
                                  block_b=2, interpret=True)
    got = attention_block(_torch(x), *[_torch(w) for w in ws], N, _torch(one))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32, rtol=0)


@pytest.mark.parametrize("f,t", [(23, 10), (10, 23), (8, 8)], ids=["lang<-visn", "visn<-lang", "8<-8"])
@pytest.mark.parametrize("variant", ["loop", "headpack"])
def test_cross_attention_block_full_bias_matches_pallas(variant, f, t):
    x, ctx, ws, bias = _cross_inputs(2, f, t)
    want = cross_attention_block_pallas(jnp.asarray(x), jnp.asarray(ctx), *map(jnp.asarray, ws), N,
                                        jnp.asarray(bias), block_b=2, variant=variant, interpret=True)
    xt, ct, wt, bt = _torch(x), _torch(ctx), [_torch(w) for w in ws], _torch(bias)
    got = cross_attention_block(xt, ct, *wt, N, bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32, rtol=0)
    np.testing.assert_allclose(cross_attention_block_plain(xt, ct, *wt, N, bt).numpy(), np.asarray(want),
                               atol=F32, rtol=0)


def test_encoder_layer_full_bias_matches_two_plain_blocks():
    rng = np.random.default_rng(3)
    x, aws, bias = _self_inputs(3)
    fws = weights(rng, [("w1", (H, 256)), ("b1", (256,)), ("w2", (256, H)), ("b2", (H,)),
                        ("gamma", (H,)), ("beta", (H,))])
    xt, wt, bt = _torch(x), [_torch(w) for w in aws + fws], _torch(bias)
    torch.testing.assert_close(encoder_layer(xt, *wt, N, bt), encoder_layer_plain(xt, *wt, N, bt),
                               rtol=0, atol=F32)


def test_attn_core_full_bias_equals_mha_rows():
    """The plain full-bias core is softmax(qk^T/8 + bias)v per head: a key mask
    given as rows and the same mask spread over every query agree bit for bit."""
    rng = np.random.default_rng(4)
    qkv = _torch(rng.standard_normal((B * S, 3 * H)))
    mask = _torch(np.where(rng.random((B, S)) < 0.3, -10000.0, 0.0))
    full = mask[:, None, :].expand(B, S, S).contiguous()
    torch.testing.assert_close(kernels.attn_core(qkv, full, B, S, N), kernels.attn_core(qkv, mask, B, S, N),
                               rtol=0, atol=0)
    assert attention_bias(mask[:, None, None, :], B, S, S).shape == (B, S)
    assert attention_bias(full[:, None], B, S, S).shape == (B, S, S)


def _dual_params(ws):
    wq, bq, wkv, bkv, wo, bo, gamma, beta = [_torch(w) for w in ws]
    return {"qkv": {"kernel": torch.cat([wq, wkv], 1), "bias": torch.cat([bq, bkv])},
            "query": {"kernel": wq, "bias": bq}, "kv": {"kernel": wkv, "bias": bkv},
            "output": {"dense": {"kernel": wo, "bias": bo}, "LayerNorm": {"gamma": gamma, "beta": beta}}}


@pytest.mark.parametrize("full", ["lang", "visn", "both"])
def test_dual_route_sends_a_full_bias_to_the_two_cross_blocks(monkeypatch, full):
    f, t = 23, 10
    l, v, ws, lang_full = _cross_inputs(5, f, t)
    rng = np.random.default_rng(6)
    visn_full = _full_bias(rng, B, t, f)
    lang_mask = _torch(np.where(rng.random((B, 1, 1, f)) < 0.3, -10000.0, 0.0))
    visn_mask = _torch(np.where(rng.random((B, 1, 1, t)) < 0.3, -10000.0, 0.0))
    # lang <- visn is masked by visn_bias (over the visn keys), visn <- lang by lang_bias
    visn_bias = _torch(lang_full) if full in ("lang", "both") else visn_mask
    lang_bias = _torch(visn_full) if full in ("visn", "both") else lang_mask
    p, cfg, lt, vt = _dual_params(ws), SimpleNamespace(num_attention_heads=N), _torch(l), _torch(v)

    def refuse(*args, **kwargs):
        raise AssertionError("the dual block takes compact biases only")

    blocks = core.KERNEL_BLOCKS._replace(dual=refuse)
    monkeypatch.setenv("KMR_DUAL_CROSS", "1")
    with attention_backend("pallas_packed"):
        got_l, got_v = core.dual_cross_attention_blocks(p, lt, vt, lang_bias, visn_bias, cfg, Precision.f32(),
                                                        blocks)
    wt = [_torch(w) for w in ws]
    torch.testing.assert_close(got_l, cross_attention_block(lt, vt, *wt, N, visn_bias), rtol=0, atol=0)
    torch.testing.assert_close(got_v, cross_attention_block(vt, lt, *wt, N, lang_bias), rtol=0, atol=0)


def test_dual_route_keeps_compact_biases(monkeypatch):
    l, v, ws, _ = _cross_inputs(7, 23, 10)
    rng = np.random.default_rng(8)
    lang_bias = _torch(np.where(rng.random((B, 1, 1, 23)) < 0.3, -10000.0, 0.0))
    visn_bias = _torch(np.where(rng.random((B, 10)) < 0.3, -10000.0, 0.0))
    calls = []

    def spy(*args, **kwargs):
        calls.append(1)
        return core.KERNEL_BLOCKS.dual(*args, **kwargs)

    monkeypatch.setenv("KMR_DUAL_CROSS", "1")
    with attention_backend("pallas_packed"):
        core.dual_cross_attention_blocks(_dual_params(ws), _torch(l), _torch(v), lang_bias, visn_bias,
                                         SimpleNamespace(num_attention_heads=N), Precision.f32(),
                                         core.KERNEL_BLOCKS._replace(dual=spy))
    assert calls == [1]
