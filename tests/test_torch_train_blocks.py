"""The port's training blocks against the JAX package's train kernels.

``ffn_block_train`` and ``attention_block_train`` of both packages, values and
gradients, at dropout rates 0 and 0.25: the JAX kernels in interpret mode draw
their masks from ``_hash_bits``, the port's kernels (their plain versions on
the CPU) from its copy of that hash, so both drop the same units. Inputs come
from numpy with a seed; the JAX gradients from ``jax.vjp``, the port's from its
``autograd.Function`` (the backward kernels' plain versions) and from
``torch.autograd`` through the plain oracle.

Budgets: f32 y within 1e-5 and every gradient within 1e-4 abs + 1e-4 rel (both
sides compute in f32 and differ in summation order); bf16 y within two bf16
ulps of the JAX output above a 1.6e-2 floor (both sides round the same
intermediates, so a summation-order difference can flip one rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_train import (
    _hash_bits,
    _pick_block,
    attention_block_train as jax_attention_block_train,
    ffn_block_train as jax_ffn_block_train,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import dropout, kernels
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.train_blocks import (
    attention_block_train,
    attention_block_train_backward,
    attention_block_train_plain,
    ffn_block_train,
    ffn_block_train_backward,
    ffn_block_train_plain,
)

B, S, H, N, I = 4, 8, 16, 4, 32
F32_Y, F32_GRAD = 1e-5, 1e-4
BF16_ATOL, BF16_RTOL = 1.6e-2, 2.0**-6
WRAP_SEED = 2**31 - 1000  # grid block 1's seed wraps past int32


def _inputs(kind: str, seed: int, b: int = B):
    r = np.random.default_rng(seed)
    f = lambda *s: (0.3 * r.standard_normal(s)).astype(np.float32)  # noqa: E731
    if kind == "ffn":
        ws = [f(H, I), f(I), f(I, H), f(H)]
    else:
        ws = [f(H, 3 * H), f(3 * H), f(H, H), f(H)]
    ws += [(1.0 + 0.1 * r.standard_normal(H)).astype(np.float32), f(H)]
    lengths = r.integers(1, S + 1, b)
    mask = np.where(np.arange(S)[None] < lengths[:, None], 0.0, -10000.0).astype(np.float32)
    return f(b, S, H), ws, mask, r.standard_normal((b, S, H)).astype(np.float32)


def _jax_run(fn, x, ws, cvec, dtype):
    """y and the vjp of sum(y * cvec) w.r.t. (x, *ws), from the JAX kernel ``fn``."""
    y, vjp = jax.vjp(lambda x, *ws: fn(x.astype(dtype), *ws), jnp.asarray(x), *map(jnp.asarray, ws))
    return np.asarray(y.astype(jnp.float32)), [np.asarray(g) for g in vjp(jnp.asarray(cvec).astype(y.dtype))]


def _torch_run(fn, x, ws, cvec, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    y = fn(xt, *wt)
    y.backward(torch.from_numpy(cvec).to(y.dtype))
    return y.detach().float().numpy(), [t.grad.float().numpy() for t in (xt, *wt)]


def _assert_f32(got, want):
    y, grads = got
    wy, wgrads = want
    np.testing.assert_allclose(y, wy, atol=F32_Y, rtol=0)
    names = ("x", "w_in", "b_in", "w_out", "b_out", "gamma", "beta")
    for g, w, name in zip(grads, wgrads, names):
        np.testing.assert_allclose(g, w, atol=F32_GRAD, rtol=F32_GRAD, err_msg=f"grad {name}")


# ---- the hash ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 9), (3, 5, 7), (40, 768)])
@pytest.mark.parametrize("draw", [0, 1, 12])
@pytest.mark.parametrize("seed", [0, 12345, -7, -2**31, 2**31 - 1])
def test_hash_bits_equals_jax(seed, draw, shape):
    want = np.asarray(_hash_bits(jnp.int32(seed), draw, shape)).astype(np.int64)
    np.testing.assert_array_equal(dropout.hash_bits(seed, draw, shape).numpy(), want)


@pytest.mark.parametrize("seed", [WRAP_SEED, -2**31 + 5, 777])
def test_block_seeds_wrap_as_int32(seed):
    """Grid block j hashes under int32(seed + j * 1000003), wrapping past int32."""
    got = dropout.block_bits(seed, 3, (2, 5, 5), 4).numpy()
    for j in range(4):
        block_seed = jnp.int32(seed) + jnp.int32(j) * jnp.int32(1000003)
        want = np.asarray(_hash_bits(block_seed, 3, (2, 5, 5))).astype(np.int64)
        np.testing.assert_array_equal(got[j], want)


def test_keep_rate_and_cutoff():
    keep = dropout.hidden_keep(4242, 0.3, 4096, 64, 4096)
    assert abs(keep.float().mean().item() - 0.7) < 0.02
    assert dropout.dropout_cutoff(0.0) == 0 and dropout.dropout_cutoff(1.0) == 2**32 - 1


@pytest.mark.parametrize("b,block", [(100, 8), (7, 8), (13, 4), (256, 4), (6, 4), (1, 8)])
def test_pick_block_equals_jax(b, block):
    assert dropout.pick_block(b, block) == _pick_block(b, block)


def test_train_block_resolution(monkeypatch):
    monkeypatch.delenv("KMR_TRAIN_BLOCK", raising=False)
    monkeypatch.delenv("KMR_TRAIN_BLOCK_FFN", raising=False)
    monkeypatch.delenv("KMR_TRAIN_BLOCK_ATTN", raising=False)
    assert (dropout.train_block("ffn"), dropout.train_block("attn")) == (4, 8)
    monkeypatch.setenv("KMR_TRAIN_BLOCK", "2")
    assert (dropout.train_block("ffn"), dropout.train_block("attn")) == (2, 2)
    monkeypatch.setenv("KMR_TRAIN_BLOCK_ATTN", "16")
    assert (dropout.train_block("ffn"), dropout.train_block("attn"), dropout.train_block("attn", 3)) == (2, 16, 3)
    monkeypatch.setenv("KMR_TRAIN_BLOCK_FFN", "0")
    with pytest.raises(ValueError, match="positive"):
        dropout.train_block("ffn")


# ---- the FFN block -------------------------------------------------------------


@pytest.mark.parametrize("block_b", [B, B // 2])
@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_ffn_train_matches_jax(rate, approx, block_b):
    x, ws, _, cvec = _inputs("ffn", 0)
    seed = WRAP_SEED if block_b < B else 12345
    want = _jax_run(lambda x, *w: jax_ffn_block_train(
        x, *w, jnp.array([seed], jnp.int32), dropout_rate=rate, approximate_gelu=approx, block_b=block_b,
        interpret=True), x, ws, cvec, jnp.float32)
    kw = dict(dropout_rate=rate, approximate_gelu=approx, block_b=block_b)
    _assert_f32(_torch_run(lambda x, *w: ffn_block_train(x, *w, seed, **kw), x, ws, cvec, torch.float32), want)
    _assert_f32(_torch_run(lambda x, *w: ffn_block_train_plain(x, *w, seed, **kw), x, ws, cvec, torch.float32), want)


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_ffn_train_bf16_matches_jax(rate):
    x, ws, _, cvec = _inputs("ffn", 1)
    want, _ = _jax_run(lambda x, *w: jax_ffn_block_train(
        x, *w, jnp.array([99], jnp.int32), dropout_rate=rate, interpret=True), x, ws, cvec, jnp.bfloat16)
    for fn in (ffn_block_train, ffn_block_train_plain):
        got, grads = _torch_run(lambda x, *w: fn(x, *w, 99, dropout_rate=rate), x, ws, cvec, torch.bfloat16)
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)
        assert all(np.isfinite(g).all() for g in grads)


# ---- the self-attention block ------------------------------------------------------


@pytest.mark.parametrize("headpack", [False, True])
@pytest.mark.parametrize("block_b", [B, B // 2])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_attention_train_matches_jax(rate, with_mask, block_b, headpack):
    x, ws, mask, cvec = _inputs("attn", 2)
    seed = WRAP_SEED if block_b < B else 777
    jbias = jnp.asarray(mask) if with_mask else None
    want = _jax_run(lambda x, *w: jax_attention_block_train(
        x, *w, N, jnp.array([seed], jnp.int32), bias=jbias, attn_dropout_rate=rate, hidden_dropout_rate=rate,
        block_b=block_b, interpret=True, headpack=headpack), x, ws, cvec, jnp.float32)
    bias = torch.from_numpy(mask) if with_mask else None
    kw = dict(bias=bias, attn_dropout_rate=rate, hidden_dropout_rate=rate, block_b=block_b)
    for fn in (attention_block_train, attention_block_train_plain):
        _assert_f32(_torch_run(lambda x, *w: fn(x, *w, N, seed, **kw), x, ws, cvec, torch.float32), want)


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_attention_train_bf16_matches_jax(rate):
    x, ws, mask, cvec = _inputs("attn", 3)
    want, _ = _jax_run(lambda x, *w: jax_attention_block_train(
        x, *w, N, jnp.array([5], jnp.int32), bias=jnp.asarray(mask), attn_dropout_rate=rate,
        hidden_dropout_rate=rate, interpret=True, headpack=False), x, ws, cvec, jnp.bfloat16)
    kw = dict(bias=torch.from_numpy(mask), attn_dropout_rate=rate, hidden_dropout_rate=rate)
    for fn in (attention_block_train, attention_block_train_plain):
        got, grads = _torch_run(lambda x, *w: fn(x, *w, N, 5, **kw), x, ws, cvec, torch.bfloat16)
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)
        assert all(np.isfinite(g).all() for g in grads)


# ---- odd batches, masks, counters ------------------------------------------------


@pytest.mark.parametrize("kind", ["ffn", "attn"])
def test_odd_batch_shrinks_the_block(kind):
    """B=6 under block 4 draws per block of 3 pairs, as ``_pick_block`` does."""
    x, ws, mask, cvec = _inputs(kind, 4, b=6)
    if kind == "ffn":
        want = _jax_run(lambda x, *w: jax_ffn_block_train(
            x, *w, jnp.array([31], jnp.int32), dropout_rate=0.25, block_b=4, interpret=True), x, ws, cvec,
            jnp.float32)
        got = _torch_run(lambda x, *w: ffn_block_train(x, *w, 31, dropout_rate=0.25, block_b=4), x, ws, cvec,
                         torch.float32)
    else:
        want = _jax_run(lambda x, *w: jax_attention_block_train(
            x, *w, N, jnp.array([31], jnp.int32), bias=jnp.asarray(mask), attn_dropout_rate=0.25,
            hidden_dropout_rate=0.25, block_b=4, interpret=True, headpack=False), x, ws, cvec, jnp.float32)
        got = _torch_run(lambda x, *w: attention_block_train(
            x, *w, N, 31, bias=torch.from_numpy(mask), attn_dropout_rate=0.25, hidden_dropout_rate=0.25,
            block_b=4), x, ws, cvec, torch.float32)
    _assert_f32(got, want)


def test_masks_follow_the_seed():
    x, ws, _, _ = _inputs("ffn", 5)
    xt, wt = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    a, b, c = (ffn_block_train(xt, *wt, s, dropout_rate=0.4) for s in (1, 1, 2))
    assert torch.equal(a, b) and (a - c).abs().max() > 1e-3


def test_plain_versions_drop_the_masked_units():
    """ln_train_bwd's and attn_train's plain versions zero exactly the units the hash drops."""
    r = np.random.default_rng(6)
    h, x = (torch.from_numpy(r.standard_normal((B * S, H)).astype(np.float32)) for _ in range(2))
    keep = dropout.hidden_keep(3, 0.5, B * S, H, 2 * S)
    _, dh, pg, pb = kernels.ln_train_bwd_plain(h, x, torch.ones(B * S, H) + 0.1 * h, torch.ones(H), 3, 0.5, 2 * S)
    assert torch.equal(dh != 0, keep) and pg.shape == pb.shape == (1, H)
    qkv = torch.from_numpy(r.standard_normal((B * S, 3 * H)).astype(np.float32))
    pkeep = dropout.cross_probs_keep(9, 0.5, B, N, S, S, 2)
    _, _, pd = kernels._train_probs(*kernels._cross_heads(qkv[:, :H], qkv[:, H:], B, S, S, N)[:2], None, 9, 0.5, 2)
    assert torch.equal(pd != 0, pkeep)


def test_cpu_calls_count_no_launches():
    counters = (*kernels.WRAPPERS, ffn_block_train, ffn_block_train_backward, attention_block_train,
                attention_block_train_backward)
    before = [w.launches for w in counters]
    x, ws, _, cvec = _inputs("attn", 7)
    _torch_run(lambda x, *w: attention_block_train(x, *w, N, 1, attn_dropout_rate=0.1), x, ws, cvec, torch.float32)
    assert [w.launches for w in counters] == before
