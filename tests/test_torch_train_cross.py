"""The port's train cross-attention block against the JAX package's.

``cross_attention_block_train`` of both packages, values and all 10
gradients (x, ctx, the 6 weights and biases of the Q, KV and output
projections, gamma, beta), at dropout 0 and 0.25, in both directions of an
LXMERT x-layer (23 <- 10 and 10 <- 23), with and without the key mask (a
row with every key masked included), at block 8 and at an odd batch that
shrinks the block. The JAX kernels run in interpret mode, drawing their masks
from ``_hash_bits`` over each grid block's [block, F, T]; the port's from its
copy of that hash (the plain versions of its kernels on the CPU). Inputs come
from numpy with a seed; the JAX gradients from ``jax.vjp``, the port's from
its ``autograd.Function`` and from ``torch.autograd`` through the plain
oracle.

Budgets, as ``tests/test_torch_train_blocks.py``: f32 y within 1e-5 and every
gradient within 1e-4 abs + 1e-4 rel (summation order only); bf16 y within
two bf16 ulps of the JAX output above a 1.6e-2 floor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_train import _hash_bits, dropout_cutoff
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_train import (
    cross_attention_block_train as jax_cross_attention_block_train,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import dropout, kernels
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.train_blocks import (
    cross_attention_block_train,
    cross_attention_block_train_backward,
    cross_attention_block_train_plain,
)

B, H, N = 8, 16, 4
F32_Y, F32_GRAD = 1e-5, 1e-4
BF16_ATOL, BF16_RTOL = 1.6e-2, 2.0**-6
WRAP_SEED = 2**31 - 1000  # grid block 1's seed wraps past int32
DIRECTIONS = [(23, 10), (10, 23)]
DIRECTION_IDS = ["lang<-visn", "visn<-lang"]
NAMES = ("x", "ctx", "wq", "bq", "wkv", "bkv", "wo", "bo", "gamma", "beta")


def _inputs(seed: int, f: int, t: int, b: int = B):
    """x [b, f, H], ctx [b, t, H], the 8 weights, a key mask [b, t] of ctx's
    keys (pair 0 with every key masked, as a pair with no box) and a cotangent."""
    r = np.random.default_rng(seed)
    g = lambda *s: (0.3 * r.standard_normal(s)).astype(np.float32)  # noqa: E731
    ws = [g(H, H), g(H), g(H, 2 * H), g(2 * H), g(H, H), g(H),
          (1.0 + 0.1 * r.standard_normal(H)).astype(np.float32), g(H)]
    lengths = r.integers(1, t + 1, b)
    lengths[0] = 0
    mask = np.where(np.arange(t)[None] < lengths[:, None], 0.0, -10000.0).astype(np.float32)
    return g(b, f, H), g(b, t, H), ws, mask, r.standard_normal((b, f, H)).astype(np.float32)


def _jax_run(x, c, ws, cvec, dtype, **kw):
    """y and the vjp of sum(y * cvec) w.r.t. (x, ctx, *ws), from the JAX kernel in interpret mode."""
    seed = jnp.array([kw.pop("seed")], jnp.int32)
    fn = lambda x, c, *w: jax_cross_attention_block_train(  # noqa: E731
        x.astype(dtype), c.astype(dtype), *w, N, seed, interpret=True, **kw)
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(c), *map(jnp.asarray, ws))
    return np.asarray(y.astype(jnp.float32)), [np.asarray(g) for g in vjp(jnp.asarray(cvec).astype(y.dtype))]


def _torch_run(fn, x, c, ws, cvec, dtype):
    xt, ct = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (x, c))
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    y = fn(xt, ct, *wt)
    y.backward(torch.from_numpy(cvec).to(y.dtype))
    return y.detach().float().numpy(), [t.grad.float().numpy() for t in (xt, ct, *wt)]


def _assert_f32(got, want):
    (y, grads), (wy, wgrads) = got, want
    np.testing.assert_allclose(y, wy, atol=F32_Y, rtol=0)
    for g, w, name in zip(grads, wgrads, NAMES, strict=True):
        np.testing.assert_allclose(g, w, atol=F32_GRAD, rtol=F32_GRAD, err_msg=f"grad {name}")


def _port_fns(seed, bias, rate, block_b):
    kw = dict(bias=bias, attn_dropout_rate=rate, hidden_dropout_rate=rate, block_b=block_b)
    return [lambda x, c, *w, fn=fn: fn(x, c, *w, N, seed, **kw)
            for fn in (cross_attention_block_train, cross_attention_block_train_plain)]


# ---- the masks --------------------------------------------------------------------


@pytest.mark.parametrize("f,t", DIRECTIONS, ids=DIRECTION_IDS)
@pytest.mark.parametrize("seed", [777, WRAP_SEED])
def test_cross_masks_equal_jax_hash(seed, f, t):
    """Head i's keep mask over each grid block's [block, F, T] is JAX's _hash_bits draw 1 + i."""
    b, block, rate = 6, 3, 0.3
    got = dropout.cross_probs_keep(seed, rate, b, N, f, t, block).numpy()
    assert got.shape == (b, N, f, t)
    for j in range(b // block):
        block_seed = jnp.int32(seed) + jnp.int32(j) * jnp.int32(1000003)
        for i in range(N):
            want = np.asarray(_hash_bits(block_seed, 1 + i, (block, f, t))) >= dropout_cutoff(rate)
            np.testing.assert_array_equal(got[j * block:(j + 1) * block, i], want)


def test_plain_kernels_drop_the_masked_units():
    """attn_train_cross's plain forward and backward zero exactly the units the hash drops."""
    r = np.random.default_rng(3)
    f, t, b = 23, 10, 4
    q = torch.from_numpy(r.standard_normal((b * f, H)).astype(np.float32))
    kv = torch.from_numpy(r.standard_normal((b * t, 2 * H)).astype(np.float32))
    keep = dropout.cross_probs_keep(9, 0.5, b, N, f, t, 2)
    ident = torch.zeros(b, t, N, H // N)  # V = I per head (t > H/N: the first H/N keys): ctx holds the probs
    ident[:, torch.arange(H // N), :, torch.arange(H // N)] = 1.0
    kv[:, H:] = ident.reshape(b * t, H)
    ctx = kernels.attn_train_cross(q, kv, None, b, f, t, N, 9, 0.5, 2).reshape(b, f, N, H // N).permute(0, 2, 1, 3)
    assert torch.equal(ctx == 0, ~keep[..., :H // N])
    dctx = torch.zeros(b, f, N, H // N)  # dctx = I per head: dV holds the dropped probabilities' transpose
    dctx[:, torch.arange(H // N), :, torch.arange(H // N)] = 1.0
    _, dkv = kernels.attn_train_cross_bwd(q, kv, dctx.reshape(b * f, H), None, b, f, t, N, 9, 0.5, 2)
    dv = dkv[:, H:].reshape(b, t, N, H // N).permute(0, 2, 3, 1)  # [b, n, query, key]
    assert torch.equal(dv == 0, ~keep[:, :, :H // N])


# ---- the block against JAX --------------------------------------------------------


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("f,t", DIRECTIONS, ids=DIRECTION_IDS)
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_cross_train_matches_jax(rate, f, t, with_mask):
    x, c, ws, mask, cvec = _inputs(0, f, t)
    seed = WRAP_SEED if with_mask else 777
    bias = mask if with_mask else None
    want = _jax_run(x, c, ws, cvec, jnp.float32, seed=seed, bias=None if bias is None else jnp.asarray(bias),
                    attn_dropout_rate=rate, hidden_dropout_rate=rate, block_b=B // 2 if with_mask else B)
    for fn in _port_fns(seed, None if bias is None else torch.from_numpy(bias), rate,
                        B // 2 if with_mask else B):
        _assert_f32(_torch_run(fn, x, c, ws, cvec, torch.float32), want)


@pytest.mark.parametrize("f,t", DIRECTIONS, ids=DIRECTION_IDS)
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_cross_train_bf16_matches_jax(rate, f, t):
    x, c, ws, mask, cvec = _inputs(1, f, t)
    want, _ = _jax_run(x, c, ws, cvec, jnp.bfloat16, seed=5, bias=jnp.asarray(mask), attn_dropout_rate=rate,
                       hidden_dropout_rate=rate)
    for fn in _port_fns(5, torch.from_numpy(mask), rate, None):
        got, grads = _torch_run(fn, x, c, ws, cvec, torch.bfloat16)
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)
        assert all(np.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("f,t", DIRECTIONS, ids=DIRECTION_IDS)
def test_odd_batch_shrinks_the_block(f, t):
    """B=6 under block 4 draws per block of 3 pairs, as ``_pick_block`` does,
    in the forward and in the backward's recompute."""
    x, c, ws, mask, cvec = _inputs(4, f, t, b=6)
    want = _jax_run(x, c, ws, cvec, jnp.float32, seed=31, bias=jnp.asarray(mask), attn_dropout_rate=0.25,
                    hidden_dropout_rate=0.25, block_b=4)
    for fn in _port_fns(31, torch.from_numpy(mask), 0.25, 4):
        _assert_f32(_torch_run(fn, x, c, ws, cvec, torch.float32), want)


def test_gradient_dtypes_and_no_key_mask_gradient():
    """bf16 activations: dx and dctx in their dtype, the weight gradients f32;
    the key mask gets none."""
    x, c, ws, mask, cvec = _inputs(5, 23, 10)
    xt, ct = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (x, c))
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    bias = torch.from_numpy(mask).requires_grad_()
    y = cross_attention_block_train(xt, ct, *wt, N, 3, bias=bias, attn_dropout_rate=0.1, hidden_dropout_rate=0.1)
    y.backward(torch.from_numpy(cvec).to(torch.bfloat16))
    assert xt.grad.dtype == ct.grad.dtype == torch.bfloat16
    assert all(w.grad.dtype == torch.float32 for w in wt) and bias.grad is None


def test_cpu_calls_count_no_launches():
    counters = (*kernels.WRAPPERS, cross_attention_block_train, cross_attention_block_train_backward)
    before = [w.launches for w in counters]
    x, c, ws, mask, cvec = _inputs(7, 10, 23)
    _torch_run(lambda x, c, *w: cross_attention_block_train(x, c, *w, N, 1, attn_dropout_rate=0.1), x, c, ws, cvec,
               torch.float32)
    assert [w.launches for w in counters] == before
