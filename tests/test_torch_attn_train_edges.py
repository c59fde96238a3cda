"""The train attention kernels' plain versions against the JAX package at the tile edges.

``csrc/attn_train.cu`` walks queries and keys in 16-row tiles on the card, and
``tests/test_torch_cuda.py`` holds it against ``attn_train_plain`` /
``attn_train_bwd_plain`` and the cross plain versions at lengths 1 to 64. Here
those plain versions (the CPU path of the kernels' wrappers, reached through
``attention_block_train`` and ``cross_attention_block_train``) are held against
the JAX package's blocks in interpret mode at the same edges: self-attention at
S = 1, 17 and 64, cross attention at 64 <- 1 and 1 <- 64, with every key of
one pair masked, at dropout 0 and 0.25. Values and all gradients, f32, as
``tests/test_torch_train_blocks.py`` and ``tests/test_torch_train_cross.py``
hold them: y within 1e-5, gradients within 1e-4 abs + 1e-4 rel (summation
order only). The pair whose keys are all masked has its y held within
MASKED_PAIR_Y: its scores sit near the callers' -10000, where f32 resolves
2^-10, so a summation-order difference of one ulp in a score can flip that
rounding and move the pair's probabilities by ~1e-3 relative (1.9e-5 on y at
S=64 with this seed, the other pairs within 1e-6). Inputs come from numpy with
a seed; small widths (B=4, 2 heads of 8) keep the file short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_train import (
    attention_block_train as jax_attention_block_train,
    cross_attention_block_train as jax_cross_attention_block_train,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.train_blocks import (
    attention_block_train,
    cross_attention_block_train,
)

B, H, N = 4, 16, 2
RATES = [0.0, 0.25]
F32_Y, F32_GRAD = 1e-5, 1e-4
MASKED = 1  # the pair with every key masked
MASKED_PAIR_Y = 1e-4


def _mask(r, b: int, s: int) -> np.ndarray:
    """Ragged key-mask rows [b, s] (key 0 live) with every key of pair MASKED masked."""
    lengths = r.integers(1, s + 1, b)
    mask = np.where(np.arange(s)[None] < lengths[:, None], 0.0, -10000.0).astype(np.float32)
    mask[MASKED] = -10000.0
    return mask


def _weights(r, shapes):
    return [(0.3 * r.standard_normal(sh)).astype(np.float32) for sh in shapes] + [
        (1.0 + 0.1 * r.standard_normal(H)).astype(np.float32), (0.3 * r.standard_normal(H)).astype(np.float32)]


def _jax_grads(fn, arrays, cvec):
    y, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(cvec))]


def _torch_grads(fn, arrays, cvec):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y = fn(*leaves)
    y.backward(torch.from_numpy(cvec))
    return y.detach().numpy(), [t.grad.numpy() for t in leaves]


def _assert_close(got, want):
    (y, grads), (wy, wgrads) = got, want
    live = np.arange(B) != MASKED
    np.testing.assert_allclose(y[live], wy[live], atol=F32_Y, rtol=0)
    np.testing.assert_allclose(y[MASKED], wy[MASKED], atol=MASKED_PAIR_Y, rtol=0)
    for i, (g, w) in enumerate(zip(grads, wgrads, strict=True)):
        np.testing.assert_allclose(g, w, atol=F32_GRAD, rtol=F32_GRAD, err_msg=f"gradient {i}")


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("s", [1, 17, 64])
def test_self_attention_train_at_tile_edges_matches_jax(s, rate):
    r = np.random.default_rng(40 + s)
    x = (0.3 * r.standard_normal((B, s, H))).astype(np.float32)
    ws = _weights(r, [(H, 3 * H), (3 * H,), (H, H), (H,)])
    mask, cvec = _mask(r, B, s), r.standard_normal((B, s, H)).astype(np.float32)
    kw = dict(attn_dropout_rate=rate, hidden_dropout_rate=rate, block_b=2)
    want = _jax_grads(lambda x, *w: jax_attention_block_train(
        x, *w, N, jnp.array([21], jnp.int32), bias=jnp.asarray(mask), interpret=True, headpack=False, **kw),
        [x, *ws], cvec)
    got = _torch_grads(lambda x, *w: attention_block_train(x, *w, N, 21, bias=torch.from_numpy(mask), **kw),
                       [x, *ws], cvec)
    _assert_close(got, want)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("f,t", [(64, 1), (1, 64)], ids=["64<-1", "1<-64"])
def test_cross_attention_train_at_tile_edges_matches_jax(f, t, rate):
    r = np.random.default_rng(50 + f)
    x, c = ((0.3 * r.standard_normal((B, n, H))).astype(np.float32) for n in (f, t))
    ws = _weights(r, [(H, H), (H,), (H, 2 * H), (2 * H,), (H, H), (H,)])
    mask, cvec = _mask(r, B, t), r.standard_normal((B, f, H)).astype(np.float32)
    kw = dict(attn_dropout_rate=rate, hidden_dropout_rate=rate, block_b=2)
    want = _jax_grads(lambda x, c, *w: jax_cross_attention_block_train(
        x, c, *w, N, jnp.array([22], jnp.int32), bias=jnp.asarray(mask), interpret=True, **kw), [x, c, *ws], cvec)
    got = _torch_grads(lambda x, c, *w: cross_attention_block_train(x, c, *w, N, 22, bias=torch.from_numpy(mask), **kw),
                       [x, c, *ws], cvec)
    _assert_close(got, want)
