"""The port's bare attention (``ops/kernels.py:mha``/``mha_packed`` and their
plain versions, the dispatch of ``ops/attention.py``) against the JAX
package's ``mha_pallas``/``mha_pallas_packed`` in interpret mode and its
``mha_xla``, on the same numpy inputs. Shapes: S = 30 and 40; bias none,
[B,1,1,S], [B,1,S,S] and [B,N,S,S]; a ragged B*N. Tolerance: the JAX tests'
own in f32 (2e-5 abs, 1e-4 rel); 1.6e-2 in bf16, where both sides round the
probabilities and the output to bf16 and may round one element apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops import attention as jax_attention
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_attention import mha_pallas, mha_pallas_packed
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import attention, kernels

F32_TOL = {"atol": 2e-5, "rtol": 1e-4}
BF16_ATOL = 1.6e-2
BIASES = ["none", "key", "query-key", "heads"]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32), "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, n, s, dh, bias_kind):
    """q, k, v [b, n, s, dh] f32 and the f32 bias: none, a [b,1,1,s] key mask
    (pair 0's keys past 3 all masked), that mask plus a random [b,1,s,s] or
    [b,n,s,s] score bias."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, s, dh)).astype(np.float32) for _ in range(3))
    if bias_kind == "none":
        return q, k, v, None
    keep = (rng.random((b, 1, 1, s)) > 0.3).astype(np.float32)
    keep[..., 0] = 1.0
    keep[0, ..., 3:] = 0.0
    bias = (1.0 - keep) * -10000.0
    if bias_kind == "query-key":
        bias = bias + rng.standard_normal((b, 1, s, s))
    elif bias_kind == "heads":
        bias = bias + rng.standard_normal((b, n, s, s))
    return q, k, v, bias.astype(np.float32)


def _torch(a, dtype):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _close(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias_kind", BIASES)
@pytest.mark.parametrize("s", [30, 40])
def test_mha_matches_jax_pallas(s, bias_kind, dtype):
    """mha_plain, the mha wrapper (plain on the CPU) and the "pallas" dispatch
    against mha_pallas in interpret mode and against mha_xla."""
    _, jdt, tdt = DTYPES[dtype]
    q, k, v, bias = _inputs(s + len(bias_kind), 4, 4, s, 32, bias_kind)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jbias = None if bias is None else jnp.asarray(bias)
    want = mha_pallas(jq, jk, jv, jbias, block_bn=8, interpret=True)
    want_xla = jax_attention.mha_xla(jq, jk, jv, jbias)
    tq, tk, tv = (_torch(a, tdt) for a in (q, k, v))
    tbias = _torch(bias, torch.float32)
    plain = kernels.mha_plain(tq, tk, tv, tbias)
    with attention.attention_backend("pallas"):
        dispatched = attention.mha(tq, tk, tv, tbias)
    assert plain.dtype == tdt and plain.shape == (4, 4, s, 32)
    assert torch.equal(dispatched, plain) and torch.equal(kernels.mha(tq, tk, tv, tbias), plain)
    _close(plain, want, dtype)
    _close(plain, want_xla, dtype)
    with attention.attention_backend("xla"):
        assert torch.equal(attention.mha(tq, tk, tv, tbias), attention.mha_xla(tq, tk, tv, tbias))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias_kind", BIASES[:3])
@pytest.mark.parametrize("s", [30, 40])
def test_mha_packed_matches_jax_pallas(s, bias_kind, dtype):
    """mha_packed_plain and the ops/attention.py entry point against
    mha_pallas_packed in interpret mode (heads in 64-wide column blocks) and
    against mha_xla on the split heads."""
    _, jdt, tdt = DTYPES[dtype]
    n, dh = 2, 64
    q, k, v, bias = _inputs(s + 7 * len(bias_kind), 5, n, s, dh, bias_kind)
    packed = [a.transpose(0, 2, 1, 3).reshape(5, s, n * dh) for a in (q, k, v)]
    jp = [jnp.asarray(a, jdt) for a in packed]
    jbias = None if bias is None else jnp.asarray(bias)
    want = mha_pallas_packed(*jp, n, jbias, block_b=2, interpret=True)
    want_xla = jax_attention.merge_heads(jax_attention.mha_xla(
        *(jax_attention.split_heads(a, n) for a in jp), jbias))
    tp = [_torch(a, tdt) for a in packed]
    tbias = _torch(bias, torch.float32)
    plain = kernels.mha_packed_plain(*tp, n, tbias)
    assert plain.dtype == tdt and plain.shape == (5, s, n * dh)
    assert torch.equal(attention.mha_packed(*tp, n, tbias), plain)
    _close(plain, want, dtype)
    _close(plain, want_xla, dtype)


def test_mha_ragged_batch_heads():
    """B*N = 6 with JAX's 4-wide blocks: its grid covers a ragged last block."""
    q, k, v, _ = _inputs(3, 3, 2, 30, 16, "none")
    want = mha_pallas(*(jnp.asarray(a) for a in (q, k, v)), None, block_bn=4, interpret=True)
    got = kernels.mha_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,s,bias_kind", [(1, 1, "key"), (3, 17, "query-key"), (1, 16, "heads"), (3, 23, "none")])
def test_mha_ragged_shapes_match_jax_pallas(n, s, bias_kind, dtype):
    """The shapes the card tests add (one head or an odd head count; one key,
    a whole 16-row tile, one row past it): mha and mha_packed (plain on the
    CPU) against mha_pallas in interpret mode over a ragged B*N, at Dh = 64."""
    _, jdt, tdt = DTYPES[dtype]
    q, k, v, bias = _inputs(11 * s + n, 3, n, s, 64, bias_kind)
    jbias = None if bias is None else jnp.asarray(bias)
    want = mha_pallas(*(jnp.asarray(a, jdt) for a in (q, k, v)), jbias, block_bn=4, interpret=True)
    tq, tk, tv = (_torch(a, tdt) for a in (q, k, v))
    tbias = _torch(bias, torch.float32)
    got = kernels.mha(tq, tk, tv, tbias)
    assert got.dtype == tdt and got.shape == (3, n, s, 64)
    _close(got, want, dtype)
    if bias is None or bias.shape[1] == 1:
        packed = [t.transpose(1, 2).reshape(3, s, n * 64) for t in (tq, tk, tv)]
        got = kernels.mha_packed(*packed, n, tbias)
        _close(got, np.asarray(jnp.asarray(want, jnp.float32)).transpose(0, 2, 1, 3).reshape(3, s, n * 64), dtype)


def test_mha_raises_on_cross_attention():
    """k of another length than q: JAX's mha_pallas fails reshaping k
    (ops/pallas_attention.py:58-62); the port's mha raises ValueError, and so
    does mha_packed, on every device and through the dispatch."""
    q, k, v, _ = _inputs(4, 2, 4, 23, 16, "none")
    k, v = k[:, :, :10], v[:, :, :10]
    with pytest.raises(TypeError, match="cannot reshape"):
        mha_pallas(*(jnp.asarray(a) for a in (q, k, v)), None, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v))
    with pytest.raises(ValueError, match="one shape"):
        kernels.mha(tq, tk, tv)
    with attention.attention_backend("pallas"), pytest.raises(ValueError, match="one shape"):
        attention.mha(tq, tk, tv)
    packed = [t.transpose(1, 2).reshape(2, t.shape[2], 64) for t in (tq, tk, tv)]
    with pytest.raises(ValueError, match="one shape"):
        kernels.mha_packed(*packed, 4)
    with pytest.raises(ValueError, match="one shape"):
        attention.mha_packed(*packed, 4)


def test_backend_state():
    """set_attention_backend validates the name; the context manager restores
    the previous backend, also when its block raises."""
    assert attention._backend == "xla" and not attention.packed_attention_active()
    with pytest.raises(ValueError, match="unknown attention backend"):
        attention.set_attention_backend("triton")
    with attention.attention_backend("pallas_packed"):
        assert attention.packed_attention_active()
        with pytest.raises(RuntimeError):
            with attention.attention_backend("pallas"):
                assert attention._backend == "pallas"
                raise RuntimeError
        assert attention._backend == "pallas_packed"
    assert attention._backend == "xla"


def test_cpu_calls_count_no_launches():
    q, k, v, bias = _inputs(5, 2, 4, 30, 64, "key")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    before = [w.launches for w in kernels.WRAPPERS]
    kernels.mha(*t, torch.from_numpy(bias))
    kernels.mha_packed(*[a.transpose(1, 2).reshape(2, 30, 256) for a in t], 4, torch.from_numpy(bias))
    assert [w.launches for w in kernels.WRAPPERS] == before
