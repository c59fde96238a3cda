"""The port's fused blocks against the JAX package's Pallas kernels.

On the CPU the Pallas kernels run in interpret mode and the port's wrappers
run their kernels' plain versions; both are held to the same numpy inputs.
Budgets: f32 <= 1e-5 (both sides compute in f32 and differ only in
summation order). bf16: <= 1.6e-2 abs on LayerNorm outputs of magnitude up
to ~4, one bf16 ulp of the largest outputs (2^-6 at |y| in [2, 4)): the
two sides round the same intermediates to bf16 (qkv, probs, ctx, GELU
output), so a summation-order difference can flip one rounding and move an
output by an ulp.
The CUDA kernels themselves are held to these plain versions on the card by
``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_attention import attention_block_pallas
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_ffn import ffn_block_pallas
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import kernels
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention import mask_to_bias
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention_block import (
    attention_block,
    attention_block_plain,
)
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.ffn_block import ffn_block, ffn_block_plain
from torch_parity import attn_inputs, ffn_inputs

N = 4  # heads at the small width of torch_parity.attn_inputs (H=64)
BUDGET = {"f32": 1e-5, "bf16": 1.6e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("variant", ["loop", "headpack"])
def test_attention_block_matches_pallas(variant, with_bias, dtype):
    x, ws, mask = attn_inputs(0, with_bias=with_bias)
    jax_bias = None if mask is None else jax_mask_to_bias(jnp.asarray(mask))[:, None, None, :]
    want = attention_block_pallas(
        jnp.asarray(x).astype(JNP[dtype]), *map(jnp.asarray, ws), N, jax_bias,
        block_b=2, variant=variant, interpret=True,
    )
    bias = None if mask is None else mask_to_bias(_torch(mask))[:, None, None, :]
    xt, wt = _torch(x, TORCH[dtype]), [_torch(w) for w in ws]
    got = attention_block(xt, *wt, N, bias)
    oracle = attention_block_plain(xt, *wt, N, bias)
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=BUDGET[dtype], rtol=0)
    np.testing.assert_allclose(_f32(oracle), _f32(want), atol=BUDGET[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("approximate", [True, False])
def test_ffn_block_matches_pallas(approximate, dtype):
    x, ws = ffn_inputs(1)
    want = ffn_block_pallas(
        jnp.asarray(x).astype(JNP[dtype]), *map(jnp.asarray, ws),
        approximate_gelu=approximate, block_b=2, interpret=True,
    )
    xt, wt = _torch(x, TORCH[dtype]), [_torch(w) for w in ws]
    got = ffn_block(xt, *wt, approximate_gelu=approximate)
    oracle = ffn_block_plain(xt, *wt, approximate_gelu=approximate)
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=BUDGET[dtype], rtol=0)
    np.testing.assert_allclose(_f32(oracle), _f32(want), atol=BUDGET[dtype], rtol=0)


def test_wrappers_reject_bad_arguments():
    x, ws, _ = attn_inputs(2)
    xt, wt = _torch(x), [_torch(w) for w in ws]
    with pytest.raises(ValueError, match="broadcasts"):
        attention_block(xt, *wt, N, torch.zeros(3, N, 40, 40))  # a bias per head: the kernel's is shared
    with pytest.raises(ValueError, match="residual"):
        kernels.gemm(xt.reshape(120, 64), wt[2], wt[3], "bias", residual=xt.reshape(120, 64))
    with pytest.raises(ValueError, match="epilogue"):
        kernels.gemm(xt.reshape(120, 64), wt[2], wt[3], "relu")


def test_cpu_calls_count_no_launches():
    x, ws, _ = attn_inputs(3)
    before = [w.launches for w in (*kernels.WRAPPERS, attention_block, ffn_block)]
    attention_block(_torch(x), *[_torch(w) for w in ws], N)
    after = [w.launches for w in (*kernels.WRAPPERS, attention_block, ffn_block)]
    assert before == after
