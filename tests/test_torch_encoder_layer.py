"""The port's fused encoder layer (``KMR_FUSED_LAYER=1``) against the JAX
package's ``encoder_layer_pallas`` in interpret mode, on the same numpy
inputs: the wrapper (on the CPU, its kernels' plain versions: ``gemm``,
``attn_core``, ``layer_tail``) and the independent oracle
``encoder_layer_plain``, over both Pallas variants, with and without a key
mask, tanh and erf GELU, at the four lengths of the models (S = 40
ImageBERT-A, 30 ImageBERT-B/C, 23 and 10 LXMERT's streams).

Budgets as ``test_torch_blocks.py``: f32 <= 1e-5 (summation order only);
bf16 <= 1.6e-2, one bf16 ulp of the largest LayerNorm outputs, since both
sides round the same intermediates (qkv, probs, ctx, LN1 output, GELU output).
The CUDA kernel itself is held to these plain versions by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.attention import mask_to_bias as jax_mask_to_bias
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu.ops.pallas_layer import encoder_layer_pallas
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.models import core
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops import kernels
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.attention import attention_backend, mask_to_bias
from kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch.ops.encoder_layer import (
    encoder_layer,
    encoder_layer_plain,
)
from torch_parity import TINY, layer_inputs

N = 4  # heads at the small width of torch_parity.layer_inputs (H=64)
BUDGET = {"f32": 1e-5, "bf16": 1.6e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [40, 30, 23, 10])
@pytest.mark.parametrize("act", ["gelu", "gelu_erf"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("variant", ["loop", "headpack"])
def test_encoder_layer_matches_pallas(variant, with_bias, act, s, dtype):
    x, ws, mask = layer_inputs(s, s=s, with_bias=with_bias)
    tanh = act == "gelu"
    jax_bias = None if mask is None else jax_mask_to_bias(jnp.asarray(mask))[:, None, None, :]
    want = encoder_layer_pallas(
        jnp.asarray(x).astype(JNP[dtype]), *map(jnp.asarray, ws), N, jax_bias,
        approximate_gelu=tanh, block_b=2, variant=variant, interpret=True,
    )
    bias = None if mask is None else mask_to_bias(torch.from_numpy(mask))
    xt, wt = torch.from_numpy(x).to(TORCH[dtype]), [torch.from_numpy(w) for w in ws]
    got = encoder_layer(xt, *wt, N, bias, approximate_gelu=tanh)
    oracle = encoder_layer_plain(xt, *wt, N, bias, approximate_gelu=tanh)
    assert got.dtype == TORCH[dtype] and got.shape == x.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=BUDGET[dtype], rtol=0)
    np.testing.assert_allclose(_f32(oracle), _f32(want), atol=BUDGET[dtype], rtol=0)


@pytest.mark.parametrize("act", ["gelu", "gelu_erf"])
def test_fused_route_matches_two_blocks(monkeypatch, act):
    """encoder() with KMR_FUSED_LAYER=1 (one fused layer each) and without (two
    blocks each) agree in f32, through the kernel wrappers and the oracles."""
    cfg = core.BertConfig(**TINY, hidden_act=act)
    params = core.encoder_init(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 30, TINY["hidden_size"])).astype(np.float32))
    keep = torch.ones(3, 30)
    keep[0, 7:] = 0.0
    bias = mask_to_bias(keep)
    prec = core.Precision.f32()
    for blocks in (core.KERNEL_BLOCKS, core.PLAIN_BLOCKS):
        monkeypatch.delenv("KMR_FUSED_LAYER", raising=False)
        with attention_backend("pallas_packed"):  # the fused layer's backend
            two = core.encoder(params, x, bias, cfg, prec, blocks)
            monkeypatch.setenv("KMR_FUSED_LAYER", "1")
            fused = core.encoder(params, x, bias, cfg, prec, blocks)
            kept = core.encoder(params, x, bias, cfg, prec, blocks, fuse=False)
        np.testing.assert_allclose(fused.numpy(), two.numpy(), atol=1e-6, rtol=0)
        assert torch.equal(kept, two)


def test_fused_route_gating(monkeypatch):
    """The fused layer runs only under KMR_FUSED_LAYER=1 on the
    "pallas_packed" backend, for a compact key mask or none and a GELU the
    kernel has (the JAX gating)."""
    monkeypatch.setenv("KMR_FUSED_LAYER", "1")
    assert not core.fused_layer_route(None, "gelu")  # the default backend, "xla"
    with attention_backend("pallas_packed"):
        assert core.fused_layer_route(None, "gelu") and core.fused_layer_route(torch.zeros(2, 5), "gelu_erf")
        assert core.fused_layer_route(torch.zeros(2, 1, 1, 5), "gelu")
        assert not core.fused_layer_route(torch.zeros(2, 1, 5, 5), "gelu")
        assert not core.fused_layer_route(None, "relu")
        monkeypatch.setenv("KMR_FUSED_LAYER", "0")
        assert not core.fused_layer_route(None, "gelu")


def test_layer_tail_plain_is_the_blocks_tail():
    """layer_tail_plain equals the attention block's out-projection + LN and
    the FFN block run after it, on the same ctx, bit for bit in f32."""
    x, ws, _ = layer_inputs(5, s=10)
    xt, wt = torch.from_numpy(x).reshape(-1, 64), [torch.from_numpy(w) for w in ws]
    ctx = torch.from_numpy(np.random.default_rng(6).standard_normal((30, 64)).astype(np.float32))
    y = kernels.gemm_plain(ctx, wt[2], wt[3], "residual", xt)
    a = kernels.layernorm_plain(y, wt[4], wt[5], out_dtype=torch.float32)
    hmid = kernels.gemm_plain(a, wt[6], wt[7], "gelu_tanh")
    want = kernels.layernorm_plain(kernels.gemm_plain(hmid, wt[8], wt[9], "residual", a), wt[10], wt[11])
    assert torch.equal(kernels.layer_tail(ctx, xt, *wt[2:]), want)


def test_cpu_calls_count_no_launches():
    x, ws, mask = layer_inputs(7, s=23, with_bias=True)
    counted = (*kernels.WRAPPERS, encoder_layer)
    before = [w.launches for w in counted]
    encoder_layer(torch.from_numpy(x), *[torch.from_numpy(w) for w in ws], N, mask_to_bias(torch.from_numpy(mask)))
    assert [w.launches for w in counted] == before
