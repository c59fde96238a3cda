"""The entry points of the hand-written kernels as ``torch.library`` custom
ops (namespace ``kmr``), so that ``torch.export`` can trace the
"pallas_packed" and "pallas" routes (``serving/export.py``).

A ctypes call reads ``data_ptr()``, which the fake tensors an export traces
with do not have. Each op here carries a ``register_fake`` function giving its
output's shape and dtype for the trace, and at run time calls the wrapper of
``kernels.py``: the kernel on CUDA tensors, the plain version on CPU tensors,
with the wrapper's launch counter. The blocks of ``ops/`` and the models call
these ops, so an eager run and a reloaded artifact launch the same kernels on
the same inputs. Importing this module registers the ops; a process that
loads a "pallas_packed" artifact imports it and no model module.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from . import kernels


@torch.library.custom_op("kmr::gemm", mutates_args=())
def gemm(a: Tensor, w: Tensor, bias: Optional[Tensor], epilogue: str = "bias", residual: Optional[Tensor] = None,
         aux: Optional[Tensor] = None, trans_b: bool = False) -> Tensor:
    return kernels.gemm(a, w, bias, epilogue, residual, aux, trans_b)


@gemm.register_fake
def _(a, w, bias, epilogue="bias", residual=None, aux=None, trans_b=False):
    n = w.shape[0] if trans_b else w.shape[1]
    return a.new_empty(a.shape[0], n, dtype=torch.float32 if epilogue in kernels.F32_OUT else a.dtype)


@torch.library.custom_op("kmr::gemm_gelu_save", mutates_args=())
def gemm_gelu_save(a: Tensor, w: Tensor, bias: Tensor, approximate_gelu: bool = True) -> tuple[Tensor, Tensor]:
    """(bf16 gelu(a @ w + bias), its f32 pre-activation u): the GEMM's "_save" epilogues."""
    return kernels.gemm(a, w, bias, "gelu_tanh_save" if approximate_gelu else "gelu_erf_save")


@gemm_gelu_save.register_fake
def _(a, w, bias, approximate_gelu=True):
    return a.new_empty(a.shape[0], w.shape[1]), a.new_empty(a.shape[0], w.shape[1], dtype=torch.float32)


@torch.library.custom_op("kmr::attn_core", mutates_args=())
def attn_core(qkv: Tensor, bias: Optional[Tensor], b: int, s: int, num_heads: int) -> Tensor:
    return kernels.attn_core(qkv, bias, b, s, num_heads)


@attn_core.register_fake
def _(qkv, bias, b, s, num_heads):
    return qkv.new_empty(b * s, qkv.shape[1] // 3)


@torch.library.custom_op("kmr::attn_core_cross", mutates_args=())
def attn_core_cross(q: Tensor, kv: Tensor, bias: Optional[Tensor], b: int, sq: int, sk: int,
                    num_heads: int) -> Tensor:
    return kernels.attn_core_cross(q, kv, bias, b, sq, sk, num_heads)


@attn_core_cross.register_fake
def _(q, kv, bias, b, sq, sk, num_heads):
    return q.new_empty(b * sq, q.shape[1])


@torch.library.custom_op("kmr::attn_core_dual", mutates_args=())
def attn_core_dual(lqkv: Tensor, vqkv: Tensor, lang_bias: Optional[Tensor], visn_bias: Optional[Tensor], b: int,
                   f: int, t: int, num_heads: int) -> tuple[Tensor, Tensor]:
    return kernels.attn_core_dual(lqkv, vqkv, lang_bias, visn_bias, b, f, t, num_heads)


@attn_core_dual.register_fake
def _(lqkv, vqkv, lang_bias, visn_bias, b, f, t, num_heads):
    h = lqkv.shape[1] // 3
    return lqkv.new_empty(b * f, h), lqkv.new_empty(b * t, h)


@torch.library.custom_op("kmr::layernorm", mutates_args=())
def layernorm(y: Tensor, gamma: Tensor, beta: Tensor, eps: float = 1e-12,
              out_dtype: Optional[torch.dtype] = torch.bfloat16) -> Tensor:
    return kernels.layernorm(y, gamma, beta, eps, out_dtype)


@layernorm.register_fake
def _(y, gamma, beta, eps=1e-12, out_dtype=torch.bfloat16):
    return y.new_empty(y.shape, dtype=out_dtype or torch.float32)


@torch.library.custom_op("kmr::layer_tail", mutates_args=())
def layer_tail(ctx: Tensor, x: Tensor, wo: Tensor, bo: Tensor, g1: Tensor, be1: Tensor, w1: Tensor, b1: Tensor,
               w2: Tensor, b2: Tensor, g2: Tensor, be2: Tensor, approximate_gelu: bool = True,
               eps: float = 1e-12) -> Tensor:
    return kernels.layer_tail(ctx, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, approximate_gelu, eps)


@layer_tail.register_fake
def _(ctx, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, approximate_gelu=True, eps=1e-12):
    return x.new_empty(x.shape)


@torch.library.custom_op("kmr::mha", mutates_args=())
def mha(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    return kernels.mha(q, k, v, bias)


@mha.register_fake
def _(q, k, v, bias=None):
    kernels.same_length("mha", q, k, v)
    return q.new_empty(q.shape)


@torch.library.custom_op("kmr::mha_packed", mutates_args=())
def mha_packed(q: Tensor, k: Tensor, v: Tensor, num_heads: int, bias: Optional[Tensor] = None) -> Tensor:
    return kernels.mha_packed(q, k, v, num_heads, bias)


@mha_packed.register_fake
def _(q, k, v, num_heads, bias=None):
    kernels.same_length("mha_packed", q, k, v)
    return q.new_empty(q.shape)


@torch.library.custom_op("kmr::ln_train", mutates_args=())
def ln_train(h: Tensor, x: Tensor, gamma: Tensor, beta: Tensor, seed: int, rate: float, rows_per_block: int,
             eps: float = 1e-12) -> Tensor:
    return kernels.ln_train(h, x, gamma, beta, seed, rate, rows_per_block, eps)


@ln_train.register_fake
def _(h, x, gamma, beta, seed, rate, rows_per_block, eps=1e-12):
    return x.new_empty(x.shape)


@torch.library.custom_op("kmr::ln_train_bwd", mutates_args=())
def ln_train_bwd(h: Tensor, x: Tensor, dy: Tensor, gamma: Tensor, seed: int, rate: float, rows_per_block: int,
                 eps: float = 1e-12) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    return kernels.ln_train_bwd(h, x, dy, gamma, seed, rate, rows_per_block, eps)


@ln_train_bwd.register_fake
def _(h, x, dy, gamma, seed, rate, rows_per_block, eps=1e-12):
    parts = -(-h.shape[0] // kernels.LN_TRAIN_BWD_ROWS)
    return (h.new_empty(h.shape), x.new_empty(x.shape), h.new_empty(parts, h.shape[1]),
            h.new_empty(parts, h.shape[1]))


@torch.library.custom_op("kmr::attn_train", mutates_args=())
def attn_train(qkv: Tensor, key_bias: Optional[Tensor], b: int, s: int, num_heads: int, seed: int, rate: float,
               block: int) -> Tensor:
    return kernels.attn_train(qkv, key_bias, b, s, num_heads, seed, rate, block)


@attn_train.register_fake
def _(qkv, key_bias, b, s, num_heads, seed, rate, block):
    return qkv.new_empty(b * s, qkv.shape[1] // 3)


@torch.library.custom_op("kmr::attn_train_bwd", mutates_args=())
def attn_train_bwd(qkv: Tensor, dctx: Tensor, key_bias: Optional[Tensor], b: int, s: int, num_heads: int, seed: int,
                   rate: float, block: int) -> Tensor:
    return kernels.attn_train_bwd(qkv, dctx, key_bias, b, s, num_heads, seed, rate, block)


@attn_train_bwd.register_fake
def _(qkv, dctx, key_bias, b, s, num_heads, seed, rate, block):
    return qkv.new_empty(qkv.shape)


@torch.library.custom_op("kmr::attn_train_cross", mutates_args=())
def attn_train_cross(q: Tensor, kv: Tensor, key_bias: Optional[Tensor], b: int, f: int, t: int, num_heads: int,
                     seed: int, rate: float, block: int) -> Tensor:
    return kernels.attn_train_cross(q, kv, key_bias, b, f, t, num_heads, seed, rate, block)


@attn_train_cross.register_fake
def _(q, kv, key_bias, b, f, t, num_heads, seed, rate, block):
    return q.new_empty(b * f, q.shape[1])


@torch.library.custom_op("kmr::attn_train_cross_bwd", mutates_args=())
def attn_train_cross_bwd(q: Tensor, kv: Tensor, dctx: Tensor, key_bias: Optional[Tensor], b: int, f: int, t: int,
                         num_heads: int, seed: int, rate: float, block: int) -> tuple[Tensor, Tensor]:
    return kernels.attn_train_cross_bwd(q, kv, dctx, key_bias, b, f, t, num_heads, seed, rate, block)


@attn_train_cross_bwd.register_fake
def _(q, kv, dctx, key_bias, b, f, t, num_heads, seed, rate, block):
    return q.new_empty(q.shape), kv.new_empty(kv.shape)
