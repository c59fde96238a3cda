"""Wrappers over the hand-written CUDA kernels of ``csrc/``, each with its
plain PyTorch version and a launch counter.

The two fused blocks (``attention_block.py``, ``ffn_block.py``) are built
from these three kernels:

* ``gemm``       ``csrc/gemm_bf16.cu``: bf16 ``A @ W + b`` with a fused
                 epilogue (bf16 out, GELU then bf16, or + residual in f32).
* ``attn_core``  ``csrc/attn_core.cu``: per-head softmax(QK^T/8 + key bias)V
                 read from the fused [B*S, 3H] QKV buffer.
* ``layernorm``  ``csrc/layernorm.cu``: f32 row LayerNorm, bf16 out.

On a CPU tensor each wrapper runs its plain version. On a CUDA tensor it
launches its kernel or raises; there is no fallback. ``<wrapper>.launches``
counts kernel launches (never plain calls), so a run can show that its path
went through the kernels. The plain versions round where the kernels (and
the Pallas bodies they replace) round, so the two agree to accumulation
order.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .activations import gelu_erf, gelu_tanh
from .attention import merge_heads, mha, split_heads

EPILOGUES = {"bias": 0, "gelu_tanh": 1, "gelu_erf": 2, "residual": 3}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_operand(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device) -> None:
    _require(t.device == device, f"{name} is on {t.device}, expected {device}")
    _require(t.dtype == dtype, f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


# ---------------------------------------------------------------------------
# gemm: out = epilogue(a @ w + bias)
# ---------------------------------------------------------------------------


def gemm_plain(a, w, bias, epilogue: str = "bias", residual=None) -> torch.Tensor:
    """f32 product of a and w (w rounded to a's dtype first), + f32 bias;
    "residual" adds residual and stays f32, the others end in a's dtype."""
    y = torch.matmul(a.float(), w.to(a.dtype).float()) + bias.float()
    if epilogue == "residual":
        return y + residual.float()
    if epilogue == "gelu_tanh":
        y = gelu_tanh(y)
    elif epilogue == "gelu_erf":
        y = gelu_erf(y)
    return y.to(a.dtype)


def gemm(a, w, bias, epilogue: str = "bias", residual=None) -> torch.Tensor:
    """a [M, K] bf16, w [K, N] bf16, bias [N] f32 (+ residual [M, N] bf16)
    -> [M, N] bf16, or f32 for the "residual" epilogue."""
    _require(epilogue in EPILOGUES, f"unknown epilogue {epilogue!r}")
    _require((epilogue == "residual") == (residual is not None),
             "a residual goes with the 'residual' epilogue and only with it")
    if not a.is_cuda:
        return gemm_plain(a, w, bias, epilogue, residual)
    m, k = a.shape
    k2, n = w.shape
    _require(k == k2, f"inner dims differ: a {tuple(a.shape)}, w {tuple(w.shape)}")
    lib = _build.load("gemm_bf16")
    tile_n, tile_k = lib.kmr_gemm_tile_n(), lib.kmr_gemm_tile_k()
    _require(n % tile_n == 0 and k % tile_k == 0,
             f"gemm_bf16 needs N % {tile_n} == 0 and K % {tile_k} == 0, got N={n}, K={k}")
    _require(m > 0, "empty gemm")
    for t, name, dt in ((a, "a", torch.bfloat16), (w, "w", torch.bfloat16), (bias, "bias", torch.float32)):
        _check_operand(t, name, dt, a.device)
    _require(tuple(bias.shape) == (n,), f"bias shape {tuple(bias.shape)} != ({n},)")
    if residual is not None:
        _check_operand(residual, "residual", torch.bfloat16, a.device)
        _require(tuple(residual.shape) == (m, n), "residual shape must equal the output's")
    out = torch.empty(m, n, dtype=torch.float32 if residual is not None else torch.bfloat16,
                      device=a.device)
    fn = _build.bind("gemm_bf16", "kmr_gemm_bf16", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(_build.ptr(a), _build.ptr(w), _build.ptr(bias),
            _build.ptr(residual) if residual is not None else None, _build.ptr(out),
            m, n, k, EPILOGUES[epilogue], _build.stream_of(a))
    _build.check(rc, "gemm_bf16")
    gemm.launches += 1
    return out


gemm.launches = 0


# ---------------------------------------------------------------------------
# attn_core: per-head attention on the fused QKV buffer
# ---------------------------------------------------------------------------


def attn_core_plain(qkv, key_bias, b: int, s: int, num_heads: int) -> torch.Tensor:
    """qkv [B*S, 3H] -> ctx [B*S, H] in qkv's dtype; key_bias [B, S] or None."""
    h = qkv.shape[1] // 3
    q, k, v = (split_heads(t.reshape(b, s, h), num_heads) for t in qkv.split(h, dim=1))
    bias = None if key_bias is None else key_bias.reshape(b, 1, 1, s)
    return merge_heads(mha(q, k, v, bias)).reshape(b * s, h)


def attn_core(qkv, key_bias, b: int, s: int, num_heads: int) -> torch.Tensor:
    """qkv [B*S, 3H] bf16, key_bias [B, S] f32 or None -> ctx [B*S, H] bf16."""
    if not qkv.is_cuda:
        return attn_core_plain(qkv, key_bias, b, s, num_heads)
    lib = _build.load("attn_core")
    h = qkv.shape[1] // 3
    _require(qkv.shape == (b * s, 3 * h), f"qkv shape {tuple(qkv.shape)} != ({b * s}, {3 * h})")
    _require(h == num_heads * lib.kmr_attn_head_dim(),
             f"attn_core takes head dim {lib.kmr_attn_head_dim()}, got {h // num_heads}")
    _require(1 <= s <= lib.kmr_attn_max_seq(), f"attn_core takes S <= {lib.kmr_attn_max_seq()}, got {s}")
    _require(1 <= b <= 65535, f"attn_core takes 1..65535 pairs per launch, got {b}")
    _check_operand(qkv, "qkv", torch.bfloat16, qkv.device)
    if key_bias is not None:
        _check_operand(key_bias, "key_bias", torch.float32, qkv.device)
        _require(tuple(key_bias.shape) == (b, s), f"key_bias shape {tuple(key_bias.shape)} != ({b}, {s})")
    ctx = torch.empty(b * s, h, dtype=torch.bfloat16, device=qkv.device)
    fn = _build.bind("attn_core", "kmr_attn_core", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(_build.ptr(qkv), _build.ptr(key_bias) if key_bias is not None else None,
            _build.ptr(ctx), b, s, h, num_heads, _build.stream_of(qkv))
    _build.check(rc, "attn_core")
    attn_core.launches += 1
    return ctx


attn_core.launches = 0


# ---------------------------------------------------------------------------
# layernorm: f32 row LayerNorm
# ---------------------------------------------------------------------------


def layernorm_plain(y, gamma, beta, eps: float = 1e-12, out_dtype=None) -> torch.Tensor:
    """LayerNorm over the last axis with f32 internals (``models/core.py``
    of the JAX package, :139-150); out_dtype=None keeps f32."""
    y = y.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    out = (y - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return out if out_dtype is None else out.to(out_dtype)


def layernorm(y, gamma, beta, eps: float = 1e-12, out_dtype=torch.bfloat16) -> torch.Tensor:
    """y [M, H] f32 -> LayerNorm(y) [M, H] in out_dtype (bf16 on CUDA)."""
    if not y.is_cuda:
        return layernorm_plain(y, gamma, beta, eps, out_dtype)
    lib = _build.load("layernorm")
    m, h = y.shape
    _require(out_dtype == torch.bfloat16, "the layernorm kernel writes bf16")
    _require(h % 128 == 0 and h <= lib.kmr_layernorm_max_hidden(),
             f"layernorm takes H % 128 == 0 and H <= {lib.kmr_layernorm_max_hidden()}, got {h}")
    _require(m > 0, "empty layernorm")
    for t, name in ((y, "y"), (gamma, "gamma"), (beta, "beta")):
        _check_operand(t, name, torch.float32, y.device)
    _require(gamma.shape == (h,) and beta.shape == (h,), "gamma and beta must be [H]")
    out = torch.empty(m, h, dtype=torch.bfloat16, device=y.device)
    fn = _build.bind("layernorm", "kmr_layernorm",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(_build.ptr(y), _build.ptr(gamma), _build.ptr(beta), _build.ptr(out), m, h, eps,
            _build.stream_of(y))
    _build.check(rc, "layernorm")
    layernorm.launches += 1
    return out


layernorm.launches = 0

WRAPPERS = (gemm, attn_core, layernorm)
