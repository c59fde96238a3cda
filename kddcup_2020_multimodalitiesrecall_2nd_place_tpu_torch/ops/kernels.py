"""Wrappers over the hand-written CUDA kernels of ``csrc/``, each with its
plain PyTorch version and a launch counter.

The fused blocks (``attention_block.py``, ``ffn_block.py``,
``cross_attention_block.py``, ``dual_cross_attention_block.py``,
``encoder_layer.py``) are built from these four kernels:

* ``gemm``       ``csrc/gemm_bf16.cu``: bf16 ``A @ W + b`` with a fused
                 epilogue (bf16 out, GELU then bf16, + residual in f32, or
                 f32 out: ImageBERT-B's banded label conv).
* ``attn_core``  ``csrc/attn_core.cu``: per-head softmax(QK^T/8 + bias)V
                 read from the fused [B*S, 3H] QKV buffer, under no bias, a key
                 mask [B, S] or a full [B, S, S] bias; its two other entry
                 points are ``attn_core_cross`` (Q [B*Sq, H] against a fused
                 K/V [B*Sk, 2H]) and ``attn_core_dual`` (both directions of an
                 LXMERT x-layer from the two streams' QKV buffers, one launch).
* ``layernorm``  ``csrc/layernorm.cu``: f32 row LayerNorm, bf16 out.
* ``layer_tail`` ``csrc/layer_tail.cu``: everything of a post-LN encoder
                 layer after its attention core (out-projection, LN1, FFN,
                 LN2) in one launch, the LN1 output and the GELU
                 intermediate kept in shared memory.

Two more, ``csrc/mha.cu``, are bare attention on their own: ``mha`` (q, k, v
[B, N, S, Dh] at any strides, the "pallas" attention backend) and
``mha_packed`` (q, k, v [B, S, H], heads in column blocks), bf16 or f32.

The training blocks (``train_blocks.py``) add two kernels, each with a
forward and a backward entry point, and the GEMM's transposed-weight mode
(``trans_b``: a @ w^T) and its training epilogues:

* ``ln_train`` / ``ln_train_bwd`` ``csrc/ln_train.cu``: the hidden dropout,
  residual and LayerNorm closing a train block, and its backward (dz, the
  dropped dh, per-CTA dgamma/dbeta partials).
* ``attn_train`` / ``attn_train_bwd`` ``csrc/attn_train.cu``: per-head
  attention with the probability dropout, and its backward (dqkv); its
  cross entry points ``attn_train_cross`` / ``attn_train_cross_bwd`` take Q
  [B*F, H] against a fused K/V [B*T, 2H] and write dq and dkv (the train
  cross block of the LXMERT x-layers).

Their dropout masks are the JAX package's interpret-mode hash masks
(``dropout.py``, ``csrc/dropout_hash.cuh``).

On a CPU tensor each wrapper runs its plain version. On a CUDA tensor it
launches its kernel or raises; there is no fallback. ``<wrapper>.launches``
counts kernel launches (never plain calls), so a run can show that its path
went through the kernels. The plain versions round where the kernels (and
the Pallas bodies they replace) round, so the two agree to accumulation
order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .activations import gelu_bwd, gelu_erf, gelu_tanh
from .attention import merge_heads, mha_xla, split_heads
from .dropout import cross_probs_keep, dropout_cutoff, hidden_keep, keep_scale

EPILOGUES = {"bias": 0, "gelu_tanh": 1, "gelu_erf": 2, "residual": 3, "f32": 4, "gelu_tanh_save": 5,
             "gelu_erf_save": 6, "gelu_bwd_tanh": 7, "gelu_bwd_erf": 8, "residual_f32": 9}
F32_OUT = ("residual", "f32")  # the epilogues that write f32
SAVE = ("gelu_tanh_save", "gelu_erf_save")  # also write u = acc + bias (f32): -> (out, u)
AUX_IN = ("gelu_bwd_tanh", "gelu_bwd_erf", "residual_f32")  # read an f32 [M, N] aux input


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_operand(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device) -> None:
    _require(t.device == device, f"{name} is on {t.device}, expected {device}")
    _require(t.dtype == dtype, f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


# ---------------------------------------------------------------------------
# gemm: out = epilogue(a @ w + bias), or a @ w^T with trans_b
# ---------------------------------------------------------------------------


def gemm_plain(a, w, bias, epilogue: str = "bias", residual=None, aux=None, trans_b: bool = False):
    """f32 product of a and w (or w^T; w rounded to a's dtype first), + f32
    bias unless None; "residual" adds residual and "f32" adds nothing, both
    staying f32; the "_save" epilogues return (gelu in a's dtype, the f32
    pre-activation); "gelu_bwd_*" multiply by gelu'(aux) and "residual_f32"
    adds aux; all others end in a's dtype."""
    wt = w.to(a.dtype).float()
    y = torch.matmul(a.float(), wt.T if trans_b else wt)
    if bias is not None:
        y = y + bias.float()
    if epilogue == "residual":
        return y + residual.float()
    if epilogue == "f32":
        return y
    if epilogue in SAVE:
        return (gelu_tanh(y) if epilogue == "gelu_tanh_save" else gelu_erf(y)).to(a.dtype), y
    if epilogue in ("gelu_bwd_tanh", "gelu_bwd_erf"):
        y = y * gelu_bwd(aux, epilogue == "gelu_bwd_tanh")
    elif epilogue == "residual_f32":
        y = y + aux.float()
    elif epilogue == "gelu_tanh":
        y = gelu_tanh(y)
    elif epilogue == "gelu_erf":
        y = gelu_erf(y)
    return y.to(a.dtype)


def gemm(a, w, bias, epilogue: str = "bias", residual=None, aux=None, trans_b: bool = False):
    """a [M, K] bf16, w [K, N] bf16 (or [N, K] with trans_b, read as its
    transpose), bias [N] f32 or None (+ residual [M, N] bf16, or aux [M, N]
    f32) -> [M, N] bf16, or f32 for the "residual" and "f32" epilogues; the
    "_save" epilogues -> (bf16 [M, N], f32 u [M, N])."""
    _require(epilogue in EPILOGUES, f"unknown epilogue {epilogue!r}")
    _require((epilogue == "residual") == (residual is not None),
             "a residual goes with the 'residual' epilogue and only with it")
    _require((epilogue in AUX_IN) == (aux is not None),
             f"an aux input goes with the {AUX_IN} epilogues and only with them")
    if not a.is_cuda:
        return gemm_plain(a, w, bias, epilogue, residual, aux, trans_b)
    m, k = a.shape
    n, k2 = w.shape if trans_b else w.shape[::-1]
    _require(k == k2, f"inner dims differ: a {tuple(a.shape)}, w {tuple(w.shape)}, trans_b={trans_b}")
    lib = _build.load("gemm_bf16")
    tile_n, tile_k = lib.kmr_gemm_tile_n(), lib.kmr_gemm_tile_k()
    _require(n % tile_n == 0 and k % tile_k == 0,
             f"gemm_bf16 needs N % {tile_n} == 0 and K % {tile_k} == 0, got N={n}, K={k}")
    _require(m > 0, "empty gemm")
    for t, name, dt in ((a, "a", torch.bfloat16), (w, "w", torch.bfloat16)):
        _check_operand(t, name, dt, a.device)
    if bias is not None:
        _check_operand(bias, "bias", torch.float32, a.device)
        _require(tuple(bias.shape) == (n,), f"bias shape {tuple(bias.shape)} != ({n},)")
    if residual is not None:
        _check_operand(residual, "residual", torch.bfloat16, a.device)
        _require(tuple(residual.shape) == (m, n), "residual shape must equal the output's")
    if aux is not None:
        _check_operand(aux, "aux", torch.float32, a.device)
        _require(tuple(aux.shape) == (m, n), "aux shape must equal the output's")
    out = torch.empty(m, n, dtype=torch.float32 if epilogue in F32_OUT else torch.bfloat16,
                      device=a.device)
    if epilogue in SAVE:
        aux = torch.empty(m, n, dtype=torch.float32, device=a.device)
    fn = _build.bind("gemm_bf16", "kmr_gemm_bf16", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    opt = lambda t: _build.ptr(t) if t is not None else None  # noqa: E731
    rc = fn(_build.ptr(a), _build.ptr(w), opt(bias), opt(residual), opt(aux), _build.ptr(out),
            m, n, k, EPILOGUES[epilogue], int(trans_b), _build.stream_of(a))
    _build.check(rc, "gemm_bf16")
    gemm.launches += 1
    return (out, aux) if epilogue in SAVE else out


gemm.launches = 0


# ---------------------------------------------------------------------------
# attn_core: per-head attention; self, cross and dual-cross entry points
# ---------------------------------------------------------------------------


def attn_core_cross_plain(q, kv, bias, b: int, sq: int, sk: int, num_heads: int) -> torch.Tensor:
    """q [B*Sq, H], kv [B*Sk, 2H] (keys then values) -> ctx [B*Sq, H] in q's
    dtype; bias a key mask [B, Sk], a full [B, Sq, Sk] bias or None."""
    h = q.shape[1]
    qh = split_heads(q.reshape(b, sq, h), num_heads)
    k, v = (split_heads(t.reshape(b, sk, h), num_heads) for t in kv.split(h, dim=1))
    if bias is not None:
        bias = bias.reshape(b, 1, 1, sk) if bias.dim() == 2 else bias.reshape(b, 1, sq, sk)
    return merge_heads(mha_xla(qh, k, v, bias)).reshape(b * sq, h)


def attn_core_plain(qkv, bias, b: int, s: int, num_heads: int) -> torch.Tensor:
    """qkv [B*S, 3H] -> ctx [B*S, H] in qkv's dtype; bias [B, S], [B, S, S] or None."""
    h = qkv.shape[1] // 3
    return attn_core_cross_plain(qkv[:, :h], qkv[:, h:], bias, b, s, s, num_heads)


def attn_core_dual_plain(lqkv, vqkv, lang_bias, visn_bias, b: int, f: int, t: int,
                         num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """lqkv [B*F, 3H], vqkv [B*T, 3H] -> (lang <- visn ctx [B*F, H] under the
    visn key mask, visn <- lang ctx [B*T, H] under the lang key mask)."""
    h = lqkv.shape[1] // 3
    return (attn_core_cross_plain(lqkv[:, :h], vqkv[:, h:], visn_bias, b, f, t, num_heads),
            attn_core_cross_plain(vqkv[:, :h], lqkv[:, h:], lang_bias, b, t, f, num_heads))


def _attn_checks(h: int, num_heads: int, b: int, lengths) -> None:
    lib = _build.load("attn_core")
    _require(h == num_heads * lib.kmr_attn_head_dim(),
             f"attn_core takes head dim {lib.kmr_attn_head_dim()}, got {h // num_heads}")
    _require(num_heads % lib.kmr_attn_head_group() == 0,
             f"attn_core takes a multiple of {lib.kmr_attn_head_group()} heads, got {num_heads}")
    for s in lengths:
        _require(1 <= s <= lib.kmr_attn_max_seq(), f"attn_core takes S <= {lib.kmr_attn_max_seq()}, got {s}")
    _require(1 <= b <= 65535, f"attn_core takes 1..65535 pairs per launch, got {b}")


def _rows(t, name: str, shape: tuple[int, int]) -> None:
    _check_operand(t, name, torch.bfloat16, t.device)
    _require(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")


def _key_bias_ptr(key_bias, name: str, b: int, s: int, device):
    if key_bias is None:
        return None
    _check_operand(key_bias, name, torch.float32, device)
    _require(tuple(key_bias.shape) == (b, s), f"{name} shape {tuple(key_bias.shape)} != ({b}, {s})")
    return _build.ptr(key_bias)


def _bias_ptr(bias, b: int, sq: int, sk: int, device) -> tuple[ctypes.c_void_p | None, int]:
    """-> (pointer or None, full_bias): a key mask [B, Sk] (0) or a full [B, Sq, Sk] bias (1)."""
    if bias is None or bias.dim() == 2:
        return _key_bias_ptr(bias, "bias", b, sk, device), 0
    _check_operand(bias, "bias", torch.float32, device)
    _require(tuple(bias.shape) == (b, sq, sk), f"bias shape {tuple(bias.shape)} != ({b}, {sk}) or ({b}, {sq}, {sk})")
    return _build.ptr(bias), 1


def attn_core(qkv, bias, b: int, s: int, num_heads: int) -> torch.Tensor:
    """qkv [B*S, 3H] bf16, bias f32 [B, S] (key mask), [B, S, S] (full) or None
    -> ctx [B*S, H] bf16."""
    if not qkv.is_cuda:
        return attn_core_plain(qkv, bias, b, s, num_heads)
    h = qkv.shape[1] // 3
    _attn_checks(h, num_heads, b, (s,))
    _rows(qkv, "qkv", (b * s, 3 * h))
    bias_p, full = _bias_ptr(bias, b, s, s, qkv.device)
    ctx = torch.empty(b * s, h, dtype=torch.bfloat16, device=qkv.device)
    fn = _build.bind("attn_core", "kmr_attn_core",
                     [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(_build.ptr(qkv), bias_p, full, _build.ptr(ctx), b, s, h, num_heads, _build.stream_of(qkv))
    _build.check(rc, "attn_core")
    attn_core.launches += 1
    return ctx


attn_core.launches = 0


def attn_core_cross(q, kv, bias, b: int, sq: int, sk: int, num_heads: int) -> torch.Tensor:
    """q [B*Sq, H] bf16, kv [B*Sk, 2H] bf16, bias f32 [B, Sk] (key mask),
    [B, Sq, Sk] (full) or None -> ctx [B*Sq, H] bf16."""
    if not q.is_cuda:
        return attn_core_cross_plain(q, kv, bias, b, sq, sk, num_heads)
    h = q.shape[1]
    _attn_checks(h, num_heads, b, (sq, sk))
    _rows(q, "q", (b * sq, h))
    _rows(kv, "kv", (b * sk, 2 * h))
    bias_p, full = _bias_ptr(bias, b, sq, sk, q.device)
    ctx = torch.empty(b * sq, h, dtype=torch.bfloat16, device=q.device)
    fn = _build.bind("attn_core", "kmr_attn_cross",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    # k at column 0 and v at column H of the [B*Sk, 2H] buffer, both at row stride 2H
    rc = fn(_build.ptr(q), _build.ptr(kv), _build.ptr(kv, h), bias_p, full, _build.ptr(ctx),
            h, 2 * h, b, sq, sk, h, num_heads, _build.stream_of(q))
    _build.check(rc, "attn_core")
    attn_core_cross.launches += 1
    return ctx


attn_core_cross.launches = 0


def attn_core_dual(lqkv, vqkv, lang_bias, visn_bias, b: int, f: int, t: int,
                   num_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """lqkv [B*F, 3H] and vqkv [B*T, 3H] bf16, lang_bias [B, F] and visn_bias
    [B, T] f32 (both or neither) -> (ctx_l [B*F, H], ctx_v [B*T, H]) bf16,
    both directions in one launch."""
    _require((lang_bias is None) == (visn_bias is None), "attn_core_dual takes both key masks or neither")
    if not lqkv.is_cuda:
        return attn_core_dual_plain(lqkv, vqkv, lang_bias, visn_bias, b, f, t, num_heads)
    h = lqkv.shape[1] // 3
    _attn_checks(h, num_heads, b, (f, t))
    _rows(lqkv, "lqkv", (b * f, 3 * h))
    _rows(vqkv, "vqkv", (b * t, 3 * h))
    _require(vqkv.device == lqkv.device, "lqkv and vqkv must be on one device")
    lbias = _key_bias_ptr(lang_bias, "lang_bias", b, f, lqkv.device)
    vbias = _key_bias_ptr(visn_bias, "visn_bias", b, t, lqkv.device)
    ctx_l = torch.empty(b * f, h, dtype=torch.bfloat16, device=lqkv.device)
    ctx_v = torch.empty(b * t, h, dtype=torch.bfloat16, device=lqkv.device)
    fn = _build.bind("attn_core", "kmr_attn_dual", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    rc = fn(_build.ptr(lqkv), _build.ptr(vqkv), lbias, vbias, _build.ptr(ctx_l), _build.ptr(ctx_v),
            b, f, t, h, num_heads, _build.stream_of(lqkv))
    _build.check(rc, "attn_core")
    attn_core_dual.launches += 1
    return ctx_l, ctx_v


attn_core_dual.launches = 0


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


# ---------------------------------------------------------------------------
# layer_tail: out-projection + LN1 + FFN + LN2 of one encoder layer
# ---------------------------------------------------------------------------


def layer_tail_plain(ctx, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
                     approximate_gelu: bool = True, eps: float = 1e-12) -> torch.Tensor:
    """ctx, x [M, H] -> bf16-rounded LN2(h @ W2 + b2 + a) in x's dtype, where
    a = LN1(ctx @ Wo + bo + x) and h = gelu(a @ W1 + b1), both rounded to
    x's dtype (``ops/pallas_layer.py`` :84-115 of the JAX package)."""
    dt = x.dtype
    y = torch.matmul(ctx.float(), wo.to(dt).float()) + bo.float() + x.float()
    a = layernorm_plain(y, g1, be1, eps, out_dtype=dt)
    act = gelu_tanh if approximate_gelu else gelu_erf
    hmid = act(torch.matmul(a.float(), w1.to(dt).float()) + b1.float()).to(dt)
    z = torch.matmul(hmid.float(), w2.to(dt).float()) + b2.float() + a.float()
    return layernorm_plain(z, g2, be2, eps, out_dtype=dt)


def layer_tail(ctx, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2,
               approximate_gelu: bool = True, eps: float = 1e-12) -> torch.Tensor:
    """ctx, x [M, 768] bf16; wo [768, 768], w1 [768, I], w2 [I, 768] bf16;
    biases, gammas, betas f32 -> [M, 768] bf16. I % 64 == 0."""
    if not x.is_cuda:
        return layer_tail_plain(ctx, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, approximate_gelu, eps)
    lib = _build.load("layer_tail")
    m, h = x.shape
    i = w1.shape[1]
    hidden, chunk = lib.kmr_layer_tail_hidden(), lib.kmr_layer_tail_chunk()
    _require(h == hidden, f"layer_tail takes H = {hidden}, got {h}")
    _require(i > 0 and i % chunk == 0, f"layer_tail takes I % {chunk} == 0, got I={i}")
    _require(m > 0, "empty layer_tail")
    shapes = {"ctx": (m, h), "x": (m, h), "wo": (h, h), "bo": (h,), "g1": (h,), "be1": (h,),
              "w1": (h, i), "b1": (i,), "w2": (i, h), "b2": (h,), "g2": (h,), "be2": (h,)}
    args = dict(zip(shapes, (ctx, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)))
    for name, t in args.items():
        dt = torch.bfloat16 if name in ("ctx", "x", "wo", "w1", "w2") else torch.float32
        _check_operand(t, name, dt, x.device)
        _require(tuple(t.shape) == shapes[name], f"{name} shape {tuple(t.shape)} != {shapes[name]}")
    out = torch.empty(m, h, dtype=torch.bfloat16, device=x.device)
    fn = _build.bind("layer_tail", "kmr_layer_tail",
                     [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(*(_build.ptr(t) for t in args.values()), _build.ptr(out), m, i, int(not approximate_gelu), eps,
            _build.stream_of(x))
    _build.check(rc, "layer_tail")
    layer_tail.launches += 1
    return out


layer_tail.launches = 0


# ---------------------------------------------------------------------------
# mha, mha_packed: bare attention, bf16 or f32
# ---------------------------------------------------------------------------

MHA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mha_plain(q, k, v, bias=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + bias) v on [B, N, S, Dh]: f32 scores and
    softmax, probs rounded to v's dtype, f32 PV, out in q's dtype (the
    Pallas body, ``ops/pallas_attention.py`` :26-46 of the JAX package)."""
    return mha_xla(q, k, v, bias).to(q.dtype)


def mha_packed_plain(q, k, v, num_heads: int, bias=None) -> torch.Tensor:
    """The same on [B, S, H], head n in columns n*Dh..(n+1)*Dh."""
    heads = [split_heads(t, num_heads) for t in (q, k, v)]
    return merge_heads(mha_plain(*heads, bias))


def same_length(name: str, q, k, v) -> None:
    """The JAX kernels read k and v at q's shape (``mha_pallas`` reshapes k to
    q's length, :58-62), so cross attention, where they differ, fails there;
    here it raises, on every device."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name} takes q, k and v of one shape (self-attention only), got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")


def _mha_operands(lib, name: str, q, k, v, s: int, dh: int) -> None:
    _require(dh == lib.kmr_mha_head_dim(), f"{name} takes head dim {lib.kmr_mha_head_dim()}, got q "
             f"{tuple(q.shape)}")
    _require(1 <= s <= lib.kmr_mha_max_seq(), f"{name} takes S <= {lib.kmr_mha_max_seq()}, got q {tuple(q.shape)}")
    _require(q.dtype in MHA_DTYPES, f"{name} takes bf16 or f32, got {q.dtype}")
    vec = 16 // q.element_size()  # elements in one 16-byte load
    for t, tn in ((q, "q"), (k, "k"), (v, "v")):
        _require(t.device == q.device, f"{tn} is on {t.device}, expected {q.device}")
        _require(t.dtype == q.dtype, f"{tn} has dtype {t.dtype}, q has {q.dtype}")
        _require(t.stride(-1) == 1 and all(st % vec == 0 for st in t.stride()[:-1]) and t.data_ptr() % 16 == 0,
                 f"{tn} needs a contiguous last axis, 16-byte aligned rows and strides a multiple of {vec}, "
                 f"got strides {t.stride()}")


def _mha_bias(bias, shape: tuple, device) -> tuple:
    """(pointer, element strides over ``shape``'s 4 axes) of an f32 bias
    broadcast to ``shape`` (stride 0 on broadcast axes), or (None, zeros)."""
    if bias is None:
        return None, (0, 0, 0, 0)
    _require(bias.device == device, f"bias is on {bias.device}, expected {device}")
    _require(bias.dtype == torch.float32, f"bias has dtype {bias.dtype}, the kernel takes torch.float32")
    try:
        view = bias.expand(*shape)
    except RuntimeError as e:
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to {shape}") from e
    return _build.ptr(view), view.stride()


def mha(q, k, v, bias=None) -> torch.Tensor:
    """q, k, v [B, N, S, 64] bf16 or f32 (any strides, last axis contiguous);
    bias f32 broadcastable to [B, N, S, S] or None -> [B, N, S, 64] in q's dtype."""
    same_length("mha", q, k, v)
    if not q.is_cuda:
        return mha_plain(q, k, v, bias)
    b, n, s, dh = q.shape
    lib = _build.load("mha")
    _mha_operands(lib, "mha", q, k, v, s, dh)
    bias_ptr, bs = _mha_bias(bias, (b, n, s, s), q.device)
    out = torch.empty(b, n, s, dh, dtype=q.dtype, device=q.device)
    fn = _build.bind("mha", "kmr_mha", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 13
                     + [ctypes.c_void_p])
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), bias_ptr, _build.ptr(out), b, n, s, MHA_DTYPES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *bs, _build.stream_of(q))
    _build.check(rc, "mha")
    mha.launches += 1
    return out


mha.launches = 0


def mha_packed(q, k, v, num_heads: int, bias=None) -> torch.Tensor:
    """q, k, v [B, S, H] bf16 or f32, H = num_heads * 64, head n in columns
    n*64..; bias f32 broadcastable to [B, 1, S, S] (a [B, 1, 1, S] key mask or
    a [B, 1, S, S] bias, shared by the heads) or None -> [B, S, H] in q's dtype."""
    same_length("mha_packed", q, k, v)
    if not q.is_cuda:
        return mha_packed_plain(q, k, v, num_heads, bias)
    b, s, h = q.shape
    lib = _build.load("mha")
    _require(h % num_heads == 0, f"mha_packed: H={h} is not a multiple of {num_heads} heads")
    _mha_operands(lib, "mha_packed", q, k, v, s, h // num_heads)
    bias_ptr, bs = _mha_bias(bias, (b, 1, s, s), q.device)
    out = torch.empty(b, s, h, dtype=q.dtype, device=q.device)
    fn = _build.bind("mha", "kmr_mha_packed", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                     + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), bias_ptr, _build.ptr(out), b, s, h, num_heads,
            MHA_DTYPES[q.dtype], *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], bs[0], bs[2], bs[3],
            _build.stream_of(q))
    _build.check(rc, "mha")
    mha_packed.launches += 1
    return out


mha_packed.launches = 0

# ---------------------------------------------------------------------------
# ln_train: the train blocks' hidden dropout + residual + LayerNorm, fwd and bwd
# ---------------------------------------------------------------------------

LN_TRAIN_BWD_ROWS = 64  # rows of one dgamma/dbeta partial (csrc/ln_train.cu's BWD_ROWS)


def _drop_args(rate: float) -> tuple[int, float, int]:
    """(cutoff, scale, on) of a dropout rate, as the kernels take them."""
    return dropout_cutoff(rate), keep_scale(rate), int(rate > 0.0)


def _seed32(seed: int) -> int:
    """A seed's low 32 bits as the C int the kernels take (they read its bits as uint32)."""
    v = int(seed) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _hidden_dropped(h, seed: int, rate: float, rows_per_block: int):
    """(keep ? h * scale : 0 in f32, keep) or (h in f32, None) at rate 0."""
    h = h.float()
    if rate <= 0.0:
        return h, None
    keep = hidden_keep(seed, rate, h.shape[0], h.shape[1], rows_per_block, h.device)
    return torch.where(keep, h * keep_scale(rate), 0.0), keep


def _row_parts(t: torch.Tensor) -> torch.Tensor:
    """[M, H] -> [ceil(M / 64), H] sums of each 64 rows (the kernel's partials)."""
    m, h = t.shape
    pad = -m % LN_TRAIN_BWD_ROWS
    return torch.cat([t, t.new_zeros(pad, h)]).reshape(-1, LN_TRAIN_BWD_ROWS, h).sum(1)


def ln_train_plain(h, x, gamma, beta, seed: int, rate: float, rows_per_block: int,
                   eps: float = 1e-12) -> torch.Tensor:
    """h [M, H] f32, x [M, H] -> LN(drop(h) + x) in x's dtype, drop() the hidden
    draw of each grid block of rows_per_block rows (the JAX package's
    ``ops/pallas_train.py`` :189-197, :626-634)."""
    hd, _ = _hidden_dropped(h, seed, rate, rows_per_block)
    return layernorm_plain(hd + x.float(), gamma, beta, eps, out_dtype=x.dtype)


def ln_train_bwd_plain(h, x, dy, gamma, seed: int, rate: float, rows_per_block: int, eps: float = 1e-12):
    """-> (dz [M, H] f32, dh [M, H] in x's dtype, dgamma and dbeta partials
    [ceil(M / 64), H] f32): the LayerNorm backward through z = drop(h) + x,
    dh = keep ? dz * scale : 0 (:223-238, :780-795)."""
    hd, keep = _hidden_dropped(h, seed, rate, rows_per_block)
    z = hd + x.float()
    mean = z.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((z - mean).square().mean(dim=-1, keepdim=True) + eps)
    zn = (z - mean) * inv
    dyf = dy.float()
    g = dyf * gamma.float()
    dz = (g - g.mean(dim=-1, keepdim=True) - zn * (g * zn).mean(dim=-1, keepdim=True)) * inv
    dh = dz.clone() if keep is None else torch.where(keep, dz * keep_scale(rate), 0.0)
    return dz, dh.to(x.dtype), _row_parts(dyf * zn), _row_parts(dyf)


def _ln_train_checks(lib, h, x, gamma, m: int, hid: int, rows_per_block: int) -> None:
    _require(hid % 128 == 0 and hid <= lib.kmr_ln_train_max_hidden(),
             f"ln_train takes H % 128 == 0 and H <= {lib.kmr_ln_train_max_hidden()}, got {hid}")
    _require(m > 0 and rows_per_block > 0 and m % rows_per_block == 0,
             f"ln_train takes M a multiple of rows_per_block, got M={m}, rows_per_block={rows_per_block}")
    _check_operand(h, "h", torch.float32, h.device)
    _check_operand(x, "x", torch.bfloat16, h.device)
    _require(tuple(x.shape) == (m, hid), f"x shape {tuple(x.shape)} != {(m, hid)}")
    _check_operand(gamma, "gamma", torch.float32, h.device)
    _require(tuple(gamma.shape) == (hid,), "gamma must be [H]")


def ln_train(h, x, gamma, beta, seed: int, rate: float, rows_per_block: int, eps: float = 1e-12) -> torch.Tensor:
    """h [M, H] f32, x [M, H] bf16, gamma/beta [H] f32 -> y [M, H] bf16."""
    if not h.is_cuda:
        return ln_train_plain(h, x, gamma, beta, seed, rate, rows_per_block, eps)
    lib = _build.load("ln_train")
    m, hid = h.shape
    _ln_train_checks(lib, h, x, gamma, m, hid, rows_per_block)
    _check_operand(beta, "beta", torch.float32, h.device)
    _require(tuple(beta.shape) == (hid,), "beta must be [H]")
    y = torch.empty(m, hid, dtype=torch.bfloat16, device=h.device)
    fn = _build.bind("ln_train", "kmr_ln_train_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float]
                     + [ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(_build.ptr(h), _build.ptr(x), _build.ptr(gamma), _build.ptr(beta), _build.ptr(y), m, hid, eps,
            _seed32(seed), *_drop_args(rate), rows_per_block, _build.stream_of(h))
    _build.check(rc, "ln_train")
    ln_train.launches += 1
    return y


ln_train.launches = 0


def ln_train_bwd(h, x, dy, gamma, seed: int, rate: float, rows_per_block: int, eps: float = 1e-12):
    """h [M, H] f32, x and dy [M, H] bf16, gamma [H] f32 -> (dz [M, H] f32, dh
    [M, H] bf16, dgamma and dbeta partials [ceil(M / 64), H] f32)."""
    if not h.is_cuda:
        return ln_train_bwd_plain(h, x, dy, gamma, seed, rate, rows_per_block, eps)
    lib = _build.load("ln_train")
    m, hid = h.shape
    _ln_train_checks(lib, h, x, gamma, m, hid, rows_per_block)
    _check_operand(dy, "dy", torch.bfloat16, h.device)
    _require(tuple(dy.shape) == (m, hid), f"dy shape {tuple(dy.shape)} != {(m, hid)}")
    _require(lib.kmr_ln_train_bwd_rows() == LN_TRAIN_BWD_ROWS, "ln_train.cu's partial rows changed")
    parts = -(-m // LN_TRAIN_BWD_ROWS)
    dz = torch.empty(m, hid, dtype=torch.float32, device=h.device)
    dh = torch.empty(m, hid, dtype=torch.bfloat16, device=h.device)
    pg = torch.empty(parts, hid, dtype=torch.float32, device=h.device)
    pb = torch.empty(parts, hid, dtype=torch.float32, device=h.device)
    fn = _build.bind("ln_train", "kmr_ln_train_bwd", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float]
                     + [ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(_build.ptr(h), _build.ptr(x), _build.ptr(dy), _build.ptr(gamma), _build.ptr(dz), _build.ptr(dh),
            _build.ptr(pg), _build.ptr(pb), m, hid, eps, _seed32(seed), *_drop_args(rate), rows_per_block,
            _build.stream_of(h))
    _build.check(rc, "ln_train")
    ln_train_bwd.launches += 1
    return dz, dh, pg, pb


ln_train_bwd.launches = 0


# ---------------------------------------------------------------------------
# attn_train: the train block's per-head attention with probability dropout
# ---------------------------------------------------------------------------


def _train_probs(q, k, key_bias, seed: int, rate: float, block: int):
    """q [B, N, F, Dh], k [B, N, T, Dh] -> (probs f32, keep or None,
    bf16(dropped probs) in q's dtype), as ``_attn_recompute_heads`` and
    ``_cross_recompute_heads`` (:548-576, :1041-1067)."""
    b, n, f, dh = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / dh**0.5)
    if key_bias is not None:
        scores = scores + key_bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if rate <= 0.0:
        return probs, None, probs.to(q.dtype)
    keep = cross_probs_keep(seed, rate, b, n, f, k.shape[2], block, q.device)
    return probs, keep, torch.where(keep, probs * keep_scale(rate), 0.0).to(q.dtype)


def _cross_heads(q, kv, b: int, f: int, t: int, num_heads: int):
    h = q.shape[1]
    return [split_heads(x.reshape(b, s, h), num_heads) for x, s in ((q, f), (kv[:, :h], t), (kv[:, h:], t))]


def attn_train_cross_plain(q, kv, key_bias, b: int, f: int, t: int, num_heads: int, seed: int, rate: float,
                           block: int) -> torch.Tensor:
    """q [B*F, H], kv [B*T, 2H] (keys then values) -> ctx [B*F, H] in q's
    dtype: bf16(bf16(dropped probs) @ V) per head (:607-622, :1101-1115)."""
    qh, k, v = _cross_heads(q, kv, b, f, t, num_heads)
    _, _, pd = _train_probs(qh, k, key_bias, seed, rate, block)
    ctx = torch.matmul(pd.float(), v.float()).to(q.dtype)
    return merge_heads(ctx).reshape(b * f, -1)


def attn_train_cross_bwd_plain(q, kv, dctx, key_bias, b: int, f: int, t: int, num_heads: int, seed: int,
                               rate: float, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B*F, H], kv [B*T, 2H], dctx [B*F, H] -> (dq [B*F, H], dkv [B*T, 2H])
    in q's dtype (:811-849, :1213-1247)."""
    dt = q.dtype
    qh, k, v = _cross_heads(q, kv, b, f, t, num_heads)
    probs, keep, pd = _train_probs(qh, k, key_bias, seed, rate, block)
    dc = split_heads(dctx.reshape(b, f, -1), num_heads).float()
    dv = torch.matmul(pd.float().transpose(-1, -2), dc).to(dt)
    dprobs = torch.matmul(dc, v.float().transpose(-1, -2))
    if keep is not None:
        dprobs = torch.where(keep, dprobs * keep_scale(rate), 0.0)
    ds = (probs * (dprobs - (dprobs * probs).sum(dim=-1, keepdim=True)) * (1.0 / qh.shape[-1]**0.5)).to(dt)
    dq = torch.matmul(ds.float(), k.float()).to(dt)
    dk = torch.matmul(ds.float().transpose(-1, -2), qh.float()).to(dt)
    dkv = torch.cat([merge_heads(dk), merge_heads(dv)], dim=-1).reshape(b * t, -1)
    return merge_heads(dq).reshape(b * f, -1), dkv


def attn_train_plain(qkv, key_bias, b: int, s: int, num_heads: int, seed: int, rate: float,
                     block: int) -> torch.Tensor:
    """qkv [B*S, 3H] -> ctx [B*S, H] in qkv's dtype: the cross case with F = T = S."""
    h = qkv.shape[1] // 3
    return attn_train_cross_plain(qkv[:, :h], qkv[:, h:], key_bias, b, s, s, num_heads, seed, rate, block)


def attn_train_bwd_plain(qkv, dctx, key_bias, b: int, s: int, num_heads: int, seed: int, rate: float,
                         block: int) -> torch.Tensor:
    """qkv [B*S, 3H], dctx [B*S, H] -> dqkv [B*S, 3H] in qkv's dtype."""
    h = qkv.shape[1] // 3
    dq, dkv = attn_train_cross_bwd_plain(qkv[:, :h], qkv[:, h:], dctx, key_bias, b, s, s, num_heads, seed, rate,
                                         block)
    return torch.cat([dq, dkv], dim=-1)


def _attn_train_checks(lib, h: int, num_heads: int, b: int, block: int, lengths) -> None:
    _require(h == num_heads * lib.kmr_attn_train_head_dim(),
             f"attn_train takes head dim {lib.kmr_attn_train_head_dim()}, got {h // num_heads}")
    for s in lengths:
        _require(1 <= s <= lib.kmr_attn_train_max_seq(),
                 f"attn_train takes S <= {lib.kmr_attn_train_max_seq()}, got {s}")
    _require(1 <= b <= 65535 and block >= 1 and b % block == 0,
             f"attn_train takes 1..65535 pairs in whole blocks, got B={b}, block={block}")


def _attn_train_call(q, kv, dctx, key_bias, b: int, f: int, t: int, num_heads: int, seed: int, rate: float,
                     block: int) -> list[torch.Tensor]:
    """One launch of attn_train.cu's forward (``dctx`` None) or backward. Self-attention passes the
    [B*S, 3H] QKV buffer as ``q`` and ``kv`` None (f = t = S) and gets [ctx] or [dqkv]; cross attention
    passes q [B*F, H] and kv [B*T, 2H] and gets [ctx] or [dq, dkv]."""
    lib = _build.load("attn_train")
    packed = kv is None
    h = q.shape[1] // 3 if packed else q.shape[1]
    _attn_train_checks(lib, h, num_heads, b, block, (f, t))
    if packed:
        _rows(q, "qkv", (b * f, 3 * h))
        src, k_col, ldq, ldkv = q, h, 3 * h, 3 * h
    else:
        _rows(q, "q", (b * f, h))
        _rows(kv, "kv", (b * t, 2 * h))
        _require(kv.device == q.device, "q and kv must be on one device")
        src, k_col, ldq, ldkv = kv, 0, h, 2 * h
    ptrs = [_build.ptr(q), _build.ptr(src, k_col), _build.ptr(src, k_col + h),
            _key_bias_ptr(key_bias, "key_bias", b, t, q.device)]
    new = functools.partial(torch.empty, dtype=torch.bfloat16, device=q.device)
    if dctx is None:
        outs = [new(b * f, h)]
        ptrs.append(_build.ptr(outs[0]))
        lds, symbol = (ldq, ldkv, h), "kmr_attn_train_fwd"
    else:
        _rows(dctx, "dctx", (b * f, h))
        if packed:
            outs = [new(b * f, 3 * h)]
            dq, dkv, lds = outs[0], outs[0], (ldq, ldkv, 3 * h, 3 * h)
        else:
            outs = [new(b * f, h), new(b * t, 2 * h)]
            (dq, dkv), lds = outs, (ldq, ldkv, h, 2 * h)
        ptrs += [_build.ptr(dctx), _build.ptr(dq), _build.ptr(dkv, k_col), _build.ptr(dkv, k_col + h)]
        symbol = "kmr_attn_train_bwd"
    # pointers; B, Sq, Sk, H, num_heads, the row strides, block, seed; cutoff, scale, on, stream
    argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * (7 + len(lds))
                + [ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn = _build.bind("attn_train", symbol, argtypes)
    rc = fn(*ptrs, b, f, t, h, num_heads, *lds, block, _seed32(seed), *_drop_args(rate), _build.stream_of(q))
    _build.check(rc, "attn_train")
    return outs


def attn_train(qkv, key_bias, b: int, s: int, num_heads: int, seed: int, rate: float, block: int) -> torch.Tensor:
    """qkv [B*S, 3H] bf16, key_bias [B, S] f32 or None -> ctx [B*S, H] bf16;
    dropout masks drawn per grid block of ``block`` pairs."""
    if not qkv.is_cuda:
        return attn_train_plain(qkv, key_bias, b, s, num_heads, seed, rate, block)
    (out,) = _attn_train_call(qkv, None, None, key_bias, b, s, s, num_heads, seed, rate, block)
    attn_train.launches += 1
    return out


attn_train.launches = 0


def attn_train_bwd(qkv, dctx, key_bias, b: int, s: int, num_heads: int, seed: int, rate: float,
                   block: int) -> torch.Tensor:
    """qkv [B*S, 3H] bf16, dctx [B*S, H] bf16 -> dqkv [B*S, 3H] bf16."""
    if not qkv.is_cuda:
        return attn_train_bwd_plain(qkv, dctx, key_bias, b, s, num_heads, seed, rate, block)
    (out,) = _attn_train_call(qkv, None, dctx, key_bias, b, s, s, num_heads, seed, rate, block)
    attn_train_bwd.launches += 1
    return out


attn_train_bwd.launches = 0


def attn_train_cross(q, kv, key_bias, b: int, f: int, t: int, num_heads: int, seed: int, rate: float,
                     block: int) -> torch.Tensor:
    """q [B*F, H] bf16, kv [B*T, 2H] bf16 (keys then values), key_bias [B, T]
    f32 or None -> ctx [B*F, H] bf16; masks drawn per grid block of ``block``
    pairs over [block, F, T]."""
    if not q.is_cuda:
        return attn_train_cross_plain(q, kv, key_bias, b, f, t, num_heads, seed, rate, block)
    (out,) = _attn_train_call(q, kv, None, key_bias, b, f, t, num_heads, seed, rate, block)
    attn_train_cross.launches += 1
    return out


attn_train_cross.launches = 0


def attn_train_cross_bwd(q, kv, dctx, key_bias, b: int, f: int, t: int, num_heads: int, seed: int, rate: float,
                         block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B*F, H], kv [B*T, 2H], dctx [B*F, H] bf16 -> (dq [B*F, H], dkv
    [B*T, 2H]) bf16, dk and dv at kv's columns."""
    if not q.is_cuda:
        return attn_train_cross_bwd_plain(q, kv, dctx, key_bias, b, f, t, num_heads, seed, rate, block)
    dq, dkv = _attn_train_call(q, kv, dctx, key_bias, b, f, t, num_heads, seed, rate, block)
    attn_train_cross_bwd.launches += 1
    return dq, dkv


attn_train_cross_bwd.launches = 0

WRAPPERS = (gemm, attn_core, attn_core_cross, attn_core_dual, layernorm, layer_tail, mha, mha_packed,
            ln_train, ln_train_bwd, attn_train, attn_train_bwd, attn_train_cross, attn_train_cross_bwd)
