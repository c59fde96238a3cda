"""Wrappers over the hand-written CUDA kernels of ``csrc/``, each with its
plain PyTorch version and a launch counter.

The fused blocks (``attention_block.py``, ``ffn_block.py``,
``cross_attention_block.py``, ``dual_cross_attention_block.py``,
``encoder_layer.py``) are built from these four kernels:

* ``gemm``       ``csrc/gemm_bf16.cu``: bf16 ``A @ W + b`` with a fused
                 epilogue (bf16 out, GELU then bf16, + residual in f32, or
                 f32 out: ImageBERT-B's banded label conv).
* ``attn_core``  ``csrc/attn_core.cu``: per-head softmax(QK^T/8 + key bias)V
                 read from the fused [B*S, 3H] QKV buffer; its two other entry
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
from .attention import merge_heads, mha_xla, split_heads

EPILOGUES = {"bias": 0, "gelu_tanh": 1, "gelu_erf": 2, "residual": 3, "f32": 4}
F32_OUT = ("residual", "f32")  # the epilogues that write f32


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
    "residual" adds residual and "f32" adds nothing, both staying f32; the
    others end in a's dtype."""
    y = torch.matmul(a.float(), w.to(a.dtype).float()) + bias.float()
    if epilogue == "residual":
        return y + residual.float()
    if epilogue == "f32":
        return y
    if epilogue == "gelu_tanh":
        y = gelu_tanh(y)
    elif epilogue == "gelu_erf":
        y = gelu_erf(y)
    return y.to(a.dtype)


def gemm(a, w, bias, epilogue: str = "bias", residual=None) -> torch.Tensor:
    """a [M, K] bf16, w [K, N] bf16, bias [N] f32 (+ residual [M, N] bf16)
    -> [M, N] bf16, or f32 for the "residual" and "f32" epilogues."""
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
    out = torch.empty(m, n, dtype=torch.float32 if epilogue in F32_OUT else torch.bfloat16,
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
# attn_core: per-head attention; self, cross and dual-cross entry points
# ---------------------------------------------------------------------------


def attn_core_cross_plain(q, kv, key_bias, b: int, sq: int, sk: int, num_heads: int) -> torch.Tensor:
    """q [B*Sq, H], kv [B*Sk, 2H] (keys then values) -> ctx [B*Sq, H] in q's
    dtype; key_bias [B, Sk] or None."""
    h = q.shape[1]
    qh = split_heads(q.reshape(b, sq, h), num_heads)
    k, v = (split_heads(t.reshape(b, sk, h), num_heads) for t in kv.split(h, dim=1))
    bias = None if key_bias is None else key_bias.reshape(b, 1, 1, sk)
    return merge_heads(mha_xla(qh, k, v, bias)).reshape(b * sq, h)


def attn_core_plain(qkv, key_bias, b: int, s: int, num_heads: int) -> torch.Tensor:
    """qkv [B*S, 3H] -> ctx [B*S, H] in qkv's dtype; key_bias [B, S] or None."""
    h = qkv.shape[1] // 3
    return attn_core_cross_plain(qkv[:, :h], qkv[:, h:], key_bias, b, s, s, num_heads)


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


def attn_core(qkv, key_bias, b: int, s: int, num_heads: int) -> torch.Tensor:
    """qkv [B*S, 3H] bf16, key_bias [B, S] f32 or None -> ctx [B*S, H] bf16."""
    if not qkv.is_cuda:
        return attn_core_plain(qkv, key_bias, b, s, num_heads)
    h = qkv.shape[1] // 3
    _attn_checks(h, num_heads, b, (s,))
    _rows(qkv, "qkv", (b * s, 3 * h))
    bias = _key_bias_ptr(key_bias, "key_bias", b, s, qkv.device)
    ctx = torch.empty(b * s, h, dtype=torch.bfloat16, device=qkv.device)
    fn = _build.bind("attn_core", "kmr_attn_core", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(_build.ptr(qkv), bias, _build.ptr(ctx), b, s, h, num_heads, _build.stream_of(qkv))
    _build.check(rc, "attn_core")
    attn_core.launches += 1
    return ctx


attn_core.launches = 0


def attn_core_cross(q, kv, key_bias, b: int, sq: int, sk: int, num_heads: int) -> torch.Tensor:
    """q [B*Sq, H] bf16, kv [B*Sk, 2H] bf16, key_bias [B, Sk] f32 or None
    -> ctx [B*Sq, H] bf16."""
    if not q.is_cuda:
        return attn_core_cross_plain(q, kv, key_bias, b, sq, sk, num_heads)
    h = q.shape[1]
    _attn_checks(h, num_heads, b, (sq, sk))
    _rows(q, "q", (b * sq, h))
    _rows(kv, "kv", (b * sk, 2 * h))
    bias = _key_bias_ptr(key_bias, "key_bias", b, sk, q.device)
    ctx = torch.empty(b * sq, h, dtype=torch.bfloat16, device=q.device)
    fn = _build.bind("attn_core", "kmr_attn_cross",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    # k at column 0 and v at column H of the [B*Sk, 2H] buffer, both at row stride 2H
    rc = fn(_build.ptr(q), _build.ptr(kv), _build.ptr(kv, h), bias, _build.ptr(ctx),
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
    biases, gammas, betas f32 -> [M, 768] bf16. I % 256 == 0."""
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

WRAPPERS = (gemm, attn_core, attn_core_cross, attn_core_dual, layernorm, layer_tail, mha, mha_packed)
