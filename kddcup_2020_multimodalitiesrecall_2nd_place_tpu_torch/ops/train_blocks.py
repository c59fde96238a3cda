"""The training blocks: the port of ``ffn_block_train``,
``attention_block_train`` and ``cross_attention_block_train`` (JAX package
``ops/pallas_train.py:429``, ``:965``, ``:1383``).

    FFN        y = LN(x + drop(gelu(x @ W1 + b1) @ W2 + b2))
    attention  y = LN(x + drop(concat_h drop_p(softmax(Q_h K_h^T / sqrt(Dh) + bias)) V_h @ Wo + bo))
    cross      the same with Q from x [B, F, H] and K, V from ctx [B, T, H]
               (one [H, 2H] product); the bias masks ctx's keys

Each is a ``torch.autograd.Function`` over the hand-written kernels of
``kernels.py`` (through the ``kmr::`` ops of ``library.py``), with dropout
masks from the JAX package's counter hash (``dropout.py``), so at any rate
they keep the units the JAX package's interpret-mode kernels keep.

* Forward (``_ffn_train_fwd`` :297, ``_attn_train_fwd`` :864,
  ``_cross_train_fwd`` :1264): FFN = ``gemm`` (GELU) + ``gemm`` ("f32") +
  ``ln_train``; attention = ``gemm`` (QKV) + ``attn_train`` + ``gemm``
  ("f32") + ``ln_train``; cross = ``gemm`` (Q) + ``gemm`` (KV) +
  ``attn_train_cross`` + ``gemm`` ("f32") + ``ln_train``. The forward saves
  only x (and ctx), the f32 weights, the seed and the key mask, as the
  Pallas kernels do: a layer's residuals are its [B, S, H] block inputs.
* Backward (``_ffn_train_bwd`` :323, ``_attn_train_bwd`` :897): the forward
  recomputed from x, then ``ln_train_bwd`` (dz, the dropped dh, dgamma/dbeta
  partials) and products with the forward's weights in the GEMM's
  transposed-weight mode: FFN du = bf16(dh @ W2^T * gelu'(u)), dx = bf16(dz +
  du @ W1^T); attention dctx = bf16(do @ Wo^T), ``attn_train_bwd`` -> dqkv,
  dx = bf16(dz + dqkv @ Wqkv^T); cross (``_cross_train_bwd`` :1300) the same
  with ``attn_train_cross_bwd`` -> dq, dkv, dx = bf16(dz + dq @ Wq^T) and the
  gradient of ctx bf16(dkv @ Wkv^T), in x's dtype as JAX casts it (:1354-1357).
  The weight gradients are library products
  and sums over the B*S rows, as the JAX package leaves them to XLA
  (:363-374, :943-953: ``dot_general`` of the bf16 operands with f32
  accumulation and output): on the card one ``torch.mm`` with
  ``out_dtype=float32`` straight from the bf16 operands (``weight_grads``),
  with no f32 copies of them.

f32 weights come in, are cast to x's dtype inside and get f32 gradients; dx
is in x's dtype. On CPU tensors every kernel runs its plain version.

Beside each Function, ``*_plain``: the block's forward in plain torch with the
same hash masks. Its gradient comes from ``torch.autograd``, so it is an
oracle for the backward kernels that owes them nothing (the counterpart of
``ref_ffn``/``ref_attn`` in the JAX package's ``tests/test_pallas_train.py``).
The FFN block is bound by operations (6 * B*S*H*I forward FLOPs on the tensor
cores), and so is the attention block's projections; ``PERF.md`` has their
times against the bounds.
"""

from __future__ import annotations

import torch

from ..utils.observability import span
from .activations import gelu_erf, gelu_tanh
from .attention import merge_heads, split_heads
from .attention_block import key_bias_rows
from .dropout import cross_probs_keep, hidden_keep, keep_scale, shard_block
from .kernels import layernorm_plain
from .library import (
    attn_train,
    attn_train_bwd,
    attn_train_cross,
    attn_train_cross_bwd,
    gemm,
    gemm_gelu_save,
    ln_train,
    ln_train_bwd,
)


def weight_grads(a: torch.Tensor, d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a [M, K], d [M, N] -> (a^T d [K, N], sum of d over rows [N]), f32. bf16
    operands on the card: one cuBLAS product, bf16 in and f32 sums and out
    (``aten::mm.dtype``), and a sum accumulated in f32, with no f32 copies of
    the operands; other operands (f32, or on the CPU, where ``mm.dtype`` has
    no kernel): the plain f32 product."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a.T, d, out_dtype=torch.float32), d.sum(0, dtype=torch.float32)
    return torch.matmul(a.float().T, d.float()), d.float().sum(0)


# --------------------------------------------------------------------------
# FFN block
# --------------------------------------------------------------------------


def _ffn_forward(x, w1, b1, w2, b2, gamma, beta, seed, rate, approximate, eps, block):
    b, s, h = x.shape
    dt = x.dtype
    x2d = x.reshape(b * s, h)
    g = gemm(x2d, w1.to(dt), b1, "gelu_tanh" if approximate else "gelu_erf")
    hid = gemm(g, w2.to(dt), b2, "f32")
    return ln_train(hid, x2d, gamma, beta, seed, rate, block * s, eps).reshape(b, s, h)


def ffn_block_train_backward(dy, x, w1, b1, w2, b2, gamma, seed: int, rate: float, approximate: bool, eps: float,
                             block: int):
    """-> (dx, dw1, db1, dw2, db2, dgamma, dbeta): the forward recomputed from x."""
    b, s, h = x.shape
    dt = x.dtype
    x2d = x.reshape(b * s, h)
    w1c, w2c = w1.to(dt), w2.to(dt)
    g, u = gemm_gelu_save(x2d, w1c, b1, approximate)
    hid = gemm(g, w2c, b2, "f32")
    dz, dh, dgamma_p, dbeta_p = ln_train_bwd(hid, x2d, dy.to(dt).reshape(b * s, h).contiguous(), gamma, seed, rate,
                                             block * s, eps)
    du = gemm(dh, w2c, None, "gelu_bwd_tanh" if approximate else "gelu_bwd_erf", aux=u, trans_b=True)
    dx = gemm(du, w1c, None, "residual_f32", aux=dz, trans_b=True)
    dw1, db1 = weight_grads(x2d, du)
    dw2, db2 = weight_grads(g, dh)
    if x.is_cuda:
        ffn_block_train_backward.launches += 1
    return dx.reshape(b, s, h), dw1, db1, dw2, db2, dgamma_p.sum(0), dbeta_p.sum(0)


ffn_block_train_backward.launches = 0


class _FfnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, seed, rate, approximate, eps, block):
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma)
        ctx.cfg = (seed, rate, approximate, eps, block)
        return _ffn_forward(x, w1, b1, w2, b2, gamma, beta, seed, rate, approximate, eps, block)

    @staticmethod
    def backward(ctx, dy):
        with span("block.ffn_train_bwd"):  # on autograd's thread on the card
            grads = ffn_block_train_backward(dy, *ctx.saved_tensors, *ctx.cfg)
        return (*grads, None, None, None, None, None)


def ffn_block_train(x, w1, b1, w2, b2, gamma, beta, seed: int, dropout_rate: float = 0.0,
                    approximate_gelu: bool = True, eps: float = 1e-12, block_b: int | None = None) -> torch.Tensor:
    """x [B, S, H] (bf16 on CUDA), f32 weights [H, I], [I], [I, H], [H] and the
    LN's [H] -> [B, S, H] in x's dtype; hidden dropout at ``dropout_rate`` from
    ``seed`` (a 32-bit int), its masks drawn per grid block of ``block_b``
    pairs (resolved as the JAX package does, ``dropout.train_block``). Spans
    ``block.ffn_train`` and, around its backward, ``block.ffn_train_bwd``."""
    block, seed = shard_block("ffn", x.shape[0], block_b, seed)
    with span("block.ffn_train"):
        y = _FfnTrain.apply(x, w1, b1, w2, b2, gamma, beta, seed, float(dropout_rate), approximate_gelu, eps, block)
    if x.is_cuda:
        ffn_block_train.launches += 1
    return y


ffn_block_train.launches = 0


def ffn_block_train_plain(x, w1, b1, w2, b2, gamma, beta, seed: int, dropout_rate: float = 0.0,
                          approximate_gelu: bool = True, eps: float = 1e-12,
                          block_b: int | None = None) -> torch.Tensor:
    """The same block in plain differentiable torch, on any device, in x's dtype."""
    b, s, h = x.shape
    dt = x.dtype
    block, seed = shard_block("ffn", b, block_b, seed)
    x2d = x.reshape(b * s, h)
    act = gelu_tanh if approximate_gelu else gelu_erf
    g = act(torch.matmul(x2d.float(), w1.to(dt).float()) + b1.float()).to(dt)
    hid = torch.matmul(g.float(), w2.to(dt).float()) + b2.float()
    if dropout_rate > 0.0:
        keep = hidden_keep(seed, dropout_rate, b * s, h, block * s, x.device)
        hid = torch.where(keep, hid * keep_scale(dropout_rate), 0.0)
    return layernorm_plain(hid + x2d.float(), gamma, beta, eps, out_dtype=dt).reshape(b, s, h)


# --------------------------------------------------------------------------
# self-attention block
# --------------------------------------------------------------------------


def _attn_forward(x, wqkv, bqkv, wo, bo, gamma, beta, key_bias, num_heads, seed, arate, hrate, eps, block):
    b, s, h = x.shape
    dt = x.dtype
    x2d = x.reshape(b * s, h)
    qkv = gemm(x2d, wqkv.to(dt), bqkv, "bias")
    ctx = attn_train(qkv, key_bias, b, s, num_heads, seed, arate, block)
    o = gemm(ctx, wo.to(dt), bo, "f32")
    return ln_train(o, x2d, gamma, beta, seed, hrate, block * s, eps).reshape(b, s, h)


def attention_block_train_backward(dy, x, wqkv, bqkv, wo, bo, gamma, key_bias, num_heads: int, seed: int,
                                   arate: float, hrate: float, eps: float, block: int):
    """-> (dx, dwqkv, dbqkv, dwo, dbo, dgamma, dbeta): the forward recomputed from x."""
    b, s, h = x.shape
    dt = x.dtype
    x2d = x.reshape(b * s, h)
    wqkvc, woc = wqkv.to(dt), wo.to(dt)
    qkv = gemm(x2d, wqkvc, bqkv, "bias")
    ctx = attn_train(qkv, key_bias, b, s, num_heads, seed, arate, block)
    o = gemm(ctx, woc, bo, "f32")
    dz, do, dgamma_p, dbeta_p = ln_train_bwd(o, x2d, dy.to(dt).reshape(b * s, h).contiguous(), gamma, seed, hrate,
                                             block * s, eps)
    dctx = gemm(do, woc, None, "bias", trans_b=True)
    dqkv = attn_train_bwd(qkv, dctx, key_bias, b, s, num_heads, seed, arate, block)
    dx = gemm(dqkv, wqkvc, None, "residual_f32", aux=dz, trans_b=True)
    dwqkv, dbqkv = weight_grads(x2d, dqkv)
    dwo, dbo = weight_grads(ctx, do)
    if x.is_cuda:
        attention_block_train_backward.launches += 1
    return dx.reshape(b, s, h), dwqkv, dbqkv, dwo, dbo, dgamma_p.sum(0), dbeta_p.sum(0)


attention_block_train_backward.launches = 0


class _AttnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, gamma, beta, key_bias, num_heads, seed, arate, hrate, eps, block):
        ctx.save_for_backward(x, wqkv, bqkv, wo, bo, gamma, key_bias)
        ctx.cfg = (num_heads, seed, arate, hrate, eps, block)
        return _attn_forward(x, wqkv, bqkv, wo, bo, gamma, beta, key_bias, num_heads, seed, arate, hrate, eps,
                             block)

    @staticmethod
    def backward(ctx, dy):
        with span("block.attention_train_bwd"):  # on autograd's thread on the card
            grads = attention_block_train_backward(dy, *ctx.saved_tensors, *ctx.cfg)
        # the key mask is an additive bias from integer lengths: no gradient (:955-957)
        return (*grads, None, None, None, None, None, None, None)


def attention_block_train(x, wqkv, bqkv, wo, bo, gamma, beta, num_heads: int, seed: int, bias=None,
                          attn_dropout_rate: float = 0.0, hidden_dropout_rate: float = 0.0, eps: float = 1e-12,
                          block_b: int | None = None) -> torch.Tensor:
    """x [B, S, H] (bf16 on CUDA), f32 weights [H, 3H], [3H], [H, H], [H] and
    the LN's [H], bias None or a [B, S] / [B, 1, 1, S] key mask -> [B, S, H]
    in x's dtype; probability and hidden dropout from ``seed``, masks drawn
    per grid block of ``block_b`` pairs (``dropout.train_block``). Spans
    ``block.attention_train`` and, around its backward, ``block.attention_train_bwd``."""
    b, s, _ = x.shape
    block, seed = shard_block("attn", b, block_b, seed)
    with span("block.attention_train"):
        y = _AttnTrain.apply(x, wqkv, bqkv, wo, bo, gamma, beta, key_bias_rows(bias, b, s), num_heads, seed,
                             float(attn_dropout_rate), float(hidden_dropout_rate), eps, block)
    if x.is_cuda:
        attention_block_train.launches += 1
    return y


attention_block_train.launches = 0


def attention_block_train_plain(x, wqkv, bqkv, wo, bo, gamma, beta, num_heads: int, seed: int, bias=None,
                                attn_dropout_rate: float = 0.0, hidden_dropout_rate: float = 0.0,
                                eps: float = 1e-12, block_b: int | None = None) -> torch.Tensor:
    """The same block in plain differentiable torch, on any device, in x's dtype."""
    b, s, h = x.shape
    dt = x.dtype
    block, seed = shard_block("attn", b, block_b, seed)
    x2d = x.reshape(b * s, h)
    qkv = (torch.matmul(x2d.float(), wqkv.to(dt).float()) + bqkv.float()).to(dt)
    q, k, v = (split_heads(t, num_heads) for t in qkv.reshape(b, s, 3 * h).split(h, dim=-1))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / q.shape[-1]**0.5)
    kb = key_bias_rows(bias, b, s)
    if kb is not None:
        scores = scores + kb[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if attn_dropout_rate > 0.0:
        keep = cross_probs_keep(seed, attn_dropout_rate, b, num_heads, s, s, block, x.device)
        probs = torch.where(keep, probs * keep_scale(attn_dropout_rate), 0.0)
    ctx = merge_heads(torch.matmul(probs.to(dt).float(), v.float()).to(dt)).reshape(b * s, h)
    o = torch.matmul(ctx.float(), wo.to(dt).float()) + bo.float()
    if hidden_dropout_rate > 0.0:
        keep = hidden_keep(seed, hidden_dropout_rate, b * s, h, block * s, x.device)
        o = torch.where(keep, o * keep_scale(hidden_dropout_rate), 0.0)
    return layernorm_plain(o + x2d.float(), gamma, beta, eps, out_dtype=dt).reshape(b, s, h)


# --------------------------------------------------------------------------
# cross-attention block (the LXMERT x-layers)
# --------------------------------------------------------------------------


def _cross_projections(x, ctx, wq, bq, wkv, bkv, wo, bo, key_bias, num_heads, seed, arate, block):
    """-> (x2d, ctx2d, q, kv, ctxout, o): the forward up to the out-projection, in x's dtype."""
    b, f, h = x.shape
    t = ctx.shape[1]
    dt = x.dtype
    x2d, c2d = x.reshape(b * f, h), ctx.to(dt).reshape(b * t, h)
    q = gemm(x2d, wq.to(dt), bq, "bias")
    kv = gemm(c2d, wkv.to(dt), bkv, "bias")
    co = attn_train_cross(q, kv, key_bias, b, f, t, num_heads, seed, arate, block)
    return x2d, c2d, q, kv, co, gemm(co, wo.to(dt), bo, "f32")


def cross_attention_block_train_backward(dy, x, ctx, wq, bq, wkv, bkv, wo, bo, gamma, key_bias, num_heads: int,
                                         seed: int, arate: float, hrate: float, eps: float, block: int):
    """-> (dx, dctx, dwq, dbq, dwkv, dbkv, dwo, dbo, dgamma, dbeta): the
    forward recomputed from x and ctx."""
    b, f, h = x.shape
    t = ctx.shape[1]
    dt = x.dtype
    x2d, c2d, q, kv, co, o = _cross_projections(x, ctx, wq, bq, wkv, bkv, wo, bo, key_bias, num_heads, seed, arate,
                                                block)
    dz, do, dgamma_p, dbeta_p = ln_train_bwd(o, x2d, dy.to(dt).reshape(b * f, h).contiguous(), gamma, seed, hrate,
                                             block * f, eps)
    dco = gemm(do, wo.to(dt), None, "bias", trans_b=True)
    dq, dkv = attn_train_cross_bwd(q, kv, dco, key_bias, b, f, t, num_heads, seed, arate, block)
    dx = gemm(dq, wq.to(dt), None, "residual_f32", aux=dz, trans_b=True)
    dctx = gemm(dkv, wkv.to(dt), None, "bias", trans_b=True)
    dwq, dbq = weight_grads(x2d, dq)
    dwkv, dbkv = weight_grads(c2d, dkv)
    dwo, dbo = weight_grads(co, do)
    if x.is_cuda:
        cross_attention_block_train_backward.launches += 1
    return (dx.reshape(b, f, h), dctx.reshape(b, t, h), dwq, dbq, dwkv, dbkv, dwo, dbo, dgamma_p.sum(0),
            dbeta_p.sum(0))


cross_attention_block_train_backward.launches = 0


class _CrossTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, wq, bq, wkv, bkv, wo, bo, gamma, beta, key_bias, num_heads, seed, arate, hrate, eps,
                block):
        ctx.save_for_backward(x, c, wq, bq, wkv, bkv, wo, bo, gamma, key_bias)
        ctx.cfg = (num_heads, seed, arate, hrate, eps, block)
        b, f, h = x.shape
        x2d, _, _, _, _, o = _cross_projections(x, c, wq, bq, wkv, bkv, wo, bo, key_bias, num_heads, seed, arate,
                                                block)
        return ln_train(o, x2d, gamma, beta, seed, hrate, block * f, eps).reshape(b, f, h)

    @staticmethod
    def backward(ctx, dy):
        grads = cross_attention_block_train_backward(dy, *ctx.saved_tensors, *ctx.cfg)
        # the key mask is an additive bias from integer lengths: no gradient (:1375)
        return (*grads, None, None, None, None, None, None, None)


def cross_attention_block_train(x, ctx, wq, bq, wkv, bkv, wo, bo, gamma, beta, num_heads: int, seed: int,
                                bias=None, attn_dropout_rate: float = 0.0, hidden_dropout_rate: float = 0.0,
                                eps: float = 1e-12, block_b: int | None = None) -> torch.Tensor:
    """x [B, F, H] and ctx [B, T, H] (bf16 on CUDA), f32 weights [H, H],
    [H], [H, 2H], [2H], [H, H], [H] and the LN's [H], bias None or a [B, T] /
    [B, 1, 1, T] mask of ctx's keys -> [B, F, H] in x's dtype; probability and
    hidden dropout from ``seed``, masks drawn per grid block of ``block_b``
    pairs (``dropout.train_block``, the attention kind, as JAX resolves it)."""
    b, _, _ = x.shape
    t = ctx.shape[1]
    block, seed = shard_block("attn", b, block_b, seed)
    y = _CrossTrain.apply(x, ctx, wq, bq, wkv, bkv, wo, bo, gamma, beta, key_bias_rows(bias, b, t), num_heads,
                          seed, float(attn_dropout_rate), float(hidden_dropout_rate), eps, block)
    if x.is_cuda:
        cross_attention_block_train.launches += 1
    return y


cross_attention_block_train.launches = 0


def cross_attention_block_train_plain(x, ctx, wq, bq, wkv, bkv, wo, bo, gamma, beta, num_heads: int, seed: int,
                                      bias=None, attn_dropout_rate: float = 0.0, hidden_dropout_rate: float = 0.0,
                                      eps: float = 1e-12, block_b: int | None = None) -> torch.Tensor:
    """The same block in plain differentiable torch, on any device, in x's dtype."""
    b, f, h = x.shape
    t = ctx.shape[1]
    dt = x.dtype
    block, seed = shard_block("attn", b, block_b, seed)
    x2d, c2d = x.reshape(b * f, h), ctx.to(dt).reshape(b * t, h)
    q = (torch.matmul(x2d.float(), wq.to(dt).float()) + bq.float()).to(dt)
    kv = (torch.matmul(c2d.float(), wkv.to(dt).float()) + bkv.float()).to(dt)
    qh = split_heads(q.reshape(b, f, h), num_heads)
    k, v = (split_heads(z, num_heads) for z in kv.reshape(b, t, 2 * h).split(h, dim=-1))
    scores = torch.matmul(qh.float(), k.float().transpose(-1, -2)) * (1.0 / qh.shape[-1]**0.5)
    kb = key_bias_rows(bias, b, t)
    if kb is not None:
        scores = scores + kb[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if attn_dropout_rate > 0.0:
        keep = cross_probs_keep(seed, attn_dropout_rate, b, num_heads, f, t, block, x.device)
        probs = torch.where(keep, probs * keep_scale(attn_dropout_rate), 0.0)
    co = merge_heads(torch.matmul(probs.to(dt).float(), v.float()).to(dt)).reshape(b * f, h)
    o = torch.matmul(co.float(), wo.to(dt).float()) + bo.float()
    if hidden_dropout_rate > 0.0:
        keep = hidden_keep(seed, hidden_dropout_rate, b * f, h, block * f, x.device)
        o = torch.where(keep, o * keep_scale(hidden_dropout_rate), 0.0)
    return layernorm_plain(o + x2d.float(), gamma, beta, eps, out_dtype=dt).reshape(b, f, h)
