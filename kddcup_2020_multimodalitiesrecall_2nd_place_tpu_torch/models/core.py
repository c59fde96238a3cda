"""Shared transformer core: the port of the JAX package's ``models/core.py``.

* ``BertConfig`` (mirrors ``assets/user_data/bert_config.json``),
* ``Precision``: the compute dtype plus the float32 matmul policy,
* ``dense`` and ``layer_norm`` (eps 1e-12, float32 internals),
* the post-LN encoder, a loop over ``[L]``-stacked layer parameters, and its
  blocks: the self- and cross-attention blocks, the FFN block and the pair of
  shared-weight cross directions of an LXMERT x-layer. Which route a block
  takes follows the attention backend (``ops/attention.py``), as in the JAX
  package: under "pallas_packed" the fused blocks of ``ops/`` (``Blocks``),
  or with ``KMR_FUSED_LAYER=1`` one fused encoder layer each; under "xla" and
  "pallas" the unfused route of plain products around ``ops/attention.py:mha``
  (its ``models/core.py`` :331-360 and :497-504). Given per-layer dropout
  seeds (training), the self-attention, cross-attention and FFN blocks are
  the train blocks of ``ops/train_blocks.py`` (``TrainBlocks``) on every
  backend, and ``KMR_DUAL_CROSS`` and ``KMR_FUSED_LAYER`` are ignored, as the
  JAX package takes its fused train blocks whenever it trains
  (``models/core.py`` :192-280, :388-392, :449-477),
* ``dropout`` of the embeddings (training), drawn from a ``torch.Generator``,
* embedding and pooler pieces, and initialisers (truncated normal,
  stddev=initializer_range, as ``pixelmodel.py:418-420``).

Parameters are a nested dict of tensors in the JAX package's tree layout,
except that each attention's query/key/value are fused once, at load time
(``attention_forms``), into one ``qkv`` [H, 3H] kernel, and a cross
attention also keeps ``query`` [H, H] and ``kv`` [H, 2H]: the kernels take
contiguous weights, and a column slice of ``qkv`` is not one. Matmul inputs
are rounded to ``Precision.compute_dtype`` and multiplied in float32;
LayerNorm, softmax and all head math stay float32.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..ops.activations import gelu_erf, gelu_tanh
from ..ops.attention import merge_heads, mha, packed_attention_active, split_heads
from ..ops.attention_block import attention_block as attention_block_op
from ..ops.attention_block import attention_block_plain, is_compact
from ..ops.band_conv import band_conv_train, band_conv_train_plain
from ..ops.cross_attention_block import cross_attention_block as cross_attention_block_op
from ..ops.cross_attention_block import cross_attention_block_plain
from ..ops.dropout import shard_rows
from ..ops.dual_cross_attention_block import dual_cross_attention_block as dual_cross_attention_block_op
from ..ops.dual_cross_attention_block import dual_cross_attention_block_plain
from ..ops.encoder_layer import encoder_layer as encoder_layer_op
from ..ops.encoder_layer import encoder_layer_plain
from ..ops.ffn_block import ffn_block as ffn_block_op
from ..ops.ffn_block import ffn_block_plain
from ..ops.kernels import gemm_plain, layernorm_plain
from ..ops.library import gemm
from ..ops.quant import QUANT_KERNEL, dense_q8
from ..ops.train_blocks import (
    attention_block_train,
    attention_block_train_plain,
    cross_attention_block_train,
    cross_attention_block_train_plain,
    ffn_block_train,
    ffn_block_train_plain,
)

Params = dict[str, Any]


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 21128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02

    @classmethod
    def from_json_file(cls, path) -> "BertConfig":
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    def replace(self, **kw) -> "BertConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Precision:
    """Compute dtype of the matmul inputs and of the residual stream.

    ``f32()`` is the strict-parity mode: it also turns TF32 off for float32
    matmuls and convolutions, the counterpart of the JAX package forcing
    ``Precision.HIGHEST`` (``models/core.py`` :77-96). ``bf16()`` is the
    mode of the CUDA kernels."""

    compute_dtype: torch.dtype = torch.float32

    @classmethod
    def f32(cls) -> "Precision":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return cls(torch.float32)

    @classmethod
    def bf16(cls) -> "Precision":
        return cls(torch.bfloat16)


class Blocks(NamedTuple):
    """The fused block functions the models call under the "pallas_packed"
    backend, and the GEMM of ImageBERT-B's banded label conv (its "f32"
    epilogue), which every backend runs."""

    attention: Callable[..., torch.Tensor]
    ffn: Callable[..., torch.Tensor]
    cross: Callable[..., torch.Tensor]
    dual: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    layer: Callable[..., torch.Tensor]
    gemm: Callable[..., torch.Tensor]


# the kernels (custom ops over the wrappers): plain versions on CPU tensors, the CUDA kernels on CUDA tensors
KERNEL_BLOCKS = Blocks(attention_block_op, ffn_block_op, cross_attention_block_op,
                       dual_cross_attention_block_op, encoder_layer_op, gemm)
# the oracles, on any device (chip_smoke.py holds the kernels against them)
PLAIN_BLOCKS = Blocks(attention_block_plain, ffn_block_plain, cross_attention_block_plain,
                      dual_cross_attention_block_plain, encoder_layer_plain, gemm_plain)


class TrainBlocks(NamedTuple):
    """The self-attention, FFN and cross-attention blocks a model trains
    with (with dropout, their masks from per-block seeds, and a backward), and
    ImageBERT-B's label conv from its taps (``ops/band_conv.py``)."""

    attention: Callable[..., torch.Tensor]
    ffn: Callable[..., torch.Tensor]
    cross: Callable[..., torch.Tensor]
    band_conv: Callable[..., torch.Tensor]


# the autograd Functions over the kernels (plain versions on CPU tensors)
TRAIN_KERNEL_BLOCKS = TrainBlocks(attention_block_train, ffn_block_train, cross_attention_block_train,
                                  band_conv_train)
# the plain differentiable oracles, on any device (chip_smoke.py runs one step on both)
TRAIN_PLAIN_BLOCKS = TrainBlocks(attention_block_train_plain, ffn_block_train_plain,
                                 cross_attention_block_train_plain, band_conv_train_plain)

GELU_APPROXIMATE = {"gelu": True, "gelu_erf": False}
GELU = {"gelu": gelu_tanh, "gelu_erf": gelu_erf}


# --------------------------------------------------------------------------
# initialisers
# --------------------------------------------------------------------------


def trunc_normal(shape, stddev: float, gen: torch.Generator) -> torch.Tensor:
    """tf.truncated_normal_initializer: normal truncated at 2 sigma."""
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, std=stddev, a=-2 * stddev, b=2 * stddev, generator=gen)


def dense_init(d_in: int, d_out: int, stddev: float, gen: torch.Generator, lead=()) -> Params:
    return {
        "kernel": trunc_normal((*lead, d_in, d_out), stddev, gen),
        "bias": torch.zeros((*lead, d_out)),
    }


def layer_norm_init(dim: int, lead=()) -> Params:
    return {"gamma": torch.ones((*lead, dim)), "beta": torch.zeros((*lead, dim))}


def attention_forms(att: Params, cross: bool = False) -> Params:
    """query/key/value dense params (last axis = outputs) -> the fused forms
    the blocks read: ``qkv`` [.., H, 3H]; with ``cross``, also ``query``
    [.., H, H] and ``kv`` [.., H, 2H]. Other entries (``output``) are kept."""
    parts = [att[n] for n in ("query", "key", "value")]
    out = {k: v for k, v in att.items() if k not in ("query", "key", "value")}
    # every leaf of the node (kernel and bias; kernel_q8, kernel_scale and bias of an int8 one) fused
    # along the outputs: an int8 node's scales are per output column, so the fused node is the three nodes'
    out["qkv"] = {n: torch.cat([p[n] for p in parts], dim=-1) for n in parts[0]}
    if cross:
        out["query"] = parts[0]
        out["kv"] = {n: torch.cat([p[n] for p in parts[1:]], dim=-1) for n in parts[0]}
    return out


def encoder_init(cfg: BertConfig, gen: torch.Generator, num_layers: int | None = None) -> Params:
    """Stacked layer params, every leaf with a leading [L] axis."""
    lead = (num_layers or cfg.num_hidden_layers,)
    h, i, std = cfg.hidden_size, cfg.intermediate_size, cfg.initializer_range
    return {
        "attention": {
            "qkv": dense_init(h, 3 * h, std, gen, lead),
            "output": {"dense": dense_init(h, h, std, gen, lead), "LayerNorm": layer_norm_init(h, lead)},
        },
        "ffn": {
            "intermediate": dense_init(h, i, std, gen, lead),
            "output": {"dense": dense_init(i, h, std, gen, lead), "LayerNorm": layer_norm_init(h, lead)},
        },
    }


def embeddings_init(cfg: BertConfig, gen: torch.Generator) -> Params:
    std = cfg.initializer_range
    return {
        "word_embeddings": trunc_normal((cfg.vocab_size, cfg.hidden_size), std, gen),
        "token_type_embeddings": trunc_normal((cfg.type_vocab_size, cfg.hidden_size), std, gen),
        "position_embeddings": trunc_normal((cfg.max_position_embeddings, cfg.hidden_size), std, gen),
        "LayerNorm": layer_norm_init(cfg.hidden_size),
    }


def token_type_embed(table: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """[..., H] rows of the 2-row token-type table picked by ``segment_ids``
    (0 or 1): the gather as a select, whose backward sums each row's gradient
    in a fixed order (``F.embedding``'s CUDA backward sums the many rows into
    these 2 in a varying order, so two runs of one step differ)."""
    if table.shape[0] != 2:
        raise ValueError(f"a token-type table of {table.shape[0]} rows; the models have 2")
    return torch.where(segment_ids[..., None] == 0, table[0], table[1])


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------


def dense(p: Params, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """f32 (x @ kernel + bias), with x and kernel rounded to the compute
    dtype first (the JAX dot with preferred_element_type=float32); an int8
    node (``kernel_q8``) goes to ``ops/quant.py:dense_q8``, as the JAX
    package's ``models/core.py`` :126-129 sends it."""
    if QUANT_KERNEL in p:
        return dense_q8(p, x)
    dt = prec.compute_dtype
    y = torch.matmul(x.to(dt).float(), p["kernel"].to(dt).float())
    return y + p["bias"].float()


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-12, out_dtype=None) -> torch.Tensor:
    """LayerNorm with float32 internals; optionally emits a narrower dtype."""
    return layernorm_plain(x, p["gamma"], p["beta"], eps, out_dtype)


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with a keep mask drawn from ``gen`` (on x's device), as
    the JAX package's ``models/core.py`` :153-157 draws it with jax.random.
    A data-parallel rank (``ops/dropout.py:batch_shard``) draws the global
    batch's mask and keeps its own rows of it."""
    if rate <= 0.0 or gen is None:
        return x
    shard = shard_rows()
    if shard is None:
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    else:
        offset, global_rows = shard
        draw = torch.rand((global_rows, *x.shape[1:]), generator=gen, device=x.device)
        keep = draw[offset:offset + x.shape[0]] < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def block_seeds(gen: torch.Generator, n_layers: int, per_layer: int) -> list[tuple[int, ...]]:
    """``per_layer`` 32-bit dropout seeds for each of ``n_layers`` layers (an
    encoder layer's are its (attention, FFN) pair), from ``gen`` in one draw
    (one host sync)."""
    seeds = torch.randint(-2**31, 2**31 - 1, (n_layers, per_layer), generator=gen, device=gen.device)
    return [tuple(row) for row in seeds.tolist()]


# --------------------------------------------------------------------------
# blocks and encoder
# --------------------------------------------------------------------------


def _vectors(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Biases, gammas and betas as the kernels take them, f32 (exact from the bf16
    leaves of ``ops/quant.py:cast_residual_bf16``'s tree; f32 ones as they are)."""
    return tuple(t if t.dtype == torch.float32 else t.float() for t in ts)


def _bias4(bias):
    """None, [B, T] key-mask rows or a 4-D bias -> a bias broadcastable to [B, N, F, T]."""
    return bias[:, None, None, :] if bias is not None and bias.dim() == 2 else bias


def unfused_attention(p: Params, x, ctx, bias, cfg: BertConfig, prec: Precision):
    """The "xla" and "pallas" route of an attention block (the JAX package's
    ``models/core.py`` :331-360): the QKV product (Q from x, and one [H, 2H]
    product for K, V from ``ctx`` when it is given), ``split_heads``,
    ``ops/attention.py:mha``, ``merge_heads``, the output product, the
    residual and the LayerNorm, emitted in the compute dtype."""
    n, dt = cfg.num_attention_heads, prec.compute_dtype
    if ctx is None:
        q, k, v = dense(p["qkv"], x, prec).to(dt).chunk(3, dim=-1)
    else:
        q = dense(p["query"], x, prec).to(dt)
        k, v = dense(p["kv"], ctx, prec).to(dt).chunk(2, dim=-1)
    o = mha(split_heads(q, n), split_heads(k, n), split_heads(v, n), _bias4(bias))
    o = dense(p["output"]["dense"], merge_heads(o), prec)
    return layer_norm(p["output"]["LayerNorm"], o + x.float(), out_dtype=dt)


def attention_block(p: Params, x, bias, cfg: BertConfig, prec: Precision, blocks: Blocks = KERNEL_BLOCKS,
                    seed: int | None = None):
    """Post-LN self-attention block of one layer: inference, or with a dropout
    ``seed`` the train block of ``blocks`` (a ``TrainBlocks``)."""
    if seed is not None:
        out = p["output"]
        return blocks.attention(
            x, p["qkv"]["kernel"], p["qkv"]["bias"], out["dense"]["kernel"], out["dense"]["bias"],
            out["LayerNorm"]["gamma"], out["LayerNorm"]["beta"], cfg.num_attention_heads, seed, bias=bias,
            attn_dropout_rate=cfg.attention_probs_dropout_prob, hidden_dropout_rate=cfg.hidden_dropout_prob,
        )
    if not packed_attention_active() or "kernel" not in p["qkv"]:  # int8 nodes take the unfused route
        return unfused_attention(p, x, None, bias, cfg, prec)
    out = p["output"]
    bqkv, bo, gamma, beta = _vectors(p["qkv"]["bias"], out["dense"]["bias"], out["LayerNorm"]["gamma"],
                                     out["LayerNorm"]["beta"])
    return blocks.attention(x, p["qkv"]["kernel"], bqkv, out["dense"]["kernel"], bo, gamma, beta,
                            cfg.num_attention_heads, bias)


def cross_attention_block(p: Params, x, ctx, bias, cfg: BertConfig, prec: Precision,
                          blocks: Blocks = KERNEL_BLOCKS, seed: int | None = None):
    """Post-LN cross-attention block: x attends to ctx, ``bias`` masks ctx's
    keys; with a dropout ``seed`` the train block of ``blocks`` (a ``TrainBlocks``)."""
    if seed is None and (not packed_attention_active() or "kernel" not in p["query"]):
        return unfused_attention(p, x, ctx, bias, cfg, prec)  # int8 nodes take the unfused route
    out = p["output"]
    wq, wkv, wo = p["query"]["kernel"], p["kv"]["kernel"], out["dense"]["kernel"]
    bq, bkv, bo, gamma, beta = _vectors(p["query"]["bias"], p["kv"]["bias"], out["dense"]["bias"],
                                        out["LayerNorm"]["gamma"], out["LayerNorm"]["beta"])
    if seed is not None:
        return blocks.cross(
            x, ctx, wq, bq, wkv, bkv, wo, bo, gamma, beta, cfg.num_attention_heads, seed, bias=bias,
            attn_dropout_rate=cfg.attention_probs_dropout_prob, hidden_dropout_rate=cfg.hidden_dropout_prob,
        )
    return blocks.cross(x, ctx, wq, bq, wkv, bkv, wo, bo, gamma, beta, cfg.num_attention_heads, bias)


def dual_cross_attention_blocks(p: Params, l, v, lang_bias, visn_bias, cfg: BertConfig, prec: Precision,
                                blocks: Blocks = KERNEL_BLOCKS, seeds: tuple[int, int] | None = None):
    """Both shared-weight cross directions of an LXMERT x-layer
    (``lxmert/src/lxrt/modeling.py:460-464``): lang <- visn under the visn key
    mask and visn <- lang under the lang key mask, both from the pre-cross
    streams. ``KMR_DUAL_CROSS=1`` on the "pallas_packed" backend runs them as
    one dual block (one attention launch for both directions), as the JAX
    package's ``models/core.py`` :388-417 does, where both biases are key
    masks (or both None); otherwise, and by default, two cross blocks. With
    ``seeds`` (one dropout seed per direction) it trains: two cross train
    blocks, whatever ``KMR_DUAL_CROSS`` says (JAX :388-392)."""
    if seeds is not None:
        return (cross_attention_block(p, l, v, visn_bias, cfg, prec, blocks, seed=seeds[0]),
                cross_attention_block(p, v, l, lang_bias, cfg, prec, blocks, seed=seeds[1]))
    if (packed_attention_active() and os.environ.get("KMR_DUAL_CROSS", "0") == "1" and "kernel" in p["qkv"]
            and is_compact(lang_bias) and is_compact(visn_bias) and (lang_bias is None) == (visn_bias is None)):
        out = p["output"]
        bqkv, bo, gamma, beta = _vectors(p["qkv"]["bias"], out["dense"]["bias"], out["LayerNorm"]["gamma"],
                                         out["LayerNorm"]["beta"])
        return blocks.dual(l, v, p["qkv"]["kernel"], bqkv, out["dense"]["kernel"], bo, gamma, beta,
                           cfg.num_attention_heads, lang_bias, visn_bias)
    return (cross_attention_block(p, l, v, visn_bias, cfg, prec, blocks),
            cross_attention_block(p, v, l, lang_bias, cfg, prec, blocks))


def ffn_block(p: Params, x, cfg: BertConfig, prec: Precision, blocks: Blocks = KERNEL_BLOCKS,
              act: str | None = None, seed: int | None = None):
    """Post-LN feed-forward block of one layer, inference: the fused block
    under "pallas_packed", else dense -> GELU -> dense -> residual -> LN (the
    JAX package's ``models/core.py`` :497-504); with a dropout ``seed``, the
    train block of ``blocks`` (a ``TrainBlocks``). ``act`` overrides
    ``cfg.hidden_act`` (LXMERT runs ``gelu_erf`` under a config that says
    ``gelu``, as the JAX package's ``models/core.py`` :440-448)."""
    act_name = act or cfg.hidden_act
    if act_name not in GELU_APPROXIMATE:
        raise NotImplementedError(f"activation {act_name!r} is not yet ported, see ROADMAP.md")
    out = p["output"]
    if seed is not None:
        return blocks.ffn(
            x, p["intermediate"]["kernel"], p["intermediate"]["bias"], out["dense"]["kernel"], out["dense"]["bias"],
            out["LayerNorm"]["gamma"], out["LayerNorm"]["beta"], seed, dropout_rate=cfg.hidden_dropout_prob,
            approximate_gelu=GELU_APPROXIMATE[act_name],
        )
    if not packed_attention_active() or "kernel" not in p["intermediate"]:  # int8 nodes: the unfused route
        dt = prec.compute_dtype
        hmid = GELU[act_name](dense(p["intermediate"], x, prec)).to(dt)
        y = dense(out["dense"], hmid, prec)
        return layer_norm(out["LayerNorm"], y + x.float(), out_dtype=dt)
    b1, b2, gamma, beta = _vectors(p["intermediate"]["bias"], out["dense"]["bias"], out["LayerNorm"]["gamma"],
                                   out["LayerNorm"]["beta"])
    return blocks.ffn(x, p["intermediate"]["kernel"], b1, out["dense"]["kernel"], b2, gamma, beta,
                      approximate_gelu=GELU_APPROXIMATE[act_name])


def unbind_layers(tree: Params) -> list[Params]:
    """The layers of a tree of [L]-stacked leaves, by ``torch.unbind``, whose
    backward stacks the L gradients once (L index selections would each
    scatter into a zero tensor of the whole stack)."""
    if not isinstance(tree, dict):
        return list(torch.unbind(tree))
    parts = {k: unbind_layers(v) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def num_layers(p: Params) -> int:
    return p["attention"]["qkv"]["bias"].shape[0]


def fused_layer_route(bias, act_name: str) -> bool:
    """True iff ``KMR_FUSED_LAYER=1``, the "pallas_packed" backend is active
    and the layer qualifies for the fused launch: a compact key mask ([B, S]
    rows or [B, 1, 1, S]) or none, and a GELU the kernel has (the gating of
    the JAX package's ``models/core.py`` :570-582)."""
    return (os.environ.get("KMR_FUSED_LAYER", "0") == "1" and packed_attention_active() and is_compact(bias)
            and act_name in GELU_APPROXIMATE)


def encoder_layer(att_p: Params, ffn_p: Params, x, bias, cfg: BertConfig, prec: Precision,
                  blocks: Blocks = KERNEL_BLOCKS, act: str | None = None, fuse: bool = True,
                  seeds: tuple[int, int] | None = None) -> torch.Tensor:
    """One post-LN layer: the attention block then the FFN block (the
    default), or with ``fuse`` and ``KMR_FUSED_LAYER=1`` one fused encoder
    layer, as the JAX package's ``models/core.py`` :612-628 (whose fused
    layer measured slower on its TPU, hence opt-in). With ``seeds`` (its
    (attention, FFN) dropout seeds) it trains: the two train blocks of
    ``blocks``, a ``TrainBlocks``, whatever ``KMR_FUSED_LAYER`` says."""
    act_name = act or cfg.hidden_act
    if (seeds is None and fuse and "kernel" in att_p["qkv"] and "kernel" in ffn_p["intermediate"]
            and fused_layer_route(bias, act_name)):
        out = att_p["output"]
        ffn_out = ffn_p["output"]
        vecs = _vectors(att_p["qkv"]["bias"], out["dense"]["bias"], out["LayerNorm"]["gamma"],
                        out["LayerNorm"]["beta"], ffn_p["intermediate"]["bias"], ffn_out["dense"]["bias"],
                        ffn_out["LayerNorm"]["gamma"], ffn_out["LayerNorm"]["beta"])
        return blocks.layer(
            x, att_p["qkv"]["kernel"], vecs[0], out["dense"]["kernel"], vecs[1], vecs[2], vecs[3],
            ffn_p["intermediate"]["kernel"], vecs[4], ffn_out["dense"]["kernel"], vecs[5], vecs[6], vecs[7],
            cfg.num_attention_heads, bias, approximate_gelu=GELU_APPROXIMATE[act_name],
        )
    attn_seed, ffn_seed = (None, None) if seeds is None else seeds
    x = attention_block(att_p, x, bias, cfg, prec, blocks, seed=attn_seed)
    return ffn_block(ffn_p, x, cfg, prec, blocks, act, seed=ffn_seed)


def encoder(p: Params, x, bias, cfg: BertConfig, prec: Precision,
            blocks: Blocks = KERNEL_BLOCKS, act: str | None = None, fuse: bool = True,
            seeds: list[tuple[int, int]] | None = None) -> torch.Tensor:
    """The post-LN stack; the f32 embedding output is cast to the compute
    dtype on entry (the JAX package's ``models/core.py`` :673). ``fuse=False``
    keeps the two blocks whatever ``KMR_FUSED_LAYER`` says (LXMERT's L and R
    stacks, as the JAX package's ``models/lxmert.py`` :245-259). With
    ``seeds`` (one (attention, FFN) dropout-seed pair per layer) it trains:
    each layer is the two train blocks of ``blocks``, a ``TrainBlocks``; the
    blocks recompute their intermediates in the backward, so no layer needs
    checkpointing (the JAX package's ``models/core.py`` :653-671)."""
    x = x.to(prec.compute_dtype)
    layers = unbind_layers(p)
    for layer, s in zip(layers, seeds if seeds is not None else [None] * len(layers), strict=True):
        x = encoder_layer(layer["attention"], layer["ffn"], x, bias, cfg, prec, blocks, act, fuse, seeds=s)
    return x


def pooler(p: Params, seq: torch.Tensor, prec: Precision) -> torch.Tensor:
    """tanh(dense(first token)) -- pixelmodel.py:262-270."""
    return torch.tanh(dense(p["dense"], seq[:, 0, :], prec))

