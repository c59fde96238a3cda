"""Two-tower dual encoder and exact recall, the port of the JAX package's
``models/two_tower.py``: the retrieval stage in front of the cross-encoders.

* query tower: the word and position embeddings (no token-type row), the
  embedding LayerNorm, a shallow post-LN encoder over the 20 query tokens
  under their key mask, the CLS row, ``query_proj`` and L2 normalisation;
* product tower: ImageBERT-B's image tokens (the banded label conv, the box
  and feature denses; ``models/imagebert_b.py:image_tokens``), cast to the
  compute dtype with no ``kdd_featureemb`` and no LayerNorm, a shallow encoder
  over the 10 boxes under their key mask, the mean over the valid boxes (a
  product with none divides by 1), ``product_proj`` and L2 normalisation;
* training: the symmetric in-batch InfoNCE with a temperature, off-diagonal
  pairs of one query group masked out (``contrastive_loss``);
* retrieval: exact maximum inner product over a catalog, one chunk at a time
  (``top_k_products``), or with the catalog sharded over the ranks of a
  ``torch.distributed`` group (``recall_sharded``).

The encoders run the blocks of the attention backend, as every model of the
port does: the fused blocks' kernels under "pallas_packed" (S=20 and S=10
with key masks, or the fused layer with ``KMR_FUSED_LAYER=1``). In bf16 the
two projections to ``embed_dim`` columns are ``gemm_bf16``'s "f32" epilogue,
as the label conv is, under every backend. The towers have no dropout; they
train through the train blocks at rate 0 (the scoring blocks have no
backward), with the projections as plain products.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..data.tsv import MAX_BOXES, MAX_QUERY_LEN_AB
from ..ops.attention import mask_to_bias
from . import imagebert_b
from .core import (
    KERNEL_BLOCKS,
    TRAIN_KERNEL_BLOCKS,
    BertConfig,
    Blocks,
    Params,
    Precision,
    TrainBlocks,
    dense,
    dense_init,
    embeddings_init,
    encoder,
    encoder_init,
    layer_norm,
    num_layers,
)

# the batch entries each tower reads (the export's feature keys), and both (the engine's input keys)
QUERY_KEYS = ("input_ids", "len_query")
PRODUCT_KEYS = ("boxes", "features", "label_ids", "num_boxes")
INPUT_KEYS = QUERY_KEYS + PRODUCT_KEYS
MATMUL_KERNELS = tuple(
    (enc, *path) for enc in ("query_encoder", "product_encoder")
    for path in (("attention", "qkv"), ("attention", "output", "dense"), ("ffn", "intermediate"),
                 ("ffn", "output", "dense"))
) + (("kdd_conv1",), ("kdd_dense1",), ("kdd_conv2",), ("query_proj",), ("product_proj",))


@dataclass(frozen=True)
class TwoTowerConfig:
    bert: BertConfig = BertConfig(num_hidden_layers=4)
    embed_dim: int = 128
    temperature: float = 0.05


def two_tower_config(overrides: dict | None = None) -> TwoTowerConfig:
    """The default config, changed by ``KMR_TOWER_CONFIG_OVERRIDES`` (JSON with
    an optional "bert" sub-dict, the JAX package's hook) and then by
    ``overrides``' BertConfig fields."""
    raw = dict(json.loads(os.environ.get("KMR_TOWER_CONFIG_OVERRIDES") or "{}"))
    bert = BertConfig(num_hidden_layers=4).replace(**raw.pop("bert", {}), **(overrides or {}))
    return TwoTowerConfig(bert=bert, **raw)


def init_params(tcfg: TwoTowerConfig, gen: torch.Generator) -> Params:
    """Random parameters in the port's layout (the label conv banded), drawn from ``gen``."""
    cfg = tcfg.bert
    h, std = cfg.hidden_size, cfg.initializer_range
    return {
        "bert": {"embeddings": embeddings_init(cfg, gen)},
        "query_encoder": encoder_init(cfg, gen),
        "product_encoder": encoder_init(cfg, gen),
        "kdd_conv1": imagebert_b.label_conv_band(0.02 * torch.randn((imagebert_b.CONV_TAPS, h, h), generator=gen),
                                                 torch.zeros(h)),
        "kdd_dense1": dense_init(5, h, std, gen),
        "kdd_conv2": dense_init(imagebert_b.FEATURE_DIM, h, std, gen),
        "query_proj": dense_init(h, tcfg.embed_dim, std, gen),
        "product_proj": dense_init(h, tcfg.embed_dim, std, gen),
    }


def from_jax(params: Params) -> Params:
    """``checkpoint.params_from_jax``'s tower tree -> the port's layout: the label conv's taps banded once."""
    conv = params["kdd_conv1"]
    return {**params, "kdd_conv1": imagebert_b.label_conv_band(conv["weights"], conv["biases"])}


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _project(p: Params, x: torch.Tensor, prec: Precision, blocks: Blocks | TrainBlocks) -> torch.Tensor:
    """f32 (x @ kernel + bias) from operands rounded to the compute dtype: in
    bf16 the GEMM's "f32" epilogue (``blocks.gemm``), else, and in training,
    the plain product."""
    if isinstance(blocks, TrainBlocks) or prec.compute_dtype != torch.bfloat16:
        return dense(p, x, prec)
    return blocks.gemm(x.to(torch.bfloat16).contiguous(), p["kernel"], p["bias"], "f32")


def _train_setup(cfg: BertConfig, p: Params, blocks, train: bool):
    """-> (config, blocks, per-layer seeds): in training the train blocks at dropout 0 (the towers have none),
    whose seeds are then moot."""
    if not train:
        return cfg, KERNEL_BLOCKS if blocks is None else blocks, None
    cfg = cfg.replace(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return cfg, TRAIN_KERNEL_BLOCKS if blocks is None else blocks, [(0, 0)] * num_layers(p)


def embed_query(p: Params, batch: dict, tcfg: TwoTowerConfig, prec: Precision | None = None,
                blocks: Blocks | TrainBlocks | None = None, train: bool = False) -> torch.Tensor:
    """input_ids [B, 20], len_query [B] -> [B, D] f32 unit embeddings."""
    prec = prec if prec is not None else Precision.f32()
    cfg, blocks, seeds = _train_setup(tcfg.bert, p["query_encoder"], blocks, train)
    emb = p["bert"]["embeddings"]
    x = F.embedding(batch["input_ids"].long(), emb["word_embeddings"])
    x = x + emb["position_embeddings"][:MAX_QUERY_LEN_AB]
    x = layer_norm(emb["LayerNorm"], x, out_dtype=prec.compute_dtype)
    mask = torch.arange(MAX_QUERY_LEN_AB, device=x.device)[None, :] < batch["len_query"][:, None]
    seq = encoder(p["query_encoder"], x, mask_to_bias(mask), cfg, prec, blocks, seeds=seeds)
    return _l2(_project(p["query_proj"], seq[:, 0, :], prec, blocks))


def embed_product(p: Params, batch: dict, tcfg: TwoTowerConfig, prec: Precision | None = None,
                  blocks: Blocks | TrainBlocks | None = None, train: bool = False) -> torch.Tensor:
    """boxes [B, 10, 5], features [B, 10, 2048], label_ids [B, 10, 8], num_boxes [B] -> [B, D] f32 unit
    embeddings."""
    prec = prec if prec is not None else Precision.f32()
    cfg, blocks, seeds = _train_setup(tcfg.bert, p["product_encoder"], blocks, train)
    img = imagebert_b.image_tokens(p, batch, prec, blocks).to(prec.compute_dtype)  # [B, 10, H]
    mask = torch.arange(MAX_BOXES, device=img.device)[None, :] < batch["num_boxes"][:, None]
    seq = encoder(p["product_encoder"], img, mask_to_bias(mask), cfg, prec, blocks, seeds=seeds)
    m = mask.float()[..., None]
    pooled = (seq * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    return _l2(_project(p["product_proj"], pooled, prec, blocks))


# each embedder and the batch entries it reads
SIDES = {"query": (embed_query, QUERY_KEYS), "product": (embed_product, PRODUCT_KEYS)}


def apply(p: Params, batch: dict, tcfg: TwoTowerConfig, prec: Precision | None = None,
          blocks: Blocks | TrainBlocks | None = None, train: bool = False,
          gen: torch.Generator | None = None) -> dict:
    """Both towers over aligned (query, product) rows: ``score`` is each pair's
    cosine, ``probs`` its 2 columns (1 - score, score) for the generic metrics.
    ``train=True`` (the tree of ``train_params``, taps for the label conv):
    the train blocks of ``blocks``, a ``TrainBlocks``, at dropout 0; ``gen``
    is not read (the towers draw no dropout)."""
    del gen
    q = embed_query(p, batch, tcfg, prec, blocks, train)
    pe = embed_product(p, batch, tcfg, prec, blocks, train)
    score = (q * pe).sum(dim=-1)
    return {"q_emb": q, "p_emb": pe, "score": score, "probs": torch.stack([1.0 - score, score], dim=-1)}


def contrastive_loss(q_emb: torch.Tensor, p_emb: torch.Tensor, temperature: float = 0.05,
                     group_ids: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Symmetric in-batch InfoNCE, the diagonal pairs the positives; with
    ``group_ids`` [B], off-diagonal pairs of one group (one query's products)
    are masked out of both softmaxes -> (loss, {"in_batch_accuracy"})."""
    logits = (q_emb.float() @ p_emb.float().T) / temperature
    b = q_emb.shape[0]
    if group_ids is not None:
        same = group_ids[:, None] == group_ids[None, :]
        off_diag = ~torch.eye(b, dtype=torch.bool, device=logits.device)
        logits = torch.where(same & off_diag, -torch.inf, logits)
    loss_q = -torch.log_softmax(logits, dim=1).diagonal().mean()
    loss_p = -torch.log_softmax(logits, dim=0).diagonal().mean()
    labels = torch.arange(b, device=logits.device)
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return 0.5 * (loss_q + loss_p), {"in_batch_accuracy": acc}


# --------------------------------------------------------------------------
# exact recall
# --------------------------------------------------------------------------


def inner_products(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """q [Q, D], c [C, D] of one dtype -> f32 [Q, C] scores. bf16 on the card:
    one product with bf16 operands and f32 sums and out (``aten::mm.dtype``),
    as the JAX einsum's ``preferred_element_type``; a bf16 product would round
    every score to 8 bits and tie them. Otherwise the f32 product of the values."""
    if c.is_cuda and c.dtype == torch.bfloat16:
        return torch.mm(q, c.T, out_dtype=torch.float32)
    return torch.matmul(q.float(), c.float().T)


def top_k_stable(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row of ``s`` [Q, N] -> (values, positions)
    [Q, k], by value descending and, among equal values, by position ascending
    (``lax.top_k``'s order; ``torch.topk`` promises none among ties): the
    candidates at or above each row's k-th value, ordered by position, then a
    stable sort by value."""
    kth = torch.topk(s, k, dim=1).values[:, -1:]
    m = int((s >= kth).sum(dim=1).max())  # the widest row's candidates: k unless the k-th value ties
    vals, pos = torch.topk(s, m, dim=1)
    by_pos = torch.argsort(pos, dim=1)
    vals, pos = vals.gather(1, by_pos), pos.gather(1, by_pos)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    return vals.gather(1, order), pos.gather(1, order)


def top_k_products(q_emb: torch.Tensor, catalog: torch.Tensor, k: int = 5, chunk: int = 1 << 18,
                   num_valid: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact MIPS of q_emb [Q, D] over catalog [N, D] (bf16 recommended), one
    ``chunk`` of rows at a time -> (f32 scores [Q, k], int64 indices [Q, k]).

    The query is cast to the catalog's dtype and scored in f32
    (``inner_products``); rows ``>= num_valid`` score -inf. Each chunk's scores
    are merged with the running top-k, which comes first, so ties go to the
    lower index, as the JAX scan's ``lax.top_k`` gives them; a catalog of fewer
    valid rows than k leaves the running top-k's initial (-inf, -1) slots."""
    n = catalog.shape[0]
    num_valid = n if num_valid is None else num_valid
    q = q_emb.to(catalog.dtype)
    best_s = torch.full((q.shape[0], k), -torch.inf, device=catalog.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=catalog.device)
    for lo in range(0, n, chunk):
        scores = inner_products(q, catalog[lo:lo + chunk])
        idx = torch.arange(lo, lo + scores.shape[1], device=catalog.device)
        scores = torch.where(idx < num_valid, scores, -torch.inf)
        merged_i = torch.cat([best_i, idx.expand(q.shape[0], -1)], dim=1)
        best_s, pos = top_k_stable(torch.cat([best_s, scores], dim=1), k)
        best_i = merged_i.gather(1, pos)
    return best_s, best_i


def recall_sharded(q_emb: torch.Tensor, catalog: torch.Tensor, mesh=None, k: int = 5,
                   chunk: int = 1 << 18) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact MIPS with the catalog sharded over the ranks of the process group
    (the JAX package's ``recall_sharded``, its ``data`` axis the group): every
    rank holds ``q_emb`` and ``catalog`` [N, D] and scores its shard of the
    catalog padded to a multiple of the world, its valid rows bounded by
    ``clip(N - rank * shard, 0, shard)`` so that pad rows cannot displace real
    (possibly negative) candidates; the ranks' k candidates are all-gathered
    and merged in rank order by ``top_k_stable`` (ties to the lower index, as
    ``lax.top_k`` over [Q, k * devices]); hits in the padded tail map to
    (-inf, -1). -> (f32 scores [Q, k], int64 indices [Q, k]) on every rank.
    With one rank it is ``top_k_products`` over the whole catalog. ``mesh``
    (``parallel/mesh.py``) is optional: the group is the mesh's data axis."""
    from ..parallel.distributed import process_count, process_index

    world = mesh.n_data if mesh is not None else process_count()
    rank = mesh.rank if mesh is not None else process_index()
    n = catalog.shape[0]
    shard = -(-n // world)
    rows = catalog[rank * shard:(rank + 1) * shard]
    if rows.shape[0] < shard:  # the pad rows, in the last shards
        rows = torch.cat([rows, rows.new_zeros(shard - rows.shape[0], catalog.shape[1])])
    valid = min(max(n - rank * shard, 0), shard)
    s, i = top_k_products(q_emb, rows, k=k, chunk=min(chunk, shard), num_valid=valid)
    i = i + rank * shard  # the shard's (-inf, -1) slots too, as the JAX shard_map's offset
    if world > 1:
        import torch.distributed as dist

        parts_s, parts_i = [torch.empty_like(s) for _ in range(world)], [torch.empty_like(i) for _ in range(world)]
        dist.all_gather(parts_s, s.contiguous())
        dist.all_gather(parts_i, i.contiguous())
        s, i = torch.cat(parts_s, dim=1), torch.cat(parts_i, dim=1)
    top_s, pos = top_k_stable(s, k)
    top_i = i.gather(1, pos)
    ok = top_i < n
    return torch.where(ok, top_s, -torch.inf), torch.where(ok, top_i, -1)
