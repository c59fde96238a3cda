"""Dropout masks of the training blocks: the counter hash of the JAX package.

The JAX package's train kernels (``ops/pallas_train.py``) draw their dropout
masks from the TPU's hardware PRNG, which no other device reproduces. In
interpret mode they draw from ``_hash_bits`` (:75-95) instead: a murmur3
fmix over a per-element index, seeded per grid block (``_seed_prng``,
:117-121). The port draws from that same hash, in its CUDA kernels
(``csrc/dropout_hash.cuh``) and in their plain versions here, so its masks
are the JAX package's interpret-mode masks bit for bit, at any rate.

* ``hash_bits(seed, draw, shape)``: the uint32 bits, computed in int64 and
  masked to 32 bits (torch has no uint32 multiply; a product is split in two
  16-bit halves so no int64 product overflows).
* A unit is kept iff its bits >= ``dropout_cutoff(rate)``.
* Masks are drawn per grid block of ``block`` pairs: block ``j`` seeds the
  hash with ``int32(seed + j * 1000003)`` and indexes its elements from 0
  (block-local). The hidden draw (draw 0) of a block covers its
  ``[block * S, H]`` rows; head ``i``'s attention-probability draw (draw
  ``1 + i``) covers ``[block, S, S]``, or ``[block, F, T]`` in the cross
  block (whose hidden draw covers ``[block * F, H]``). The index is
  sum_d iota_d * mult_d, so it does not depend on the extents.
* The block size decides the masks, so it is resolved as the JAX package
  resolves it (``_env_block``, ``_pick_block``, :279-288, :383-414):
  ``KMR_TRAIN_BLOCK_FFN`` / ``KMR_TRAIN_BLOCK_ATTN``, then
  ``KMR_TRAIN_BLOCK``, then 4 (FFN) or 8 (attention), shrunk to the largest
  divisor of the batch.
* Data parallelism (``batch_shard``): a rank that holds rows
  ``offset .. offset + b - 1`` of a global batch of ``global_rows`` resolves
  the block from the global batch and shifts its seed by its first block's
  index (``shard_block``), so its masks are those rows of the one-rank run's,
  bit for bit; the embeddings' dropout (``models/core.py:dropout``) draws the
  global batch's mask and keeps its rows (``shard_rows``).
"""

from __future__ import annotations

import contextlib
import os

import torch

U32 = 0xFFFFFFFF
INDEX_MULTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
DRAW_MULT = 0x632BE59B
BLOCK_SEED_STRIDE = 1000003
DEFAULT_BLOCK = {"ffn": 4, "attn": 8}


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the product in two halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & U32


def _index(shape, device) -> torch.Tensor:
    """sum_d iota_d * INDEX_MULTS[d % 4] mod 2^32, broadcast to ``shape``."""
    idx = torch.zeros(shape, dtype=torch.int64, device=device)
    for d, n in enumerate(shape):
        view = [1] * len(shape)
        view[d] = n
        iota = torch.arange(n, dtype=torch.int64, device=device).reshape(view)
        idx = (idx + _mul32(iota, INDEX_MULTS[d % len(INDEX_MULTS)])) & U32
    return idx


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _draw_word(draw: int) -> int:
    return (draw * DRAW_MULT) & U32


def hash_bits(seed: int, draw: int, shape, device=None) -> torch.Tensor:
    """The uint32 bits of ``_hash_bits(seed, draw, shape)`` as int64 values."""
    return _fmix(_index(tuple(shape), device) ^ ((int(seed) & U32) ^ _draw_word(draw)))


def dropout_cutoff(rate: float) -> int:
    """uint32 threshold: drop iff bits < cutoff (P = rate)."""
    return min(int(rate * 4294967296.0), 4294967295)


def keep_scale(rate: float) -> float:
    """The kept units' scale, 1 / (1 - rate), as the kernels take it (an f32)."""
    return 1.0 / (1.0 - rate)


def block_bits(seed: int, draw: int, block_shape, n_blocks: int, device=None) -> torch.Tensor:
    """[n_blocks, *block_shape] bits: block j hashes block-local indices under
    the seed int32(seed + j * 1000003)."""
    seeds = (int(seed) + torch.arange(n_blocks, dtype=torch.int64, device=device) * BLOCK_SEED_STRIDE) & U32
    seeds = seeds.reshape(n_blocks, *([1] * len(block_shape)))
    return _fmix(_index(tuple(block_shape), device)[None] ^ seeds ^ _draw_word(draw))


def hidden_keep(seed: int, rate: float, rows: int, h: int, rows_per_block: int, device=None) -> torch.Tensor:
    """Keep mask [rows, h] of a block's hidden dropout (draw 0): grid block j
    covers rows j*rows_per_block .. (j+1)*rows_per_block - 1."""
    bits = block_bits(seed, 0, (rows_per_block, h), rows // rows_per_block, device)
    return (bits >= dropout_cutoff(rate)).reshape(rows, h)


def cross_probs_keep(seed: int, rate: float, b: int, num_heads: int, f: int, t: int, block: int,
                     device=None) -> torch.Tensor:
    """Keep mask [b, num_heads, f, t] of the attention probabilities of f
    queries over t keys: head i draws 1 + i over each grid block's
    [block, f, t] (``_cross_recompute_heads``, :1061-1064)."""
    cutoff = dropout_cutoff(rate)
    heads = [(block_bits(seed, 1 + i, (block, f, t), b // block, device) >= cutoff).reshape(b, f, t)
             for i in range(num_heads)]
    return torch.stack(heads, dim=1)


def pick_block(b: int, block_b: int) -> int:
    """Largest block <= block_b that divides b (``_pick_block``)."""
    block = min(block_b, b)
    while b % block:
        block -= 1
    return block


def train_block(kind: str, block_b: int | None = None) -> int:
    """A train block's batch-block size before ``pick_block``: an explicit
    ``block_b``, else ``KMR_TRAIN_BLOCK_{KIND}``, else ``KMR_TRAIN_BLOCK``,
    else the per-kind default (``_env_block``)."""
    if block_b is not None:
        return block_b
    for name in (f"KMR_TRAIN_BLOCK_{kind.upper()}", "KMR_TRAIN_BLOCK"):
        v = os.environ.get(name)
        if v:
            iv = int(v)
            if iv <= 0:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
            return iv
    return DEFAULT_BLOCK[kind]


_shard: tuple[int, int] | None = None  # (row offset, global rows) of this rank's rows, under batch_shard


@contextlib.contextmanager
def batch_shard(offset: int, global_rows: int):
    """Inside the block, the batches the train blocks and ``models/core.py:dropout`` see are rows
    ``offset ..`` of a global batch of ``global_rows`` (a data-parallel rank's share)."""
    global _shard
    prev, _shard = _shard, (int(offset), int(global_rows))
    try:
        yield
    finally:
        _shard = prev


def shard_rows() -> tuple[int, int] | None:
    """(row offset, global rows) under ``batch_shard``, else None."""
    return _shard


def shard_block(kind: str, b: int, block_b: int | None, seed: int) -> tuple[int, int]:
    """(block, seed) of a train block over ``b`` rows: the block resolved from the batch (the global one
    under ``batch_shard``) and, under ``batch_shard``, the seed shifted by this rank's first block's
    index, so block j of the rank hashes as global block offset / block + j. Raises when the rank's rows
    do not start and end on the global batch's block boundaries."""
    if _shard is None:
        return pick_block(b, train_block(kind, block_b)), int(seed)
    offset, global_rows = _shard
    block = pick_block(global_rows, train_block(kind, block_b))
    if b % block or offset % block:
        raise ValueError(f"a rank's {b} rows at offset {offset} of a global batch of {global_rows} do not fall on "
                         f"its {kind} dropout blocks of {block} rows")
    return block, int(seed) + (offset // block) * BLOCK_SEED_STRIDE
