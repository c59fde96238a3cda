"""The dropout masks of a training step, worked out again from the step's seed:
a frozen copy of the protocol the port follows (the JAX package's
interpret-mode masks).

* The step seeds a ``torch.Generator`` on the device; it draws each layer's
  (attention, FFN) 32-bit seeds in one ``randint`` and then the embedding
  mask, ``rand < 1 - rate`` over the [B, S, H] embedding output.
* Inside a layer the masks come from a counter hash (murmur3 fmix over a
  per-element index): grid block ``j`` of ``block`` pairs hashes block-local
  indices under the seed ``int32(seed + j * 1000003)``; the hidden draw (0)
  covers a block's [block * S, H] rows, head ``i``'s probability draw
  (1 + i) its [block, S, S]. Attention blocks take 8 pairs, FFN blocks 4,
  shrunk to a divisor of the batch. A unit is kept iff its bits reach
  ``rate * 2**32``.
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
INDEX_MULTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
DRAW_MULT = 0x632BE59B
BLOCK_STRIDE = 1000003
BLOCK = {"attn": 8, "ffn": 4}


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & U32


def _index(shape, device) -> torch.Tensor:
    idx = torch.zeros(shape, dtype=torch.int64, device=device)
    for d, n in enumerate(shape):
        view = [1] * len(shape)
        view[d] = n
        iota = torch.arange(n, dtype=torch.int64, device=device).reshape(view)
        idx = (idx + _mul32(iota, INDEX_MULTS[d % 4])) & U32
    return idx


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _block_bits(seed: int, draw: int, block_shape, n_blocks: int, device) -> torch.Tensor:
    seeds = (int(seed) + torch.arange(n_blocks, dtype=torch.int64, device=device) * BLOCK_STRIDE) & U32
    seeds = seeds.reshape(n_blocks, *([1] * len(block_shape)))
    return _fmix(_index(tuple(block_shape), device)[None] ^ seeds ^ ((draw * DRAW_MULT) & U32))


def _cutoff(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def block_size(kind: str, b: int) -> int:
    block = min(BLOCK[kind], b)
    while b % block:
        block -= 1
    return block


def hidden_keep(seed: int, rate: float, b: int, s: int, h: int, kind: str, device) -> torch.Tensor:
    """[B, S, H] keep mask of a block's hidden dropout."""
    block = block_size(kind, b)
    bits = _block_bits(seed, 0, (block * s, h), b // block, device)
    return (bits >= _cutoff(rate)).reshape(b, s, h)


def probs_keep(seed: int, rate: float, b: int, heads: int, s: int, device) -> torch.Tensor:
    """[B, heads, S, S] keep mask of the attention probabilities."""
    block = block_size("attn", b)
    return torch.stack([(_block_bits(seed, 1 + i, (block, s, s), b // block, device) >= _cutoff(rate)).reshape(b, s, s)
                        for i in range(heads)], dim=1)


def step_draws(step_seed: int, layers: int, emb_shape, rate: float, device) -> tuple[list, torch.Tensor]:
    """-> ([(attention seed, FFN seed)] per layer, the embedding keep mask)."""
    gen = torch.Generator(device=device).manual_seed(step_seed)
    seeds = torch.randint(-2**31, 2**31 - 1, (layers, 2), generator=gen, device=gen.device).tolist()
    keep = torch.rand(emb_shape, generator=gen, device=device) < 1.0 - rate
    return seeds, keep
