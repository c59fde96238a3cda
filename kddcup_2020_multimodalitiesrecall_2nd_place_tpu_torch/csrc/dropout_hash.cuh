// The dropout hash of the training kernels (ln_train.cu, attn_train.cu): the
// counter hash the JAX package's train kernels draw from in interpret mode,
// _hash_bits (ops/pallas_train.py:75-95), a murmur3 fmix over a per-element
// index, with the grid block folded into the seed (_seed_prng, :117-121).
// The port's plain versions (ops/dropout.py) compute the same bits, so the
// kernels, their plain versions and the JAX package keep the same units.
//
// Grid block j of a launch (``block`` pairs) seeds the hash with
// int32(seed + j * 1000003) and indexes its elements from 0: the hidden draw
// (draw 0) over [block * S, H], head i's probability draw (draw 1 + i) over
// [block, S, S] ([block, F, T] in cross attention). The index does not depend
// on the extents. A unit is kept iff its bits >= the cutoff.

#pragma once

#include <stdint.h>

namespace kmr_dropout {

__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// int32(seed + j * 1000003), as uint32 bits
__device__ __forceinline__ uint32_t block_seed(uint32_t seed, uint32_t j) { return seed + j * 1000003u; }

__device__ __forceinline__ uint32_t salt(uint32_t seed, uint32_t draw) { return seed ^ (draw * 0x632BE59Bu); }

// bits of element (i0, i1) of a 2-D draw, and (i0, i1, i2) of a 3-D one; salt() of the block's seed
__device__ __forceinline__ uint32_t bits2(uint32_t salted, uint32_t i0, uint32_t i1) {
  return fmix((i0 * 0x9E3779B9u + i1 * 0x85EBCA6Bu) ^ salted);
}
__device__ __forceinline__ uint32_t bits3(uint32_t salted, uint32_t i0, uint32_t i1, uint32_t i2) {
  return fmix((i0 * 0x9E3779B9u + i1 * 0x85EBCA6Bu + i2 * 0xC2B2AE35u) ^ salted);
}

}  // namespace kmr_dropout
