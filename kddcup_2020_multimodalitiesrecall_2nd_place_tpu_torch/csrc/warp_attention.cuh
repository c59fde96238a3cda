// Attention of one head by one warp on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 sums), shared by attn_core.cu, mha.cu and attn_train.cu: the
// cp.async, ldmatrix and mma helpers, the bias fragments (a key-only bias
// and one over (query, key)), the tile steps
// (A fragments of 16 rows, a 16-row product against the rows of another
// operand, the softmax of a 16-row score tile, one k16 slice of a product with
// a row-major B operand), and the routine in which a warp walks its head's
// queries 16 rows at a time over keys and values staged in shared memory.
//
// Rounding points (those of the Pallas bodies): f32 scores x scale, + bias,
// f32 softmax, probs -> bf16, f32 PV accumulation, context -> bf16. A row of
// scores lives in the four lanes of a quad of the accumulator fragments, so
// the softmax runs in registers; two n8 score tiles are the A fragment of one
// k16 slice of PV, so the probs never touch shared memory.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace warp_attention {

constexpr int DH = 64, MAX_S = 64;
constexpr int NT = MAX_S / 8;  // n8 key tiles of a score row at most

__host__ __device__ inline int pad16(int s) { return (s + 15) & ~15; }

// 16 bytes global -> shared, or 16 zero bytes where !pred (gmem must still be a valid address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(pred ? 16 : 0));
}
// this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// d[16 x 8] += a[16 x 16] @ b[16 x 8], bf16 in, f32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// A bias that depends on the key only (none, or a key mask): this lane's score
// columns 8j + 2t + c, read once; keys past sk -inf.
struct KeyBias {
  float kb[NT][2];
  // row: the key biases at element stride `stride`, or null for none
  __device__ __forceinline__ KeyBias(const float* row, long long stride, int sk) {
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = 8 * j + 2 * t + c;
        kb[j][c] = key >= sk ? -INFINITY : row != nullptr ? row[key * stride] : 0.0f;
      }
  }
  __device__ __forceinline__ void load(int) {}
  __device__ __forceinline__ float operator()(int j, int e) const { return kb[j][e % 2]; }
};

// A bias over (query, key) (mha.cu's [B,1,S,S] and [B,N,S,S] biases, attn_core.cu's
// full [B, Sq, Sk] one): this lane's elements of each 16-row tile, read from global
// memory at the tile's start; keys past sk -inf, query rows past sq 0.
struct QueryKeyBias {
  const float* p;  // the head's bias at (query, key) element strides rs, ks
  long long rs, ks;
  int sq, sk, g, t;
  bool paired;  // ks == 1 and every (row, even key) pair 8-byte aligned
  float add[NT][4];

  __device__ __forceinline__ QueryKeyBias(const float* p_, long long rs_, long long ks_, int sq_, int sk_)
      : p(p_), rs(rs_), ks(ks_), sq(sq_), sk(sk_), g(threadIdx.x % 32 / 4), t(threadIdx.x % 4) {
    paired = ks == 1 && rs % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 8 == 0;
  }
  __device__ __forceinline__ void load(int m0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + g + 8 * h;
      const float* row = p + r * rs;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int key = 8 * j + 2 * t;
        float lo = -INFINITY, hi = -INFINITY;
        if (r >= sq) {
          lo = key < sk ? 0.0f : -INFINITY;
          hi = key + 1 < sk ? 0.0f : -INFINITY;
        } else if (paired && key + 1 < sk) {
          const float2 two = *reinterpret_cast<const float2*>(row + key);
          lo = two.x;
          hi = two.y;
        } else {
          if (key < sk) lo = row[key * ks];
          if (key + 1 < sk) hi = row[(key + 1) * ks];
        }
        add[j][2 * h] = lo;
        add[j][2 * h + 1] = hi;
      }
    }
  }
  __device__ __forceinline__ float operator()(int j, int e) const { return add[j][e]; }
};

// The identity on each probability: attn_core's and mha's. attend() hands
// every probability to such a functor, with its place (m0, j, e), before the
// probability is rounded into PV's A fragment.
struct Probs {
  __device__ __forceinline__ float operator()(int, int, int, float p) const { return p; }
};

// a: the A fragments of rows [m0, m0 + 16) x 64 of a row-major tile (rows LD apart), k = the 64 columns
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4], const __nv_bfloat16* rows, int m0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) ldmatrix_x4(a[kk], rows + (m0 + lane % 16) * LD + kk * 16 + 8 * (lane / 16));
}

// s = a @ b^T: the 16 rows of a against rows [0, np) of b (np a multiple of 16), the 64 columns ascending
// 16 at a time; n8 tile j holds b's rows 8j..8j+7, and the tiles past np stay 0
template <int LD>
__device__ __forceinline__ void mma_abt(float (&s)[NT][4], const uint32_t (&a)[DH / 16][4], const __nv_bfloat16* b,
                                        int np) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {  // rows [16 jp, 16 jp + 16) of b: two n8 tiles
    if (16 * jp < np) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b + (16 * jp + lane % 8 + 8 * (lane / 16)) * LD + kk * 16 + 8 * ((lane / 8) % 2));
        mma16816(s[2 * jp], a[kk], bf[0], bf[1]);
        mma16816(s[2 * jp + 1], a[kk], bf[2], bf[3]);
      }
    }
  }
}

// The softmax of rows g (elements 0, 1) and g + 8 (elements 2, 3) of a 16-row score tile, each row spread
// over a quad: s <- exp(s * scale + bias(j, e) - the row's max), sum <- the rows' sums of it
template <typename Bias>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float scale, const Bias& bias, float (&sum)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = s[j][e] * scale + bias(j, e);
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  sum[0] = sum[1] = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - mx[e / 2]);  // 0 past the keys
      sum[e / 2] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], o);
  }
}

// o += pa @ b[16 kt .. 16 kt + 16, 0..64): one k16 slice of a product whose B operand is row-major
// (rows LD apart, k = its rows), through ldmatrix.trans; pa is the slice's A fragment
template <int LD>
__device__ __forceinline__ void mma_slice(float (&o)[DH / 8][4], const uint32_t (&pa)[4], const __nv_bfloat16* b,
                                          int kt) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int np = 0; np < DH / 16; ++np) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, b + (16 * kt + lane % 8 + 8 * ((lane / 8) % 2)) * LD + np * 16 + 8 * (lane / 16));
    mma16816(o[2 * np], pa, bf[0], bf[1]);
    mma16816(o[2 * np + 1], pa, bf[2], bf[3]);
  }
}

// The 16 x 64 accumulator tile o, rounded to bf16, over rows [m0, m0 + 16) of a row-major tile
template <int LD>
__device__ __forceinline__ void store_tile(__nv_bfloat16* rows, int m0, const float (&o)[DH / 8][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(rows + (m0 + g + 8 * h) * LD + 8 * j + 2 * t) = pack_bf16(o[j][2 * h], o[j][2 * h + 1]);
}

// One warp: for the query rows [0, qp) of one head,
//   ctx = bf16( bf16(prob(softmax(q k^T * scale + bias))) @ v ),
// each 16-row tile's context written back over its (consumed) q rows. q, k, v
// point at the head's column 0 in shared memory, rows LD elements apart (LD * 2
// bytes a multiple of 16); qp and kp are multiples of 16, and the k and v rows
// past the keys are zero. Before each tile's products the routine calls
// bias.load(m0) (tile rows m0..m0+15); score element e of key tile j (rows
// m0 + g + 8 * (e / 2), key 8j + 2t + e % 2, the accumulator's order) then
// gets bias(j, e) added, which must be -inf for a key past the last, and its
// probability p becomes prob(m0, j, e, p) before it is rounded to bf16.
template <int LD, typename Bias, typename Prob = Probs>
__device__ __forceinline__ void attend(__nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, int qp,
                                       int kp, float scale, Bias& bias, const Prob& prob = Prob()) {
  for (int m0 = 0; m0 < qp; m0 += 16) {
    bias.load(m0);
    uint32_t qa[DH / 16][4];  // the A fragments of the 16 query rows, k = head dim
    load_a<LD>(qa, q, m0);
    float s[NT][4];
    mma_abt<LD>(s, qa, k, kp);
    float sum[2];
    softmax_tile(s, scale, bias, sum);
    // ctx = bf16(probs) @ V, keys ascending 16 at a time
    float o[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
      if (16 * kt < kp) {
        const int j0 = 2 * kt, j1 = 2 * kt + 1;
        const uint32_t pa[4] = {pack_bf16(prob(m0, j0, 0, s[j0][0] / sum[0]), prob(m0, j0, 1, s[j0][1] / sum[0])),
                                pack_bf16(prob(m0, j0, 2, s[j0][2] / sum[1]), prob(m0, j0, 3, s[j0][3] / sum[1])),
                                pack_bf16(prob(m0, j1, 0, s[j1][0] / sum[0]), prob(m0, j1, 1, s[j1][1] / sum[0])),
                                pack_bf16(prob(m0, j1, 2, s[j1][2] / sum[1]), prob(m0, j1, 3, s[j1][3] / sum[1]))};
        mma_slice<LD>(o, pa, v, kt);
      }
    }
    __syncwarp();  // every lane's q fragments are loaded: the rows take the context
    store_tile<LD>(q, m0, o);
  }
}

}  // namespace warp_attention
