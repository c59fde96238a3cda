// Attention of one head by one warp on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 sums), shared by attn_core.cu and mha.cu: the cp.async,
// ldmatrix and mma helpers, the key-bias fragments, and the routine in which a
// warp walks its head's queries 16 rows at a time over keys and values staged
// in shared memory.
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

// One warp: for the query rows [0, qp) of one head,
//   ctx = bf16( bf16(softmax(q k^T * scale + bias)) @ v ),
// each 16-row tile's context written back over its (consumed) q rows. q, k, v
// point at the head's column 0 in shared memory, rows LD elements apart (LD * 2
// bytes a multiple of 16); qp and kp are multiples of 16, and the k and v rows
// past the keys are zero. Before each tile's products the routine calls
// bias.load(m0) (tile rows m0..m0+15); score element e of key tile j (rows
// m0 + g + 8 * (e / 2), key 8j + 2t + e % 2, the accumulator's order) then
// gets bias(j, e) added, which must be -inf for a key past the last.
template <int LD, typename Bias>
__device__ __forceinline__ void attend(__nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, int qp,
                                       int kp, float scale, Bias& bias) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // the fragments' row and column pair
  for (int m0 = 0; m0 < qp; m0 += 16) {
    bias.load(m0);
    uint32_t qa[DH / 16][4];  // the A fragments of the 16 query rows, k = head dim
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) ldmatrix_x4(qa[kk], q + (m0 + lane % 16) * LD + kk * 16 + 8 * (lane / 16));
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {  // keys [16 jp, 16 jp + 16): two n8 tiles
      if (16 * jp < kp) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {  // head dim ascending, 16 at a time
          uint32_t kf[4];
          ldmatrix_x4(kf, k + (16 * jp + lane % 8 + 8 * (lane / 16)) * LD + kk * 16 + 8 * ((lane / 8) % 2));
          mma16816(s[2 * jp], qa[kk], kf[0], kf[1]);
          mma16816(s[2 * jp + 1], qa[kk], kf[2], kf[3]);
        }
      }
    }
    // softmax of rows g (elements 0, 1) and g + 8 (elements 2, 3), each spread over a quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = s[j][e] * scale + bias(j, e);
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float sum[2] = {0.0f, 0.0f};
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
    // ctx = bf16(probs) @ V, keys ascending 16 at a time
    float o[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
      if (16 * kt < kp) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kt][0] / sum[0], s[2 * kt][1] / sum[0]),
                                pack_bf16(s[2 * kt][2] / sum[1], s[2 * kt][3] / sum[1]),
                                pack_bf16(s[2 * kt + 1][0] / sum[0], s[2 * kt + 1][1] / sum[0]),
                                pack_bf16(s[2 * kt + 1][2] / sum[1], s[2 * kt + 1][3] / sum[1])};
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v + (16 * kt + lane % 8 + 8 * ((lane / 8) % 2)) * LD + np * 16 + 8 * (lane / 16));
          mma16816(o[2 * np], pa, vf[0], vf[1]);
          mma16816(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncwarp();  // every lane's q fragments are loaded: the rows take the context
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(q + (m0 + g + 8 * h) * LD + 8 * j + 2 * t) = pack_bf16(o[j][2 * h], o[j][2 * h + 1]);
  }
}

}  // namespace warp_attention
