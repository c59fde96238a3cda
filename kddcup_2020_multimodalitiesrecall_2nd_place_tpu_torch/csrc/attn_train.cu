// Per-head attention core of the training self-attention block, with the
// attention-probability dropout, forward and backward. For pair b, head h:
//   probs  = softmax(Q_h K_h^T / sqrt(64) + key_bias[b])            (f32)
//   probsd = bf16(keep ? probs * scale : 0)
//   forward   ctx[b, :, h] = bf16(probsd @ V_h)
//   backward  (dctx_h = dctx[b, :, h], bf16)
//     dV_h     = bf16(probsd^T @ dctx_h)
//     dprobs   = keep ? (dctx_h @ V_h^T) * scale : 0                 (f32)
//     ds       = bf16(probs * (dprobs - rowsum(dprobs * probs)) / sqrt(64))
//     dQ_h     = bf16(ds @ K_h),  dK_h = bf16(ds^T @ Q_h)
// with Q, K, V at columns 0, H, 2H of the [B*S, 3H] QKV buffer and dQ, dK, dV
// written to the same columns of dqkv [B*S, 3H]. The keep bits are head h's
// draw (1 + h) of dropout_hash.cuh: grid block j = b / block, element
// (b % block, query, key).
//
// Replaces the per-head attention of _attn_fwd_kernel and _attn_bwd_kernel
// (ops/pallas_train.py:548-576, :607-622, :753-770, :811-849), with their
// rounding points: f32 scores, softmax, dprobs and the softmax backward;
// probsd, ctx, ds, dq, dk, dv -> bf16. The TPU packs heads into 128-lane
// tiles (headpack); its masks are drawn per head in every variant, and here
// every head is a CTA of its own.
//
// Design: one CTA of 128 threads per (head, pair), as attn_core.cu. q, k, v
// (and in the backward dctx_h) live in shared memory as f32, with the [S, S]
// score tiles beside them (forward 38 KB at S = 40, backward 61 KB); every
// product runs as 4x4 register tiles on the CUDA cores. At S = 40 these
// products are ~2% of a block's FLOPs, so the kernel is bound by bytes (qkv,
// dctx in; ctx or dqkv out), not by the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int DH = 64, THREADS = 128, MAX_S = 64;
constexpr int LD = DH + 1;  // odd stride: lanes reading different rows hit different banks
constexpr float SCALE = 0.125f;  // 1 / sqrt(64)

__host__ __device__ inline int padded(int s) { return (s + 3) & ~3; }

struct Args {
  const __nv_bfloat16* qkv;  // [B*S, 3H]
  const float* key_bias;     // [B, S] or null
  const __nv_bfloat16* dctx; // [B*S, H] (backward)
  __nv_bfloat16* out;        // ctx [B*S, H] (forward) or dqkv [B*S, 3H] (backward)
  int S, H, block;
  uint32_t seed, cutoff;
  float scale;
  int on;
};

__device__ inline void load_rows(float* dst, const __nv_bfloat16* src, int ld_src, int rows, int rows_padded,
                                 int tid) {
  for (int idx = tid; idx < rows_padded * (DH / 8); idx += THREADS) {
    const int r = idx / (DH / 8), c8 = (idx % (DH / 8)) * 8;
    float vals[8];
    if (r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * ld_src + c8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = __bfloat162float(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[r * LD + c8 + i] = vals[i];
  }
}

// p[r, c] = sum_e a[r, e] * b[c, e] (rows of a and b at stride LD), 4x4 tiles over [P x P]
__device__ inline void tile_abt(const float* a, const float* b, float (&acc)[4][4], int rg, int cg) {
  for (int e = 0; e < DH; ++e) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(rg * 4 + i) * LD + e];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(cg * 4 + j) * LD + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[r, d] for r in rows rg*4.., d in dg*4..: sum_c m(r, c) * v[c, d] over c < n, where
// m(r, c) = mat[r * P + c] (trans = false) or mat[c * P + r] (trans = true), v rows at stride LD
template <bool TRANS>
__device__ inline void tile_mv(const float* mat, int P, const float* v, int n, float (&acc)[4][4], int rg, int dg) {
  for (int c = 0; c < n; ++c) {
    float vv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = v[c * LD + dg * 4 + j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const float m = TRANS ? mat[c * P + r] : mat[r * P + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(m, vv[j], acc[i][j]);
    }
  }
}

__device__ inline void store_tile(__nv_bfloat16* dst, int ld, const float (&acc)[4][4], int rg, int dg, int rows) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r < rows) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + (size_t)r * ld + dg * 4) = packed;
    }
  }
}

__device__ __forceinline__ uint32_t head_salt(const Args& a, int b, int h) {
  return kmr_dropout::salt(kmr_dropout::block_seed(a.seed, static_cast<uint32_t>(b / a.block)),
                           static_cast<uint32_t>(1 + h));
}

// scores of pair b, head h into p [P x P] (q, k in shared memory), then one warp per row: the softmax
// probs into p and, if probsd is given, bf16(keep ? probs * scale : 0) into probsd
__device__ inline void probs_rows(const Args& a, const float* q, const float* k, float* p, float* probsd, int b,
                                  int h, int tid) {
  const int S = a.S, P = padded(S), G = P / 4;
  for (int item = tid; item < G * G; item += THREADS) {
    const int rg = item / G, cg = item % G;
    float acc[4][4] = {};
    tile_abt(q, k, acc, rg, cg);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cg * 4 + j;
      const float kb = (a.key_bias != nullptr && c < S) ? a.key_bias[(size_t)b * S + c] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) p[(rg * 4 + i) * P + c] = acc[i][j] * SCALE + kb;
    }
  }
  __syncthreads();
  const uint32_t salted = head_salt(a, b, h);
  const uint32_t local = static_cast<uint32_t>(b % a.block);
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < S; r += THREADS / 32) {
    const float s0 = lane < S ? p[r * P + lane] : -INFINITY;
    const float s1 = lane + 32 < S ? p[r * P + lane + 32] : -INFINITY;
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = lane < S ? expf(s0 - m) : 0.0f;
    const float e1 = lane + 32 < S ? expf(s1 - m) : 0.0f;
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half;
      if (c < S) {
        const float pr = (half ? e1 : e0) / sum;
        p[r * P + c] = pr;
        if (probsd != nullptr) {
          const bool keep = !a.on || kmr_dropout::bits3(salted, local, r, c) >= a.cutoff;
          const float pd = a.on ? (keep ? __fmul_rn(pr, a.scale) : 0.0f) : pr;
          probsd[r * P + c] = __bfloat162float(__float2bfloat16(pd));
        }
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) attn_train_fwd_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int S = a.S, P = padded(S), H = a.H, G = P / 4;
  float* q = sm;
  float* k = q + P * LD;
  float* v = k + P * LD;
  float* p = v + P * LD;   // probs
  float* pd = p + P * P;   // bf16(dropped probs)
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const __nv_bfloat16* base = a.qkv + (size_t)b * S * 3 * H + h * DH;
  load_rows(q, base, 3 * H, S, P, tid);
  load_rows(k, base + H, 3 * H, S, P, tid);
  load_rows(v, base + 2 * H, 3 * H, S, P, tid);
  for (int idx = tid; idx < P * P; idx += THREADS) pd[idx] = 0.0f;  // padded keys stay 0
  __syncthreads();
  probs_rows(a, q, k, p, pd, b, h, tid);
  for (int item = tid; item < G * (DH / 4); item += THREADS) {
    const int rg = item / (DH / 4), dg = item % (DH / 4);
    float acc[4][4] = {};
    tile_mv<false>(pd, P, v, S, acc, rg, dg);
    store_tile(a.out + (size_t)b * S * H + h * DH, H, acc, rg, dg, S);
  }
}

__global__ void __launch_bounds__(THREADS) attn_train_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int S = a.S, P = padded(S), H = a.H, G = P / 4;
  float* q = sm;
  float* k = q + P * LD;
  float* v = k + P * LD;
  float* dc = v + P * LD;  // dctx_h
  float* p = dc + P * LD;  // probs
  float* pd = p + P * P;   // bf16(dropped probs)
  float* ds = pd + P * P;  // dprobs, then bf16(ds)
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  const __nv_bfloat16* base = a.qkv + (size_t)b * S * 3 * H + h * DH;
  load_rows(q, base, 3 * H, S, P, tid);
  load_rows(k, base + H, 3 * H, S, P, tid);
  load_rows(v, base + 2 * H, 3 * H, S, P, tid);
  load_rows(dc, a.dctx + (size_t)b * S * H + h * DH, H, S, P, tid);
  for (int idx = tid; idx < P * P; idx += THREADS) pd[idx] = ds[idx] = 0.0f;  // padded entries stay 0
  __syncthreads();
  probs_rows(a, q, k, p, pd, b, h, tid);

  __nv_bfloat16* dqkv = a.out + (size_t)b * S * 3 * H + h * DH;
  // dV = probsd^T @ dctx_h
  for (int item = tid; item < G * (DH / 4); item += THREADS) {
    const int cg = item / (DH / 4), dg = item % (DH / 4);
    float acc[4][4] = {};
    tile_mv<true>(pd, P, dc, S, acc, cg, dg);
    store_tile(dqkv + 2 * H, 3 * H, acc, cg, dg, S);
  }
  // dprobs = keep ? (dctx_h @ V^T) * scale : 0
  const uint32_t salted = head_salt(a, b, h);
  const uint32_t local = static_cast<uint32_t>(b % a.block);
  for (int item = tid; item < G * G; item += THREADS) {
    const int rg = item / G, cg = item % G;
    float acc[4][4] = {};
    tile_abt(dc, v, acc, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg * 4 + i, c = cg * 4 + j;
        if (r < S && c < S) {
          const bool keep = !a.on || kmr_dropout::bits3(salted, local, r, c) >= a.cutoff;
          ds[r * P + c] = a.on ? (keep ? __fmul_rn(acc[i][j], a.scale) : 0.0f) : acc[i][j];
        }
      }
  }
  __syncthreads();
  // ds = bf16(probs * (dprobs - rowsum(dprobs * probs)) * 1/sqrt(64)), one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < S; r += THREADS / 32) {
    float part = 0.0f;
    for (int c = lane; c < S; c += 32) part += ds[r * P + c] * p[r * P + c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    for (int c = lane; c < S; c += 32) {
      const float g = __fmul_rn(p[r * P + c], ds[r * P + c] - part) * SCALE;
      ds[r * P + c] = __bfloat162float(__float2bfloat16(g));
    }
  }
  __syncthreads();
  // dQ = ds @ K, dK = ds^T @ Q
  for (int item = tid; item < 2 * G * (DH / 4); item += THREADS) {
    const bool is_k = item >= G * (DH / 4);
    const int it = is_k ? item - G * (DH / 4) : item;
    const int rg = it / (DH / 4), dg = it % (DH / 4);
    float acc[4][4] = {};
    if (is_k) {
      tile_mv<true>(ds, P, q, S, acc, rg, dg);
      store_tile(dqkv + H, 3 * H, acc, rg, dg, S);
    } else {
      tile_mv<false>(ds, P, k, S, acc, rg, dg);
      store_tile(dqkv, 3 * H, acc, rg, dg, S);
    }
  }
}

int launch(bool backward, const void* qkv, const void* key_bias, const void* dctx, void* out, int B, int S, int H,
           int num_heads, int block, int seed, unsigned cutoff, float scale, int on, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || S > MAX_S || H != num_heads * DH || block < 1 || B % block != 0)
    return cudaErrorInvalidValue;
  const int P = padded(S);
  const int floats = backward ? 4 * P * LD + 3 * P * P : 3 * P * LD + 2 * P * P;
  const int bytes = floats * 4;
  auto kernel = backward ? attn_train_bwd_kernel : attn_train_fwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(key_bias),
               static_cast<const __nv_bfloat16*>(dctx), static_cast<__nv_bfloat16*>(out), S, H, block,
               static_cast<uint32_t>(seed), static_cast<uint32_t>(cutoff), scale, on};
  kernel<<<dim3(num_heads, B), THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int kmr_attn_train_max_seq() { return MAX_S; }
int kmr_attn_train_head_dim() { return DH; }

// qkv [B*S, 3H] bf16, key_bias [B, S] f32 or null -> ctx [B*S, H] bf16. Dropout (on != 0): a unit is
// kept iff its bits >= cutoff, kept probabilities scaled by `scale`; `seed` seeds grid block 0 of
// `block` pairs (B a multiple of block).
int kmr_attn_train_fwd(const void* qkv, const void* key_bias, void* ctx, int B, int S, int H, int num_heads,
                       int block, int seed, unsigned cutoff, float scale, int on, void* stream) {
  return launch(false, qkv, key_bias, nullptr, ctx, B, S, H, num_heads, block, seed, cutoff, scale, on, stream);
}

// as the forward, plus dctx [B*S, H] bf16 -> dqkv [B*S, 3H] bf16 (dq, dk, dv at columns 0, H, 2H).
int kmr_attn_train_bwd(const void* qkv, const void* key_bias, const void* dctx, void* dqkv, int B, int S, int H,
                       int num_heads, int block, int seed, unsigned cutoff, float scale, int on, void* stream) {
  return launch(true, qkv, key_bias, dctx, dqkv, B, S, H, num_heads, block, seed, cutoff, scale, on, stream);
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
