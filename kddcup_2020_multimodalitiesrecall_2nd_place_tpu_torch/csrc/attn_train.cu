// Per-head attention core of the training attention blocks, with the
// attention-probability dropout, forward and backward: self-attention (the
// train self-attention block) and cross attention (the train cross block of
// the LXMERT x-layers, F queries against T keys). For pair b, head h:
//   probs  = softmax(Q_h K_h^T / sqrt(64) + key_bias[b])            (f32, [F, T])
//   probsd = bf16(keep ? probs * scale : 0)
//   forward   ctx[b, :, h] = bf16(probsd @ V_h)
//   backward  (dctx_h = dctx[b, :, h], bf16)
//     dV_h     = bf16(probsd^T @ dctx_h)
//     dprobs   = keep ? (dctx_h @ V_h^T) * scale : 0                 (f32)
//     ds       = bf16(probs * (dprobs - rowsum(dprobs * probs)) / sqrt(64))
//     dQ_h     = bf16(ds @ K_h),  dK_h = bf16(ds^T @ Q_h)
// One strided entry point per direction serves both: self-attention reads
// Q, K, V at columns 0, H, 2H of the [B*S, 3H] QKV buffer and writes dQ, dK,
// dV to the same columns of dqkv [B*S, 3H]; cross attention reads Q from
// q [B*F, H] and K, V at columns 0, H of kv [B*T, 2H], and writes dq [B*F, H]
// and dK, dV to the same columns of dkv [B*T, 2H].
// The keep bits are head h's draw (1 + h) of dropout_hash.cuh: grid block
// j = b / block, element (b % block, query, key) of its [block, F, T] draw.
//
// Replaces the per-head attention of _attn_fwd_kernel and _attn_bwd_kernel
// (ops/pallas_train.py:548-576, :607-622, :753-770, :811-849) and of
// _cross_fwd_kernel and _cross_bwd_kernel (:1041-1067, :1101-1115,
// :1213-1247), with their rounding points: f32 scores, softmax, dprobs and
// the softmax backward; probsd, ctx, ds, dq, dk, dv -> bf16. The TPU packs
// heads into 128-lane tiles (headpack); its masks are drawn per head in
// every variant, and here every head is a CTA of its own.
//
// Design: one CTA of 128 threads per (head, pair), as attn_core.cu. q, k, v
// (and in the backward dctx_h) live in shared memory as f32, with the
// [F, T] score tiles beside them (queries and keys padded to 4 each; at
// F = T = 40 forward 38 KB, backward 61 KB); every product runs as 4x4
// register tiles on the CUDA cores. These products are ~2% of a block's
// FLOPs, so the kernel is bound by bytes (q, kv, dctx in; ctx or dq, dkv
// out), not by the tensor cores.

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
  const __nv_bfloat16* q;     // [B*Sq] rows at stride ldq
  const __nv_bfloat16* k;     // [B*Sk] rows at stride ldkv
  const __nv_bfloat16* v;     // [B*Sk] rows at stride ldkv
  const float* key_bias;      // [B, Sk] or null
  const __nv_bfloat16* dctx;  // [B*Sq, H] (backward)
  __nv_bfloat16* out;         // ctx [B*Sq, H] (forward) or dq (backward), rows at stride ldo
  __nv_bfloat16* dk;          // backward: dK, dV rows at stride lddkv
  __nv_bfloat16* dv;
  int Sq, Sk, H, ldq, ldkv, ldo, lddkv, block;
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

// p[r, c] = sum_e a[r, e] * b[c, e] (rows of a and b at stride LD), one 4x4 tile
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

// scores of pair b, head h into p [Pq x Pk] (q, k in shared memory), then one warp per query row: the
// softmax probs into p and, if probsd is given, bf16(keep ? probs * scale : 0) into probsd
__device__ inline void probs_rows(const Args& a, const float* q, const float* k, float* p, float* probsd, int b,
                                  int h, int tid) {
  const int Sq = a.Sq, Sk = a.Sk, Pk = padded(Sk), Gq = padded(Sq) / 4, Gk = Pk / 4;
  for (int item = tid; item < Gq * Gk; item += THREADS) {
    const int rg = item / Gk, cg = item % Gk;
    float acc[4][4] = {};
    tile_abt(q, k, acc, rg, cg);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cg * 4 + j;
      const float kb = (a.key_bias != nullptr && c < Sk) ? a.key_bias[(size_t)b * Sk + c] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) p[(rg * 4 + i) * Pk + c] = acc[i][j] * SCALE + kb;
    }
  }
  __syncthreads();
  const uint32_t salted = head_salt(a, b, h);
  const uint32_t local = static_cast<uint32_t>(b % a.block);
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < Sq; r += THREADS / 32) {
    const float s0 = lane < Sk ? p[r * Pk + lane] : -INFINITY;
    const float s1 = lane + 32 < Sk ? p[r * Pk + lane + 32] : -INFINITY;
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = lane < Sk ? expf(s0 - m) : 0.0f;
    const float e1 = lane + 32 < Sk ? expf(s1 - m) : 0.0f;
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half;
      if (c < Sk) {
        const float pr = (half ? e1 : e0) / sum;
        p[r * Pk + c] = pr;
        if (probsd != nullptr) {
          const bool keep = !a.on || kmr_dropout::bits3(salted, local, r, c) >= a.cutoff;
          const float pd = a.on ? (keep ? __fmul_rn(pr, a.scale) : 0.0f) : pr;
          probsd[r * Pk + c] = __bfloat162float(__float2bfloat16(pd));
        }
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) attn_train_fwd_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int Sq = a.Sq, Sk = a.Sk, Pq = padded(Sq), Pk = padded(Sk);
  float* q = sm;
  float* k = q + Pq * LD;
  float* v = k + Pk * LD;
  float* p = v + Pk * LD;   // probs
  float* pd = p + Pq * Pk;  // bf16(dropped probs)
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  load_rows(q, a.q + (size_t)b * Sq * a.ldq + h * DH, a.ldq, Sq, Pq, tid);
  load_rows(k, a.k + (size_t)b * Sk * a.ldkv + h * DH, a.ldkv, Sk, Pk, tid);
  load_rows(v, a.v + (size_t)b * Sk * a.ldkv + h * DH, a.ldkv, Sk, Pk, tid);
  for (int idx = tid; idx < Pq * Pk; idx += THREADS) pd[idx] = 0.0f;  // padded keys stay 0
  __syncthreads();
  probs_rows(a, q, k, p, pd, b, h, tid);
  for (int item = tid; item < (Pq / 4) * (DH / 4); item += THREADS) {
    const int rg = item / (DH / 4), dg = item % (DH / 4);
    float acc[4][4] = {};
    tile_mv<false>(pd, Pk, v, Sk, acc, rg, dg);
    store_tile(a.out + (size_t)b * Sq * a.ldo + h * DH, a.ldo, acc, rg, dg, Sq);
  }
}

__global__ void __launch_bounds__(THREADS) attn_train_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int Sq = a.Sq, Sk = a.Sk, Pq = padded(Sq), Pk = padded(Sk), H = a.H, Gq = Pq / 4, Gk = Pk / 4;
  float* q = sm;
  float* k = q + Pq * LD;
  float* v = k + Pk * LD;
  float* dc = v + Pk * LD;  // dctx_h
  float* p = dc + Pq * LD;  // probs
  float* pd = p + Pq * Pk;  // bf16(dropped probs)
  float* ds = pd + Pq * Pk; // dprobs, then bf16(ds)
  const int tid = threadIdx.x, h = blockIdx.x, b = blockIdx.y;
  load_rows(q, a.q + (size_t)b * Sq * a.ldq + h * DH, a.ldq, Sq, Pq, tid);
  load_rows(k, a.k + (size_t)b * Sk * a.ldkv + h * DH, a.ldkv, Sk, Pk, tid);
  load_rows(v, a.v + (size_t)b * Sk * a.ldkv + h * DH, a.ldkv, Sk, Pk, tid);
  load_rows(dc, a.dctx + (size_t)b * Sq * H + h * DH, H, Sq, Pq, tid);
  for (int idx = tid; idx < Pq * Pk; idx += THREADS) pd[idx] = ds[idx] = 0.0f;  // padded entries stay 0
  __syncthreads();
  probs_rows(a, q, k, p, pd, b, h, tid);

  __nv_bfloat16* dq = a.out + (size_t)b * Sq * a.ldo + h * DH;
  __nv_bfloat16* dk = a.dk + (size_t)b * Sk * a.lddkv + h * DH;
  __nv_bfloat16* dv = a.dv + (size_t)b * Sk * a.lddkv + h * DH;
  // dV = probsd^T @ dctx_h
  for (int item = tid; item < Gk * (DH / 4); item += THREADS) {
    const int cg = item / (DH / 4), dg = item % (DH / 4);
    float acc[4][4] = {};
    tile_mv<true>(pd, Pk, dc, Sq, acc, cg, dg);
    store_tile(dv, a.lddkv, acc, cg, dg, Sk);
  }
  // dprobs = keep ? (dctx_h @ V^T) * scale : 0
  const uint32_t salted = head_salt(a, b, h);
  const uint32_t local = static_cast<uint32_t>(b % a.block);
  for (int item = tid; item < Gq * Gk; item += THREADS) {
    const int rg = item / Gk, cg = item % Gk;
    float acc[4][4] = {};
    tile_abt(dc, v, acc, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg * 4 + i, c = cg * 4 + j;
        if (r < Sq && c < Sk) {
          const bool keep = !a.on || kmr_dropout::bits3(salted, local, r, c) >= a.cutoff;
          ds[r * Pk + c] = a.on ? (keep ? __fmul_rn(acc[i][j], a.scale) : 0.0f) : acc[i][j];
        }
      }
  }
  __syncthreads();
  // ds = bf16(probs * (dprobs - rowsum(dprobs * probs)) * 1/sqrt(64)), one warp per query row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < Sq; r += THREADS / 32) {
    float part = 0.0f;
    for (int c = lane; c < Sk; c += 32) part += ds[r * Pk + c] * p[r * Pk + c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    for (int c = lane; c < Sk; c += 32) {
      const float g = __fmul_rn(p[r * Pk + c], ds[r * Pk + c] - part) * SCALE;
      ds[r * Pk + c] = __bfloat162float(__float2bfloat16(g));
    }
  }
  __syncthreads();
  // dQ = ds @ K (query rows), dK = ds^T @ Q (key rows)
  for (int item = tid; item < (Gq + Gk) * (DH / 4); item += THREADS) {
    const bool is_k = item >= Gq * (DH / 4);
    const int it = is_k ? item - Gq * (DH / 4) : item;
    const int rg = it / (DH / 4), dg = it % (DH / 4);
    float acc[4][4] = {};
    if (is_k) {
      tile_mv<true>(ds, Pk, q, Sq, acc, rg, dg);
      store_tile(dk, a.lddkv, acc, rg, dg, Sk);
    } else {
      tile_mv<false>(ds, Pk, k, Sk, acc, rg, dg);
      store_tile(dq, a.ldo, acc, rg, dg, Sq);
    }
  }
}

int launch(bool backward, Args a, int B, int num_heads, void* stream) {
  if (B < 1 || B > 65535 || a.Sq < 1 || a.Sq > MAX_S || a.Sk < 1 || a.Sk > MAX_S || a.H != num_heads * DH ||
      a.block < 1 || B % a.block != 0 || (a.ldq | a.ldkv | a.ldo | (backward ? a.lddkv : 0)) % 8 != 0)
    return cudaErrorInvalidValue;
  const int Pq = padded(a.Sq), Pk = padded(a.Sk);
  const int floats = backward ? (2 * Pq + 2 * Pk) * LD + 3 * Pq * Pk : (Pq + 2 * Pk) * LD + 2 * Pq * Pk;
  const int bytes = floats * 4;
  auto kernel = backward ? attn_train_bwd_kernel : attn_train_fwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(num_heads, B), THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* key_bias, const void* dctx, void* out,
               void* dk, void* dv, int Sq, int Sk, int H, int ldq, int ldkv, int ldo, int lddkv, int block,
               int seed, unsigned cutoff, float scale, int on) {
  return Args{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(key_bias),
              static_cast<const __nv_bfloat16*>(dctx), static_cast<__nv_bfloat16*>(out),
              static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, ldq, ldkv, ldo, lddkv,
              block, static_cast<uint32_t>(seed), static_cast<uint32_t>(cutoff), scale, on};
}

}  // namespace

extern "C" {

int kmr_attn_train_max_seq() { return MAX_S; }
int kmr_attn_train_head_dim() { return DH; }

// Pair b's Q rows at q + b*Sq*ldq, its K and V rows at k, v + b*Sk*ldkv (bf16, head h at column h*64),
// key_bias [B, Sk] f32 or null -> ctx rows at out + b*Sq*ldo (bf16). Self-attention passes columns 0, H,
// 2H of its [B*S, 3H] QKV buffer (ldq = ldkv = 3H); cross attention q [B*F, H] and columns 0, H of kv
// [B*T, 2H]. Dropout (on != 0): a unit is kept iff its bits >= cutoff, kept probabilities scaled by
// `scale`; `seed` seeds grid block 0 of `block` pairs (B a multiple of block).
int kmr_attn_train_fwd(const void* q, const void* k, const void* v, const void* key_bias, void* out, int B,
                       int Sq, int Sk, int H, int num_heads, int ldq, int ldkv, int ldo, int block, int seed,
                       unsigned cutoff, float scale, int on, void* stream) {
  return launch(false, make_args(q, k, v, key_bias, nullptr, out, nullptr, nullptr, Sq, Sk, H, ldq, ldkv, ldo, 0,
                                 block, seed, cutoff, scale, on), B, num_heads, stream);
}

// as the forward, plus dctx [B*Sq, H] bf16 -> dQ rows at dq (stride ldo) and dK, dV rows at dk, dv (stride
// lddkv), bf16: the QKV buffer's layout for self-attention, dq [B*F, H] and dkv [B*T, 2H] for cross.
int kmr_attn_train_bwd(const void* q, const void* k, const void* v, const void* key_bias, const void* dctx,
                       void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int num_heads, int ldq, int ldkv,
                       int ldo, int lddkv, int block, int seed, unsigned cutoff, float scale, int on,
                       void* stream) {
  return launch(true, make_args(q, k, v, key_bias, dctx, dq, dk, dv, Sq, Sk, H, ldq, ldkv, ldo, lddkv, block, seed,
                                cutoff, scale, on), B, num_heads, stream);
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
