// The LayerNorm that closes both training blocks, with the block's hidden
// dropout, forward and backward:
//   forward   y  = bf16(LN(z)),  z = drop(h) + x,  drop(h) = keep ? h * scale : 0
//   backward  z, mean, rstd recomputed from h and x;
//             dz = (g - mean(g) - zn * mean(g * zn)) * rstd,  g = dy * gamma (f32 out)
//             dh = bf16(keep ? dz * scale : 0)
//             dgamma, dbeta: sums of dy * zn and dy over each CTA's rows (partials)
// h [M, H] f32 is the block's projection from gemm_bf16 ("f32" epilogue), x
// [M, H] bf16 its input, dy [M, H] bf16. The keep bits are the hidden draw
// (draw 0) of dropout_hash.cuh: grid block j = row / rows_per_block, element
// (row % rows_per_block, col).
//
// Replaces the dropout + residual + LayerNorm tail of _ffn_fwd_kernel and
// _attn_fwd_kernel, and the recompute + LayerNorm backward of _ffn_bwd_kernel
// and _attn_bwd_kernel (ops/pallas_train.py:189-197, :218-238, :626-634,
// :775-795), with their rounding points: f32 throughout, y, dh -> bf16.
//
// Design: one warp per row, the row in registers as float4s (H = 128 * NVEC,
// NVEC <= 8, a template parameter so the arrays stay in registers), as
// layernorm.cu. The backward's CTA of 8 warps walks 64 rows and keeps each
// lane's dgamma/dbeta sums in registers; the 8 warps' sums meet in shared
// memory and the CTA writes one [H] partial of each, which the caller adds up
// (no atomics: every run sums in the same order).
// Bound on H100: bytes (forward 10, backward 18 bytes a value; ~30 flops).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, MAX_VEC = 8;  // H <= 8 * 128
constexpr int BWD_ROWS = 64;                                      // rows per backward CTA

struct Drop {
  uint32_t seed, cutoff;
  float scale;
  int on, rows_per_block;
};

__device__ __forceinline__ void load_bf16x4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// z = drop(h) + x of one row into registers (lane's columns (i*32 + lane)*4 + e), bit 4i+e of `keep`
// set where that unit is kept; -> the row's mean and rstd
template <int NVEC>
__device__ __forceinline__ void load_z(const float* __restrict__ h, const __nv_bfloat16* __restrict__ x, int row,
                                       const Drop& d, int lane, float z[NVEC][4], uint32_t& keep, float& mean,
                                       float& rstd, float eps) {
  constexpr int H = NVEC * 128;
  const uint32_t salted =
      kmr_dropout::salt(kmr_dropout::block_seed(d.seed, static_cast<uint32_t>(row / d.rows_per_block)), 0u);
  const uint32_t local = static_cast<uint32_t>(row % d.rows_per_block);
  float sum = 0.0f;
  keep = 0u;
#pragma unroll
  for (int i = 0; i < NVEC; ++i) {
    const int col = (i * 32 + lane) * 4;
    const float4 hv = *reinterpret_cast<const float4*>(h + (size_t)row * H + col);
    float xv[4];
    load_bf16x4(x + (size_t)row * H + col, xv);
    const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool k = !d.on || kmr_dropout::bits2(salted, local, static_cast<uint32_t>(col + e)) >= d.cutoff;
      keep |= static_cast<uint32_t>(k) << (4 * i + e);
      const float hd = d.on ? (k ? __fmul_rn(hh[e], d.scale) : 0.0f) : hh[e];
      z[i][e] = __fadd_rn(hd, xv[e]);
      sum += z[i][e];
    }
  }
  mean = warp_sum(sum) / H;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < NVEC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c = z[i][e] - mean;
      sq += c * c;
    }
  rstd = rsqrtf(warp_sum(sq) / H + eps);
}

template <int NVEC>
__global__ void __launch_bounds__(THREADS)
ln_train_fwd_kernel(const float* __restrict__ h, const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    __nv_bfloat16* __restrict__ y, int M, float eps, Drop d) {
  constexpr int H = NVEC * 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= M) return;
  float z[NVEC][4];
  uint32_t keep;
  float mean, rstd;
  load_z<NVEC>(h, x, row, d, lane, z, keep, mean, rstd, eps);
#pragma unroll
  for (int i = 0; i < NVEC; ++i) {
    const int col = (i * 32 + lane) * 4;
    const float4 g = *reinterpret_cast<const float4*>(gamma + col);
    const float4 b = *reinterpret_cast<const float4*>(beta + col);
    const float gg[4] = {g.x, g.y, g.z, g.w}, bb[4] = {b.x, b.y, b.z, b.w};
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = (z[i][e] - mean) * rstd * gg[e] + bb[e];
    store_bf16x4(y + (size_t)row * H + col, out);
  }
}

template <int NVEC>
__global__ void __launch_bounds__(THREADS)
ln_train_bwd_kernel(const float* __restrict__ h, const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ dy, const float* __restrict__ gamma,
                    float* __restrict__ dz_out, __nv_bfloat16* __restrict__ dh_out,
                    float* __restrict__ dgamma_part, float* __restrict__ dbeta_part, int M, float eps, Drop d) {
  constexpr int H = NVEC * 128;
  __shared__ float red[WARPS][H];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc_g[NVEC][4] = {}, acc_b[NVEC][4] = {};
  const int row_end = min(M, (static_cast<int>(blockIdx.x) + 1) * BWD_ROWS);
  for (int row = static_cast<int>(blockIdx.x) * BWD_ROWS + warp; row < row_end; row += WARPS) {
    float z[NVEC][4], gv[NVEC][4];
    uint32_t keep;
    float mean, rstd;
    load_z<NVEC>(h, x, row, d, lane, z, keep, mean, rstd, eps);
    float sum_g = 0.0f, sum_gz = 0.0f;
#pragma unroll
    for (int i = 0; i < NVEC; ++i) {
      const int col = (i * 32 + lane) * 4;
      float dyv[4];
      load_bf16x4(dy + (size_t)row * H + col, dyv);
      const float4 g4 = *reinterpret_cast<const float4*>(gamma + col);
      const float gm[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z[i][e] = (z[i][e] - mean) * rstd;  // zn from here on
        gv[i][e] = dyv[e] * gm[e];
        sum_g += gv[i][e];
        sum_gz += gv[i][e] * z[i][e];
        acc_g[i][e] += dyv[e] * z[i][e];
        acc_b[i][e] += dyv[e];
      }
    }
    const float mean_g = warp_sum(sum_g) / H, mean_gz = warp_sum(sum_gz) / H;
#pragma unroll
    for (int i = 0; i < NVEC; ++i) {
      const int col = (i * 32 + lane) * 4;
      float dzv[4], dhv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dzv[e] = (gv[i][e] - mean_g - z[i][e] * mean_gz) * rstd;
        const bool k = (keep >> (4 * i + e)) & 1u;
        dhv[e] = d.on ? (k ? __fmul_rn(dzv[e], d.scale) : 0.0f) : dzv[e];
      }
      *reinterpret_cast<float4*>(dz_out + (size_t)row * H + col) = make_float4(dzv[0], dzv[1], dzv[2], dzv[3]);
      store_bf16x4(dh_out + (size_t)row * H + col, dhv);
    }
  }
  // the 8 warps' sums per column, dgamma then dbeta through one shared buffer
  float* parts[2] = {dgamma_part, dbeta_part};
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < NVEC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp][(i * 32 + lane) * 4 + e] = which == 0 ? acc_g[i][e] : acc_b[i][e];
    __syncthreads();
    for (int col = threadIdx.x; col < H; col += THREADS) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][col];
      parts[which][(size_t)blockIdx.x * H + col] = s;
    }
    __syncthreads();
  }
}

Drop make_drop(int seed, unsigned cutoff, float scale, int on, int rows_per_block) {
  return Drop{static_cast<uint32_t>(seed), static_cast<uint32_t>(cutoff), scale, on, rows_per_block};
}

bool valid(int M, int H, int rows_per_block) {
  return M > 0 && H % 128 == 0 && H >= 128 && H <= MAX_VEC * 128 && rows_per_block > 0 &&
         M % rows_per_block == 0;
}

template <int NVEC>
cudaError_t launch_fwd(const void* h, const void* x, const void* gamma, const void* beta, void* y, int M,
                       float eps, Drop d, cudaStream_t stream) {
  ln_train_fwd_kernel<NVEC><<<(M + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(y), M, eps, d);
  return cudaGetLastError();
}

template <int NVEC>
cudaError_t launch_bwd(const void* h, const void* x, const void* dy, const void* gamma, void* dz, void* dh,
                       void* dgamma_part, void* dbeta_part, int M, float eps, Drop d, cudaStream_t stream) {
  ln_train_bwd_kernel<NVEC><<<(M + BWD_ROWS - 1) / BWD_ROWS, THREADS, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const float*>(gamma), static_cast<float*>(dz), static_cast<__nv_bfloat16*>(dh),
      static_cast<float*>(dgamma_part), static_cast<float*>(dbeta_part), M, eps, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int kmr_ln_train_max_hidden() { return MAX_VEC * 128; }
int kmr_ln_train_bwd_rows() { return BWD_ROWS; }

// h [M, H] f32, x [M, H] bf16, gamma/beta [H] f32 -> y [M, H] bf16. Dropout (on != 0): a unit is kept iff
// its bits >= cutoff and kept units are scaled by `scale`; `seed` is the seed of grid block 0 and
// rows_per_block the rows of one grid block (M a multiple of it).
int kmr_ln_train_fwd(const void* h, const void* x, const void* gamma, const void* beta, void* y, int M, int H,
                     float eps, int seed, unsigned cutoff, float scale, int on, int rows_per_block, void* stream) {
  if (!valid(M, H, rows_per_block)) return cudaErrorInvalidValue;
  const Drop d = make_drop(seed, cutoff, scale, on, rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / 128) {
    case 1: return launch_fwd<1>(h, x, gamma, beta, y, M, eps, d, s);
    case 2: return launch_fwd<2>(h, x, gamma, beta, y, M, eps, d, s);
    case 3: return launch_fwd<3>(h, x, gamma, beta, y, M, eps, d, s);
    case 4: return launch_fwd<4>(h, x, gamma, beta, y, M, eps, d, s);
    case 5: return launch_fwd<5>(h, x, gamma, beta, y, M, eps, d, s);
    case 6: return launch_fwd<6>(h, x, gamma, beta, y, M, eps, d, s);
    case 7: return launch_fwd<7>(h, x, gamma, beta, y, M, eps, d, s);
    default: return launch_fwd<8>(h, x, gamma, beta, y, M, eps, d, s);
  }
}

// as the forward, plus dy [M, H] bf16 -> dz [M, H] f32, dh [M, H] bf16, and the partial sums
// dgamma_part, dbeta_part [ceil(M / 64), H] f32, one row per CTA of 64 rows.
int kmr_ln_train_bwd(const void* h, const void* x, const void* dy, const void* gamma, void* dz, void* dh,
                     void* dgamma_part, void* dbeta_part, int M, int H, float eps, int seed, unsigned cutoff,
                     float scale, int on, int rows_per_block, void* stream) {
  if (!valid(M, H, rows_per_block)) return cudaErrorInvalidValue;
  const Drop d = make_drop(seed, cutoff, scale, on, rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / 128) {
    case 1: return launch_bwd<1>(h, x, dy, gamma, dz, dh, dgamma_part, dbeta_part, M, eps, d, s);
    case 2: return launch_bwd<2>(h, x, dy, gamma, dz, dh, dgamma_part, dbeta_part, M, eps, d, s);
    case 3: return launch_bwd<3>(h, x, dy, gamma, dz, dh, dgamma_part, dbeta_part, M, eps, d, s);
    case 4: return launch_bwd<4>(h, x, dy, gamma, dz, dh, dgamma_part, dbeta_part, M, eps, d, s);
    case 5: return launch_bwd<5>(h, x, dy, gamma, dz, dh, dgamma_part, dbeta_part, M, eps, d, s);
    case 6: return launch_bwd<6>(h, x, dy, gamma, dz, dh, dgamma_part, dbeta_part, M, eps, d, s);
    case 7: return launch_bwd<7>(h, x, dy, gamma, dz, dh, dgamma_part, dbeta_part, M, eps, d, s);
    default: return launch_bwd<8>(h, x, dy, gamma, dz, dh, dgamma_part, dbeta_part, M, eps, d, s);
  }
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
