// Row-wise LayerNorm closing both fused blocks:
//   out[m, :] = bf16( (y - mean) * rsqrt(var + eps) * gamma + beta )
// over y [M, H] f32 (projection + bias + residual, from gemm_bf16's residual
// epilogue), with mean and var in f32 as in the Pallas bodies it replaces
// (ops/pallas_attention.py:237-241, ops/pallas_ffn.py:57-61).
//
// Design: one warp per row, the row held in registers as float4s (H <= 1024,
// H % 128 == 0), two passes over the registers for mean and variance.
// Bound on H100: bytes (6 bytes a value in and out, ~10 flops a value).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, ROWS_PER_CTA = THREADS / 32, MAX_VEC = 8;  // H <= 8 * 128

__global__ void __launch_bounds__(THREADS)
layernorm_kernel(const float* __restrict__ y, const float* __restrict__ gamma,
                 const float* __restrict__ beta, __nv_bfloat16* __restrict__ out, int M, int H,
                 float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_CTA + warp;
  if (row >= M) return;
  const int nvec = H / 128;
  const float4* src = reinterpret_cast<const float4*>(y + (size_t)row * H);
  float4 x[MAX_VEC];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    if (i < nvec) {
      x[i] = src[i * 32 + lane];
      sum += (x[i].x + x[i].y) + (x[i].z + x[i].w);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / H;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    if (i < nvec) {
      const float a = x[i].x - mean, b = x[i].y - mean, c = x[i].z - mean, d = x[i].w - mean;
      sq += (a * a + b * b) + (c * c + d * d);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / H + eps);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  uint2* dst = reinterpret_cast<uint2*>(out + (size_t)row * H);
#pragma unroll
  for (int i = 0; i < MAX_VEC; ++i) {
    if (i < nvec) {
      const int col4 = i * 32 + lane;
      const float4 g = g4[col4], bt = b4[col4];
      __nv_bfloat162 lo = __floats2bfloat162_rn((x[i].x - mean) * rstd * g.x + bt.x,
                                                (x[i].y - mean) * rstd * g.y + bt.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn((x[i].z - mean) * rstd * g.z + bt.z,
                                                (x[i].w - mean) * rstd * g.w + bt.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      dst[col4] = packed;
    }
  }
}

}  // namespace

extern "C" {

int kmr_layernorm_max_hidden() { return MAX_VEC * 128; }

// y [M, H] f32, gamma/beta [H] f32, out [M, H] bf16; H % 128 == 0, H <= 1024.
int kmr_layernorm(const void* y, const void* gamma, const void* beta, void* out, int M, int H,
                  float eps, void* stream) {
  if (H % 128 != 0 || H > MAX_VEC * 128) return cudaErrorInvalidValue;
  const int grid = (M + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  layernorm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(out), M, H, eps);
  return cudaGetLastError();
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
