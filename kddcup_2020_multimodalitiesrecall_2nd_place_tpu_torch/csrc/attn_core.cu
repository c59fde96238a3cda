// Per-head attention core of the fused self-attention block:
//   ctx[b, :, h] = bf16( bf16(softmax(Q_h K_h^T / sqrt(64) + key_bias[b])) @ V_h )
// read straight from the [B*S, 3H] bf16 output of the QKV projection (q, k, v
// of head h at columns h*64, H + h*64, 2H + h*64), written to ctx [B*S, H].
//
// Replaces the scores/softmax/PV part of _attn_block_kernel_headpack and
// _attn_block_kernel (ops/pallas_attention.py:208-227, :327-362). The TPU
// packs 3 heads into one 128-lane tile and takes a global max across them
// (packed_softmax, :305-319); here every head gets an exact softmax of its
// own, since a CTA owns one (pair, head) and nothing needs lanes filled.
// Rounding points as in the Pallas body: f32 scores and softmax, probs -> bf16
// (:220, :355), f32 PV accumulation, ctx -> bf16 (:225, :360).
//
// Design: one CTA of 128 threads per (head, pair); q, k, v and the scores
// live in shared memory as f32 (38 KB at S=40). Scores and PV run as 4x4
// register tiles on the CUDA cores: at S=40, Dh=64 this stage is 2.5% of the
// block's FLOPs, so it is bound by bytes (the qkv read and ctx write), not by
// the tensor cores. Rows are padded to a multiple of 4 with zeros, and the
// softmax treats keys past S as -inf, inside the kernel only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64, THREADS = 128, MAX_S = 64;
constexpr int QK_LD = DH + 1;  // odd stride: lanes reading different rows hit different banks

__host__ __device__ inline int padded(int s) { return (s + 3) & ~3; }

__host__ __device__ inline int smem_floats(int s) {
  int sp = padded(s);
  return 2 * sp * QK_LD + sp * DH + sp * sp;
}

__global__ void __launch_bounds__(THREADS)
attn_core_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ key_bias,
                 __nv_bfloat16* __restrict__ ctx, int S, int H, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int SP = padded(S);
  float* q = sm;
  float* k = q + SP * QK_LD;
  float* v = k + SP * QK_LD;  // 16-byte aligned: SP is a multiple of 4
  float* p = v + SP * DH;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int H3 = 3 * H;
  const __nv_bfloat16* base = qkv + (size_t)b * S * H3 + h * DH;

  for (int idx = tid; idx < 3 * SP * (DH / 8); idx += THREADS) {
    const int t = idx / (SP * (DH / 8));
    const int rem = idx % (SP * (DH / 8));
    const int r = rem / (DH / 8), c8 = (rem % (DH / 8)) * 8;
    float vals[8];
    if (r < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + (size_t)r * H3 + t * H + c8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = __bfloat162float(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = 0.0f;
    }
    float* dst = t == 0 ? q + r * QK_LD + c8 : (t == 1 ? k + r * QK_LD + c8 : v + r * DH + c8);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = vals[i];
  }
  __syncthreads();

  const int G = SP / 4;
  for (int item = tid; item < G * G; item += THREADS) {
    const int rg = item / G, cg = item % G;
    float acc[4][4] = {};
    for (int d = 0; d < DH; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q[(rg * 4 + i) * QK_LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = k[(cg * 4 + j) * QK_LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qa[i], ka[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cg * 4 + j;
      const float kb = (key_bias != nullptr && c < S) ? key_bias[(size_t)b * S + c] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) p[(rg * 4 + i) * SP + c] = acc[i][j] * scale + kb;
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < S; r += THREADS / 32) {
    const float s0 = lane < S ? p[r * SP + lane] : -INFINITY;
    const float s1 = lane + 32 < S ? p[r * SP + lane + 32] : -INFINITY;
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = lane < S ? expf(s0 - m) : 0.0f;
    const float e1 = lane + 32 < S ? expf(s1 - m) : 0.0f;
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane < S) p[r * SP + lane] = __bfloat162float(__float2bfloat16(e0 / sum));
    if (lane + 32 < S) p[r * SP + lane + 32] = __bfloat162float(__float2bfloat16(e1 / sum));
  }
  __syncthreads();

  for (int item = tid; item < G * (DH / 4); item += THREADS) {
    const int rg = item / (DH / 4), dg = item % (DH / 4);
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < S; ++c) {
      const float4 vv = *reinterpret_cast<const float4*>(v + c * DH + dg * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi = p[(rg * 4 + i) * SP + c];
        acc[i].x = fmaf(pi, vv.x, acc[i].x);
        acc[i].y = fmaf(pi, vv.y, acc[i].y);
        acc[i].z = fmaf(pi, vv.z, acc[i].z);
        acc[i].w = fmaf(pi, vv.w, acc[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      if (r < S) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i].x, acc[i].y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i].z, acc[i].w);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(ctx + ((size_t)b * S + r) * H + h * DH + dg * 4) = packed;
      }
    }
  }
}

}  // namespace

extern "C" {

int kmr_attn_max_seq() { return MAX_S; }
int kmr_attn_head_dim() { return DH; }

// qkv [B*S, 3H] bf16, key_bias [B, S] f32 or null, ctx [B*S, H] bf16; H = num_heads * 64.
int kmr_attn_core(const void* qkv, const void* key_bias, void* ctx, int B, int S, int H,
                  int num_heads, void* stream) {
  if (S < 1 || S > MAX_S || H != num_heads * DH) return cudaErrorInvalidValue;
  const int bytes = smem_floats(S) * 4;
  cudaError_t err = cudaFuncSetAttribute(attn_core_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(num_heads, B);
  attn_core_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(key_bias),
      static_cast<__nv_bfloat16*>(ctx), S, H, 0.125f /* 1/sqrt(64) */);
  return cudaGetLastError();
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
