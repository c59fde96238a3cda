// Tiled bf16 GEMM with fused epilogues: out = epilogue(A @ W + bias).
//
// A [M, K] bf16 row-major (activations), W [K, N] bf16 row-major (the JAX
// [in, out] kernel layout), bias [N] f32, f32 accumulation on the tensor
// cores. Epilogues (template parameter):
//   EPI_BIAS      -> bf16(acc + bias)                      QKV projection
//   EPI_GELU_TANH -> bf16(gelu_tanh(acc + bias))           FFN up-projection
//   EPI_GELU_ERF  -> bf16(gelu_erf(acc + bias))            FFN up (LXMERT)
//   EPI_RESIDUAL  -> f32(acc + bias + residual[bf16])      out-proj / FFN down,
//                                                          ahead of the LayerNorm
//   EPI_F32       -> f32(acc + bias)                       ImageBERT-B's banded
//                                                          label conv (bf16 in,
//                                                          f32 out, the JAX dot's
//                                                          rounding)
// These are the rounding points of the Pallas bodies this replaces
// (ops/pallas_attention.py:200-203 and :228-236, ops/pallas_ffn.py:45-56).
//
// Design: 128x128x32 CTA tile, 8 warps of 64x32 each, WMMA 16x16x16 bf16
// fragments, a 3-stage cp.async ring in dynamic shared memory. Rows past M
// are zero-filled on load and masked on store (B*S rows need not divide the
// tile); N must be a multiple of 128 and K of 32, which every BERT-base
// width is. The epilogue goes through a per-warp 16x16 f32 staging tile so
// each lane writes 8 contiguous outputs (16- or 32-byte stores).
// Bound on H100 at the main path's shapes: operations (tensor-core rate);
// this first version uses mma.sync through WMMA, not wgmma/TMA, so it
// cannot reach that rate -- see PERF.md for its measured share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 64 x 32 per warp
constexpr int FM = WM / 16, FN = WN / 16;            // 4 x 2 fragments
constexpr int THREADS = WARPS_M * WARPS_N * 32;      // 256
constexpr int A_LD = BK + 8;                         // 80-byte rows
constexpr int B_LD = BN + 8;                         // 272-byte rows
constexpr int A_STAGE = BM * A_LD;                   // elements
constexpr int B_STAGE = BK * B_LD;
constexpr int STAGE_BYTES = (A_STAGE + B_STAGE) * 2;
constexpr int SCRATCH_FLOATS = 16 * 16;              // per warp
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + (THREADS / 32) * SCRATCH_FLOATS * 4;

enum { EPI_BIAS = 0, EPI_GELU_TANH = 1, EPI_GELU_ERF = 2, EPI_RESIDUAL = 3, EPI_F32 = 4 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int bytes = pred ? 16 : 0;  // 0 source bytes -> the 16 smem bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ a,
                                          const __nv_bfloat16* __restrict__ w,
                                          __nv_bfloat16* as, __nv_bfloat16* bs,
                                          int M, int N, int K, int m0, int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (BM * BK / 8) / THREADS; ++i) {  // 2 chunks of 8 bf16
    int c = tid + i * THREADS;
    int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
    int grow = m0 + row;
    bool ok = grow < M;
    const __nv_bfloat16* src = a + (size_t)(ok ? grow : 0) * K + k0 + col;
    cp_async16(as + row * A_LD + col, src, ok);
  }
#pragma unroll
  for (int i = 0; i < (BK * BN / 8) / THREADS; ++i) {
    int c = tid + i * THREADS;
    int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
    const __nv_bfloat16* src = w + (size_t)(k0 + row) * N + n0 + col;
    cp_async16(bs + row * B_LD + col, src, true);
  }
}

template <int EPI>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, const __nv_bfloat16* __restrict__ residual,
                 void* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + STAGES * A_STAGE;
  float* scratch = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(a, w, a_s + s * A_STAGE, b_s + s * B_STAGE, M, N, K, m0, n0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread; stage (kt-1)%STAGES is free
    int nk = kt + STAGES - 1;
    if (nk < ktiles) {
      int s = nk % STAGES;
      load_tile(a, w, a_s + s * A_STAGE, b_s + s * B_STAGE, M, N, K, m0, n0, nk * BK);
    }
    cp_async_commit();
    const __nv_bfloat16* as = a_s + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* bs = b_s + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(fa[i], as + (wm * WM + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(fb[j], bs + kk * B_LD + wn * WN + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* sc = scratch + warp * SCRATCH_FLOATS;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int grow = m0 + wm * WM + i * 16 + r;
      const int gcol = n0 + wn * WN + j * 16 + c0;
      if (grow < M) {
        float v[8];
        const float4 b0 = *reinterpret_cast<const float4*>(bias + gcol);
        const float4 b1 = *reinterpret_cast<const float4*>(bias + gcol + 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = sc[r * 16 + c0 + e] + bv[e];
        const size_t off = (size_t)grow * N + gcol;
        if (EPI == EPI_RESIDUAL || EPI == EPI_F32) {
          if (EPI == EPI_RESIDUAL) {
            const uint4 raw = *reinterpret_cast<const uint4*>(residual + off);
            const __nv_bfloat16* rb = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] += __bfloat162float(rb[e]);
          }
          float* o = reinterpret_cast<float*>(out) + off;
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          uint4 packed;
          __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float x = v[e];
            if (EPI == EPI_GELU_TANH) x = gelu_tanh(x);
            if (EPI == EPI_GELU_ERF) x = gelu_erf(x);
            pb[e] = __float2bfloat16(x);
          }
          *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(out) + off) = packed;
        }
      }
      __syncwarp();
    }
  }
}

template <int EPI>
cudaError_t launch(const void* a, const void* w, const void* bias, const void* residual, void* out,
                   int M, int N, int K, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory needs the opt-in (set per device)
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<EPI><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(residual), out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile constraints, exported so the Python wrapper checks shapes before a launch.
int kmr_gemm_tile_n() { return BN; }
int kmr_gemm_tile_k() { return BK; }

int kmr_gemm_bf16(const void* a, const void* w, const void* bias, const void* residual, void* out,
                  int M, int N, int K, int epilogue, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case EPI_BIAS: return launch<EPI_BIAS>(a, w, bias, residual, out, M, N, K, s);
    case EPI_GELU_TANH: return launch<EPI_GELU_TANH>(a, w, bias, residual, out, M, N, K, s);
    case EPI_GELU_ERF: return launch<EPI_GELU_ERF>(a, w, bias, residual, out, M, N, K, s);
    case EPI_RESIDUAL: return launch<EPI_RESIDUAL>(a, w, bias, residual, out, M, N, K, s);
    case EPI_F32: return launch<EPI_F32>(a, w, bias, residual, out, M, N, K, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
