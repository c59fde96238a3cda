// Tiled bf16 GEMM with fused epilogues: out = epilogue(A @ W + bias).
//
// A [M, K] bf16 row-major (activations), W [K, N] bf16 row-major (the JAX
// [in, out] kernel layout), or with TRANS_B W [N, K] row-major read as its
// transpose (A @ W^T: the training backward's products with the forward's
// weights, no transposed copy), bias [N] f32 or null (no bias), f32
// accumulation on the tensor cores. Epilogues (template parameter):
//   EPI_BIAS      -> bf16(acc + bias)                      QKV projection
//   EPI_GELU_TANH -> bf16(gelu_tanh(acc + bias))           FFN up-projection
//   EPI_GELU_ERF  -> bf16(gelu_erf(acc + bias))            FFN up (LXMERT)
//   EPI_RESIDUAL  -> f32(acc + bias + residual[bf16])      out-proj / FFN down,
//                                                          ahead of the LayerNorm
//   EPI_F32       -> f32(acc + bias)                       ImageBERT-B's banded
//                                                          label conv (bf16 in,
//                                                          f32 out, the JAX dot's
//                                                          rounding); the train
//                                                          blocks' projections
//                                                          ahead of ln_train
//   EPI_GELU_*_SAVE -> bf16(gelu(u)), and u = acc + bias   the train FFN
//                      to aux [M, N] f32                   backward's recompute
//   EPI_GELU_BWD_*  -> bf16((acc + bias) * gelu'(u)),      du = dg * gelu'(u)
//                      u from aux [M, N] f32
//   EPI_RESIDUAL_F32 -> bf16(acc + bias + aux[f32])        dx = dz + du @ W1^T
// These are the rounding points of the Pallas bodies this replaces
// (ops/pallas_attention.py:200-203 and :228-236, ops/pallas_ffn.py:45-56,
// ops/pallas_train.py:182-188, :210-217, :240-252, :593-596, :796-799, :850-855).
//
// Design: 128x128x32 CTA tile, 8 warps of 64x32 each, WMMA 16x16x16 bf16
// fragments, a 3-stage cp.async ring in dynamic shared memory. Rows past M
// are zero-filled on load and masked on store (B*S rows need not divide the
// tile); N must be a multiple of 128 and K of 32, which every BERT-base
// width is (768, 2304, 3072). With TRANS_B the W tile is read as 128 rows of
// 32 contiguous k values and handed to WMMA as a col-major B fragment. The epilogue goes through a per-warp 16x16 f32 staging tile so
// each lane writes 8 contiguous outputs (16- or 32-byte stores).
// Bound on H100 at the main path's shapes: operations (tensor-core rate);
// this first version uses mma.sync through WMMA, not wgmma/TMA, so it
// cannot reach that rate -- see PERF.md for its measured share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // 64 x 32 per warp
constexpr int FM = WM / 16, FN = WN / 16;            // 4 x 2 fragments
constexpr int THREADS = WARPS_M * WARPS_N * 32;      // 256
constexpr int A_LD = BK + 8;                         // 80-byte rows
constexpr int B_LD = BN + 8;                         // 272-byte rows
constexpr int BT_LD = BK + 8;                        // TRANS_B: 80-byte rows of k
constexpr int A_STAGE = BM * A_LD;                   // elements
constexpr int SCRATCH_FLOATS = 16 * 16;              // per warp

template <bool TRANS_B>
struct Layout {
  static constexpr int B_STAGE = TRANS_B ? BN * BT_LD : BK * B_LD;
  static constexpr int STAGE_BYTES = (A_STAGE + B_STAGE) * 2;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + (THREADS / 32) * SCRATCH_FLOATS * 4;
};

enum {
  EPI_BIAS = 0, EPI_GELU_TANH = 1, EPI_GELU_ERF = 2, EPI_RESIDUAL = 3, EPI_F32 = 4,
  EPI_GELU_TANH_SAVE = 5, EPI_GELU_ERF_SAVE = 6, EPI_GELU_BWD_TANH = 7, EPI_GELU_BWD_ERF = 8,
  EPI_RESIDUAL_F32 = 9
};

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
// d gelu / du (ops/pallas_train.py:64-72)
__device__ __forceinline__ float gelu_bwd_tanh(float u) {
  const float k = 0.7978845608028654f, a = 0.044715f;
  const float t = tanhf(k * (u + a * u * u * u));
  return 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * k * (1.0f + 3.0f * a * u * u);
}
__device__ __forceinline__ float gelu_bwd_erf(float u) {
  const float phi = expf(-0.5f * u * u) * 0.3989422804014327f;
  return 0.5f * (1.0f + erff(u * 0.7071067811865476f)) + u * phi;
}

template <bool TRANS_B>
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
    if (TRANS_B) {  // w [N, K]: row n of the tile holds k0..k0+31
      int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
      cp_async16(bs + row * BT_LD + col, w + (size_t)(n0 + row) * K + k0 + col, true);
    } else {
      int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
      cp_async16(bs + row * B_LD + col, w + (size_t)(k0 + row) * N + n0 + col, true);
    }
  }
}

template <int EPI, bool TRANS_B>
__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, const __nv_bfloat16* __restrict__ residual,
                 float* __restrict__ aux, void* __restrict__ out, int M, int N, int K) {
  using L = Layout<TRANS_B>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + STAGES * A_STAGE;
  float* scratch = reinterpret_cast<float*>(smem + STAGES * L::STAGE_BYTES);

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
    if (s < ktiles) load_tile<TRANS_B>(a, w, a_s + s * A_STAGE, b_s + s * L::B_STAGE, M, N, K, m0, n0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread; stage (kt-1)%STAGES is free
    int nk = kt + STAGES - 1;
    if (nk < ktiles) {
      int s = nk % STAGES;
      load_tile<TRANS_B>(a, w, a_s + s * A_STAGE, b_s + s * L::B_STAGE, M, N, K, m0, n0, nk * BK);
    }
    cp_async_commit();
    const __nv_bfloat16* as = a_s + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* bs = b_s + (kt % STAGES) * L::B_STAGE;
    using BLayout = typename std::conditional<TRANS_B, wmma::col_major, wmma::row_major>::type;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(fa[i], as + (wm * WM + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        if (TRANS_B) wmma::load_matrix_sync(fb[j], bs + (wn * WN + j * 16) * BT_LD + kk, BT_LD);
        else wmma::load_matrix_sync(fb[j], bs + kk * B_LD + wn * WN + j * 16, B_LD);
      }
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
        float bv[8] = {};
        if (bias != nullptr) {
          const float4 b0 = *reinterpret_cast<const float4*>(bias + gcol);
          const float4 b1 = *reinterpret_cast<const float4*>(bias + gcol + 4);
          bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
          bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = sc[r * 16 + c0 + e] + bv[e];
        const size_t off = (size_t)grow * N + gcol;
        float ax[8];
        if (EPI == EPI_GELU_TANH_SAVE || EPI == EPI_GELU_ERF_SAVE) {  // u out
          *reinterpret_cast<float4*>(aux + off) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(aux + off + 4) = make_float4(v[4], v[5], v[6], v[7]);
        }
        if (EPI == EPI_GELU_BWD_TANH || EPI == EPI_GELU_BWD_ERF || EPI == EPI_RESIDUAL_F32) {  // u or r in
          const float4 x0 = *reinterpret_cast<const float4*>(aux + off);
          const float4 x1 = *reinterpret_cast<const float4*>(aux + off + 4);
          ax[0] = x0.x, ax[1] = x0.y, ax[2] = x0.z, ax[3] = x0.w;
          ax[4] = x1.x, ax[5] = x1.y, ax[6] = x1.z, ax[7] = x1.w;
        }
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
            if (EPI == EPI_GELU_TANH || EPI == EPI_GELU_TANH_SAVE) x = gelu_tanh(x);
            if (EPI == EPI_GELU_ERF || EPI == EPI_GELU_ERF_SAVE) x = gelu_erf(x);
            if (EPI == EPI_GELU_BWD_TANH) x = __fmul_rn(x, gelu_bwd_tanh(ax[e]));
            if (EPI == EPI_GELU_BWD_ERF) x = __fmul_rn(x, gelu_bwd_erf(ax[e]));
            if (EPI == EPI_RESIDUAL_F32) x = __fadd_rn(x, ax[e]);
            pb[e] = __float2bfloat16(x);
          }
          *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(out) + off) = packed;
        }
      }
      __syncwarp();
    }
  }
}

template <int EPI, bool TRANS_B>
cudaError_t launch(const void* a, const void* w, const void* bias, const void* residual, void* aux, void* out,
                   int M, int N, int K, cudaStream_t stream) {
  constexpr int smem = Layout<TRANS_B>::SMEM_BYTES;
  // above 48 KB of dynamic shared memory needs the opt-in (set per device)
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI, TRANS_B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<EPI, TRANS_B><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(residual), static_cast<float*>(aux),
      out, M, N, K);
  return cudaGetLastError();
}

template <bool TRANS_B>
int dispatch(const void* a, const void* w, const void* bias, const void* residual, void* aux, void* out,
             int M, int N, int K, int epilogue, cudaStream_t s) {
  switch (epilogue) {
    case EPI_BIAS: return launch<EPI_BIAS, TRANS_B>(a, w, bias, residual, aux, out, M, N, K, s);
    case EPI_GELU_TANH: return launch<EPI_GELU_TANH, TRANS_B>(a, w, bias, residual, aux, out, M, N, K, s);
    case EPI_GELU_ERF: return launch<EPI_GELU_ERF, TRANS_B>(a, w, bias, residual, aux, out, M, N, K, s);
    case EPI_RESIDUAL: return launch<EPI_RESIDUAL, TRANS_B>(a, w, bias, residual, aux, out, M, N, K, s);
    case EPI_F32: return launch<EPI_F32, TRANS_B>(a, w, bias, residual, aux, out, M, N, K, s);
    case EPI_GELU_TANH_SAVE:
      return launch<EPI_GELU_TANH_SAVE, TRANS_B>(a, w, bias, residual, aux, out, M, N, K, s);
    case EPI_GELU_ERF_SAVE: return launch<EPI_GELU_ERF_SAVE, TRANS_B>(a, w, bias, residual, aux, out, M, N, K, s);
    case EPI_GELU_BWD_TANH: return launch<EPI_GELU_BWD_TANH, TRANS_B>(a, w, bias, residual, aux, out, M, N, K, s);
    case EPI_GELU_BWD_ERF: return launch<EPI_GELU_BWD_ERF, TRANS_B>(a, w, bias, residual, aux, out, M, N, K, s);
    case EPI_RESIDUAL_F32: return launch<EPI_RESIDUAL_F32, TRANS_B>(a, w, bias, residual, aux, out, M, N, K, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Tile constraints, exported so the Python wrapper checks shapes before a launch.
int kmr_gemm_tile_n() { return BN; }
int kmr_gemm_tile_k() { return BK; }

// a [M, K] bf16; w [K, N] bf16, or [N, K] with trans_b; bias [N] f32 or null; residual [M, N] bf16
// (EPI_RESIDUAL); aux [M, N] f32 (written by the _SAVE epilogues, read by GELU_BWD and RESIDUAL_F32)
int kmr_gemm_bf16(const void* a, const void* w, const void* bias, const void* residual, void* aux, void* out,
                  int M, int N, int K, int epilogue, int trans_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return trans_b ? dispatch<true>(a, w, bias, residual, aux, out, M, N, K, epilogue, s)
                 : dispatch<false>(a, w, bias, residual, aux, out, M, N, K, epilogue, s);
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
