// Tail of a fused post-LN encoder layer: everything after the attention core.
//
//   y   = ctx @ Wo + bo + x                  f32, registers, then shared memory
//   a   = bf16(LN1(y))                       shared memory, never device memory
//   h_c = bf16(gelu(a @ W1[:, c] + b1[c]))   one 256-column chunk c at a time, shared memory
//   z   = sum_c h_c @ W2[c, :] + b2 + a      f32, registers
//   out = bf16(LN2(z))
//
// ctx, x, out [M, 768] bf16; Wo [768, 768], W1 [768, I], W2 [I, 768] bf16
// row-major (the JAX [in, out] kernel layout); biases, gammas and betas f32;
// I % 256 == 0; tanh or erf GELU (erff, where the TPU needed a polynomial).
//
// Replaces the part of the fused layer kernel after the attention core
// (encoder_layer_pallas, _layer_kernel in ops/pallas_layer.py:84-115), with
// its rounding points: a = bf16(LN1(y)) (:97), the GELU output in bf16
// (:107), the residual adding a (:110), LN2 to bf16 (:115). The TPU kernel
// held a whole layer's 14 MB of weights in VMEM; a CTA here has 227 KB, so
// the port splits the layer into three launches (QKV GEMM, attention core,
// this tail) and keeps in shared memory what the TPU kept in VMEM: the LN1
// output and the GELU intermediate.
//
// Design: one CTA of 8 warps owns 32 whole rows (LayerNorm needs full rows).
// Warp w owns columns [96w, 96w + 96) of the [32, 768] f32 accumulator: 2 x 6
// WMMA 16x16 fragments, 96 floats a thread, first for y and then for z. The
// FFN loops over I in 256-column chunks: a @ W1 chunk into 2 fragments a warp,
// GELU into shared memory, then the chunk @ W2 rows added to z. Every weight
// tile streams through one 3-stage cp.async ring (K tiles of 32 rows for the
// 768-wide products, 64 for the 256-wide one); every product accumulates in
// gemm_bf16.cu's k order: one f32 accumulator an output, k ascending, 16 at a
// time. gemm_bf16.cu runs that order on wgmma (m64n128k16), this kernel on
// mma.sync (m16n8k16, through WMMA); on the H100 the two instructions round
// each 16-term step alike (their f32 sums came out bit-equal over every
// product shape of the paths, PERF.md). For each LayerNorm the accumulator is
// staged as f32 rows in the ring (idle between products) and one warp a row
// adds bias and residual and normalises with gemm_bf16.cu's epilogue and
// layernorm.cu's arithmetic, operation for operation, so the fused layer
// rounds exactly as the two-block route does.
// 223,744 bytes of shared memory: one CTA an SM.
//
// Bound on H100 at ImageBERT-B's B=512, S=30 (M = 15,360 rows): operations,
// 163 GFLOP against ~81 MB of activations in and out and 10.6 MB of weights.
// Each CTA reads all the weights once, through L2: 480 CTAs x 10.6 MB = 5.1 GB
// of L2 traffic a layer; 64-row CTAs would halve that but need 16 warps at
// 128 registers a thread, which the 96 accumulators plus the up-projection's
// fragments do not fit without spills. WMMA (mma.sync), not wgmma/TMA: a
// first version that is right; PERF.md has its measured share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// Tile shape: 8 warps, 256-column FFN chunks, a 3-stage ring (PERF.md has
// the other shapes timed and why this one).
constexpr int H = 768;
constexpr int BM = 32;                   // rows a CTA
constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int FM = BM / 16;              // row fragments a warp (every warp spans all BM rows)
constexpr int CI = 256;                  // FFN columns a chunk
constexpr int STAGES = 3;
constexpr int BK_WIDE = 32;              // K rows a stage of the 768-wide products (Wo, W2)
constexpr int BK_UP = 64;                // K rows a stage of the CI-wide product (W1 chunk)
constexpr int X_LD = H + 8;              // bf16 strides, padded 16 bytes against bank conflicts
constexpr int H_LD = CI + 8;
constexpr int WIDE_STAGE = BK_WIDE * (H + 8);
constexpr int UP_STAGE = BK_UP * (CI + 8);
constexpr int STAGE_ELEMS = WIDE_STAGE > UP_STAGE ? WIDE_STAGE : UP_STAGE;
constexpr int FN = H / WARPS / 16;       // 6 column fragments of the 768-wide accumulator
constexpr int FN_UP = CI / WARPS / 16;   // 2 of the chunk
constexpr int SCRATCH_FLOATS = 16 * 16;  // per warp
constexpr int Y_LD = H + 4;              // f32 stride of the row staging tile
constexpr int VEC = H / 128;             // float4s a lane holds of a row in the LayerNorm pass
constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
constexpr int XS_BYTES = BM * X_LD * 2;
constexpr int HS_BYTES = BM * H_LD * 2;
constexpr int SCRATCH_BYTES = WARPS * SCRATCH_FLOATS * 4;
constexpr int SMEM_BYTES = RING_BYTES + XS_BYTES + HS_BYTES + SCRATCH_BYTES;
static_assert(SMEM_BYTES <= 232448, "more shared memory than a Hopper CTA may have");
static_assert(BM * Y_LD * 4 <= RING_BYTES, "the row staging tile lives in the (then idle) ring");
static_assert(RING_BYTES % 128 == 0 && XS_BYTES % 128 == 0 && HS_BYTES % 128 == 0, "region alignment");

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

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

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 packed;
  __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = __float2bfloat16(v[e]);
  return packed;
}

// One ring stage: rows [k0, k0 + BK) of the [K, NW] weight slice at w (row stride ldw).
template <int NW, int BK>
__device__ __forceinline__ void load_w_stage(const __nv_bfloat16* __restrict__ w, int ldw, int k0,
                                             __nv_bfloat16* dst) {
  constexpr int LD = NW + 8, ROW_CHUNKS = NW / 8, CHUNKS = BK * ROW_CHUNKS;
  static_assert(CHUNKS % THREADS == 0, "stage chunks must divide among the threads");
#pragma unroll
  for (int i = 0; i < CHUNKS / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int row = c / ROW_CHUNKS, col = (c % ROW_CHUNKS) * 8;
    cp_async16(dst + row * LD + col, w + (size_t)(k0 + row) * ldw + col, true);
  }
}

// acc += A[BM, K] @ W[K, NW]: A in shared memory (stride lda), W streamed from
// device memory through the ring; warp w owns columns [w*NW/8, (w+1)*NW/8).
// Ends with every warp past its last read of the ring and of A.
template <int NW, int BK>
__device__ __forceinline__ void rows_product(const __nv_bfloat16* a_s, int lda,
                                             const __nv_bfloat16* __restrict__ w, int ldw, int K,
                                             __nv_bfloat16* ring, Acc (&acc)[FM][NW / WARPS / 16]) {
  constexpr int LD = NW + 8, NF = NW / WARPS / 16;
  const int warp = threadIdx.x / 32;
  const int ktiles = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_w_stage<NW, BK>(w, ldw, s * BK, ring + s * STAGE_ELEMS);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt (and any earlier A load) has landed
    __syncthreads();              // ... for every thread; stage (kt-1)%STAGES is free
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load_w_stage<NW, BK>(w, ldw, nk * BK, ring + (nk % STAGES) * STAGE_ELEMS);
    cp_async_commit();
    const __nv_bfloat16* bs = ring + (kt % STAGES) * STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(fa[i], a_s + i * 16 * lda + kt * BK + kk, lda);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bs + kk * LD + warp * (NW / WARPS) + j * 16, LD);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The warp's [BM, 96] slice of the [BM, 768] f32 accumulator into the row
// staging tile ys (stride Y_LD floats), for the row pass below.
__device__ __forceinline__ void stage_rows(Acc (&acc)[FM][FN], float* ys) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(ys + i * 16 * Y_LD + warp * (FN * 16) + j * 16, acc[i][j], Y_LD, wmma::mem_row_major);
}

// Row pass over the staged tile: y = (acc + bias) + residual, then LayerNorm,
// handed to store(row, float4 index, 4 packed bf16). One warp a row, lane l
// holding float4s l, l+32, ..: the arithmetic of gemm_bf16.cu's residual
// epilogue followed by layernorm.cu's kernel, operation for operation, so the
// fused layer rounds exactly as the two-block route. residual(row, c4) gives
// the 4 residual values of float4 c4 of the row.
template <class Residual, class Store>
__device__ __forceinline__ void rows_layernorm(const float* ys, const float* __restrict__ bias, Residual residual,
                                               const float* __restrict__ gamma, const float* __restrict__ beta,
                                               float eps, Store store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4* b4 = reinterpret_cast<const float4*>(bias);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* t4 = reinterpret_cast<const float4*>(beta);
  for (int row = warp; row < BM; row += WARPS) {
    const float4* src = reinterpret_cast<const float4*>(ys + row * Y_LD);
    float4 x[VEC];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c4 = i * 32 + lane;
      const float4 a = src[c4], b = b4[c4], r = residual(row, c4);
      x[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
      x[i].x += r.x;
      x[i].y += r.y;
      x[i].z += r.z;
      x[i].w += r.w;
      sum += (x[i].x + x[i].y) + (x[i].z + x[i].w);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / H;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float a = x[i].x - mean, b = x[i].y - mean, c = x[i].z - mean, d = x[i].w - mean;
      sq += (a * a + b * b) + (c * c + d * d);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / H + eps);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c4 = i * 32 + lane;
      const float4 g = g4[c4], bt = t4[c4];
      __nv_bfloat162 lo = __floats2bfloat162_rn((x[i].x - mean) * rstd * g.x + bt.x,
                                                (x[i].y - mean) * rstd * g.y + bt.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn((x[i].z - mean) * rstd * g.z + bt.z,
                                                (x[i].w - mean) * rstd * g.w + bt.w);
      uint2 packed;
      packed.x = *reinterpret_cast<uint32_t*>(&lo);
      packed.y = *reinterpret_cast<uint32_t*>(&hi);
      store(row, c4, packed);
    }
  }
}

__device__ __forceinline__ float4 unpack4(uint2 raw) {
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(__bfloat162float(b[0]), __bfloat162float(b[1]), __bfloat162float(b[2]), __bfloat162float(b[3]));
}

template <bool ERF>
__global__ void __launch_bounds__(THREADS, 1)
layer_tail_kernel(const __nv_bfloat16* __restrict__ ctx, const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ wo, const float* __restrict__ bo,
                  const float* __restrict__ g1, const float* __restrict__ be1,
                  const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ g2, const float* __restrict__ be2,
                  __nv_bfloat16* __restrict__ out, int M, int I, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + RING_BYTES);  // ctx, then a
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + RING_BYTES + XS_BYTES);
  float* scratch = reinterpret_cast<float*>(smem + RING_BYTES + XS_BYTES + HS_BYTES);
  float* ys = reinterpret_cast<float*>(smem);  // f32 rows for the LayerNorms, between products

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;
  float* sc = scratch + warp * SCRATCH_FLOATS;

  // the ctx rows, zero past M; waited for with the first weight tile
#pragma unroll
  for (int i = 0; i < BM * H / 8 / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int row = c / (H / 8), col = (c % (H / 8)) * 8;
    const bool ok = m0 + row < M;
    cp_async16(xs + row * X_LD + col, ctx + (size_t)(ok ? m0 + row : 0) * H + col, ok);
  }
  cp_async_commit();

  Acc acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // y = ctx @ Wo + bo + x; a = bf16(LN1(y)) over the ctx rows in xs
  rows_product<H, BK_WIDE>(xs, X_LD, wo, H, H, ring, acc);
  stage_rows(acc, ys);  // the ring is free: rows_product ended on a barrier
  __syncthreads();
  rows_layernorm(
      ys, bo,
      [&](int row, int c4) {
        return m0 + row < M ? unpack4(reinterpret_cast<const uint2*>(x + (size_t)(m0 + row) * H)[c4])
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      },
      g1, be1, eps, [&](int row, int c4, uint2 p) { reinterpret_cast<uint2*>(xs + row * X_LD)[c4] = p; });
  __syncthreads();  // a is in xs, and ys (the ring) is free again for the FFN's weights

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int r = lane / 2, c0 = (lane % 2) * 8;
  for (int c = 0; c < I; c += CI) {
    Acc up[FM][FN_UP];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN_UP; ++j) wmma::fill_fragment(up[i][j], 0.0f);
    rows_product<CI, BK_UP>(xs, X_LD, w1 + c, I, H, ring, up);
    // h chunk = bf16(gelu(a @ W1[:, c] + b1[c])) into hs
#pragma unroll
    for (int i = 0; i < FM; ++i) {
#pragma unroll
      for (int j = 0; j < FN_UP; ++j) {
        wmma::store_matrix_sync(sc, up[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int col = warp * (FN_UP * 16) + j * 16 + c0;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float t = sc[r * 16 + c0 + e] + b1[c + col + e];
          v[e] = ERF ? gelu_erf(t) : gelu_tanh(t);
        }
        *reinterpret_cast<uint4*>(hs + (i * 16 + r) * H_LD + col) = pack8(v);
        __syncwarp();
      }
    }
    // z += h chunk @ W2[c:c+CI, :] (the product's first barrier publishes hs)
    rows_product<H, BK_WIDE>(hs, H_LD, w2 + (size_t)c * H, H, CI, ring, acc);
  }

  // out = bf16(LN2(z + b2 + a))
  stage_rows(acc, ys);
  __syncthreads();
  rows_layernorm(
      ys, b2, [&](int row, int c4) { return unpack4(reinterpret_cast<const uint2*>(xs + row * X_LD)[c4]); },
      g2, be2, eps, [&](int row, int c4, uint2 p) {
        if (m0 + row < M) reinterpret_cast<uint2*>(out + (size_t)(m0 + row) * H)[c4] = p;
      });
}

template <bool ERF>
cudaError_t launch(const void* ctx, const void* x, const void* wo, const void* bo, const void* g1,
                   const void* be1, const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* g2, const void* be2, void* out, int M, int I, float eps, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory needs the opt-in (set per device)
  cudaError_t err = cudaFuncSetAttribute(layer_tail_kernel<ERF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  layer_tail_kernel<ERF><<<(M + BM - 1) / BM, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf*>(ctx), static_cast<const bf*>(x), static_cast<const bf*>(wo),
      static_cast<const float*>(bo), static_cast<const float*>(g1), static_cast<const float*>(be1),
      static_cast<const bf*>(w1), static_cast<const float*>(b1), static_cast<const bf*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(g2), static_cast<const float*>(be2),
      static_cast<bf*>(out), M, I, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape constraints, exported so the Python wrapper checks shapes before a launch.
int kmr_layer_tail_hidden() { return H; }
int kmr_layer_tail_chunk() { return CI; }
int kmr_layer_tail_smem_bytes() { return SMEM_BYTES; }

int kmr_layer_tail(const void* ctx, const void* x, const void* wo, const void* bo, const void* g1,
                   const void* be1, const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* g2, const void* be2, void* out, int M, int I, int erf_gelu, float eps,
                   void* stream) {
  if (M <= 0 || I <= 0 || I % CI != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return erf_gelu ? launch<true>(ctx, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, out, M, I, eps, s)
                  : launch<false>(ctx, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, out, M, I, eps, s);
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
