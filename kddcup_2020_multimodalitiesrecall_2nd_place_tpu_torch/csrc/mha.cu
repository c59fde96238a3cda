// Bare multi-head attention of the "pallas" attention backend and of
// ops/attention.py:mha_packed:
//   out[b, n] = softmax(Q[b, n] K[b, n]^T / sqrt(64) + bias[b, n]) V[b, n]
// for q, k, v of one length S <= 64 and head dim 64, in bf16 or f32.
//
// Entry points (one launch path, two layouts of the heads):
//   kmr_mha         q, k, v as [B, N, S, 64] views at any (b, n, s) strides
//                   (the split_heads views of a projection, read in place);
//                   out [B, N, S, 64] contiguous.
//   kmr_mha_packed  q, k, v as [B, S, H] with head n in columns n*64..n*64+63
//                   (the packed layout, any row stride); out [B, S, H].
// The bias is f32 and additive, read at four element strides (b, n, query,
// key), so a [B,1,1,S] key mask, a [B,1,S,S] or a [B,N,S,S] bias is
// broadcast by stride 0 and never materialised as [B*N, S, S].
//
// Replaces mha_pallas (_attention_kernel, _no_bias_kernel;
// ops/pallas_attention.py:26-98) and mha_pallas_packed (_packed_kernel,
// :106-183). Rounding points as there: f32 scores x 1/sqrt(Dh), + bias, f32
// softmax, probs rounded to v's type (:39, :126), f32 PV accumulation, out
// in q's type (:46, :133). Both take bf16 and f32, as the Pallas kernels do.
//
// Bound on H100 at ImageBERT-A's S = 40, B = 512, N = 12, bf16: bytes. The
// call reads q, k, v and writes out, 4 x 31.5 MB = 126 MB, 0.038 ms at 3.35
// TB/s, against 2.5 GFLOP of products (0.003 ms on the tensor cores).
//
// bf16: attn_core.cu's tensor-core design (warp_attention.cuh), a warp a
// (pair, head) item. The version before this one ran both products as 4x4
// scalar-FMA register tiles out of f32 shared memory, a CTA of 128 threads a
// head: the FMA pipe and shared memory set its pace, 4.6x the bound.
//   - Items are flattened over B * N; a CTA holds WARPS of them, and a warp
//     past the last item does nothing. Each warp stages its own head's q, k and
//     v rows (128 contiguous bytes a row, eight 16-byte cp.async at that
//     operand's own row stride), zero-filled to a multiple of 16 rows and
//     padded 16 bytes against ldmatrix bank conflicts: 21 KB a warp at S = 40.
//     No warp reads another's rows, so a warp waits on its own copies and
//     meets its lanes with __syncwarp: no CTA barrier, any N, any B * N, and
//     heads of a [B, N, S, 64] view need not be adjacent (attn_core's CTA loads
//     two adjacent heads of one row at once).
//   - Both products on mma.sync m16n8k16 with the softmax on the accumulator
//     fragments (wgmma's 64-row M would pad S = 40 up to 64 and a head is
//     too little work for a warpgroup). A bias that depends on the key only
//     (none, a key mask) is read once per warp; a bias over (query, key) is
//     read per 16-row tile straight from global memory, each lane its rows g
//     and g + 8 at columns 8j + 2t, 8j + 2t + 1 (one 8-byte load where the
//     key stride is 1 and the pair aligned).
//   - The context goes back through the warp's consumed q rows in shared
//     memory and leaves in 16-byte stores, at out's row stride.
// f32, the strict-parity mode (TF32 off): the CUDA-core kernel of the version
// before, a CTA of 128 threads a (pair, head), q, k, v and the scores staged
// as f32 in shared memory, both products as 4x4 register tiles of fmaf. A
// TF32 tensor-core product would miss the 1e-5 band it is held to.
//
// Keys past S are -inf inside the kernel only; masked keys carry the caller's
// -10000, so a row whose keys are all masked gets an ordinary softmax, never
// NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_attention.cuh"

namespace {

using namespace warp_attention;
using bf16 = __nv_bfloat16;

constexpr float SCALE = 0.125f;  // 1/sqrt(64)

// Element strides of a [B, N, S, 64] operand whose last axis is contiguous.
struct Strides {
  long long b, n, s;
};

// Element strides of the bias over (pair, head, query, key); 0 broadcasts.
struct BiasStrides {
  long long b, n, q, k;
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const float* bias;  // or null
  T* out;
  Strides qs, ks, vs, os;
  BiasStrides bs;
  int N, S;
};

// ---- bf16: a warp a (pair, head) on the tensor cores ------------------------

constexpr int WARPS = 2;               // items a CTA
constexpr int LD = DH + 8;             // bf16 row stride in shared memory: +16 bytes against bank conflicts

__host__ __device__ inline int warp_smem_elems(int s) { return 3 * pad16(s) * LD; }

// rows_padded rows of one head (64 columns at src, row stride ld) into dst by
// the warp's lanes; rows past `rows` zero-filled
__device__ __forceinline__ void load_head_rows(bf16* dst, const bf16* src, long long ld, int rows, int rows_padded,
                                               int lane) {
  for (int idx = lane; idx < rows_padded * (DH / 8); idx += 32) {
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    const bool ok = r < rows;
    cp_async16(dst + r * LD + c, src + (ok ? r : 0) * ld + c, ok);
  }
}

template <bool QUERY_KEY_BIAS>
__global__ void __launch_bounds__(32 * WARPS) mha_bf16_kernel(Args<bf16> a, long long items) {
  extern __shared__ __align__(16) bf16 sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long item = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (item >= items) return;  // no CTA barrier below: a ragged last CTA's idle warps may leave
  const long long b = item / a.N;
  const int n = static_cast<int>(item % a.N);
  const int S = a.S, SP = pad16(S);
  bf16* q = sm + warp * warp_smem_elems(S);  // then the context rows
  bf16* k = q + SP * LD;
  bf16* v = k + SP * LD;
  load_head_rows(q, a.q + b * a.qs.b + n * a.qs.n, a.qs.s, S, SP, lane);
  load_head_rows(k, a.k + b * a.ks.b + n * a.ks.n, a.ks.s, S, SP, lane);
  load_head_rows(v, a.v + b * a.vs.b + n * a.vs.n, a.vs.s, S, SP, lane);
  cp_async_wait_all();
  __syncwarp();

  const float* bias = a.bias != nullptr ? a.bias + b * a.bs.b + n * a.bs.n : nullptr;
  if constexpr (QUERY_KEY_BIAS) {
    QueryKeyBias qkb(bias, a.bs.q, a.bs.k, S, S);
    attend<LD>(q, k, v, SP, SP, SCALE, qkb);
  } else {
    KeyBias kb(bias, a.bs.k, S);
    attend<LD>(q, k, v, SP, SP, SCALE, kb);
  }
  __syncwarp();
  bf16* out = a.out + b * a.os.b + n * a.os.n;
  for (int idx = lane; idx < S * (DH / 8); idx += 32) {
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    *reinterpret_cast<uint4*>(out + r * a.os.s + c) = *reinterpret_cast<const uint4*>(q + r * LD + c);
  }
}

int launch_bf16(const Args<bf16>& a, int B, void* stream) {
  const long long items = static_cast<long long>(B) * a.N;
  const int bytes = WARPS * warp_smem_elems(a.S) * 2;
  const bool query_key = a.bias != nullptr && a.bs.q != 0;
  void (*kernel)(Args<bf16>, long long) = query_key ? &mha_bf16_kernel<true> : &mha_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const unsigned ctas = static_cast<unsigned>((items + WARPS - 1) / WARPS);
  kernel<<<ctas, 32 * WARPS, bytes, static_cast<cudaStream_t>(stream)>>>(a, items);
  return cudaGetLastError();
}

// ---- f32: a CTA a (pair, head) on the CUDA cores ----------------------------

constexpr int F32_THREADS = 128;
constexpr int QK_LD = DH + 1;  // odd stride: lanes reading different rows hit different banks

__host__ __device__ inline int padded4(int s) { return (s + 3) & ~3; }

__host__ __device__ inline int f32_smem_floats(int s) {
  const int p = padded4(s);
  return 2 * p * QK_LD + p * DH + p * p;
}

// rows x 64 floats of src (row stride ld_src) -> rows of dst (row stride
// ld_dst); rows rows..rows_padded-1 are zero.
__device__ inline void load_rows_f32(float* dst, int ld_dst, const float* src, long long ld_src, int rows,
                                     int rows_padded, int tid) {
  for (int idx = tid; idx < rows_padded * (DH / 4); idx += F32_THREADS) {
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    float4 vals = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) vals = *reinterpret_cast<const float4*>(src + r * ld_src + c);
    dst[r * ld_dst + c] = vals.x;
    dst[r * ld_dst + c + 1] = vals.y;
    dst[r * ld_dst + c + 2] = vals.z;
    dst[r * ld_dst + c + 3] = vals.w;
  }
}

__global__ void __launch_bounds__(F32_THREADS) mha_f32_kernel(Args<float> a) {
  extern __shared__ __align__(16) float smf[];
  const int S = a.S, SP = padded4(S);
  float* q = smf;
  float* k = q + SP * QK_LD;
  float* v = k + SP * QK_LD;  // 16-byte aligned: 2 * SP * QK_LD is a multiple of 8
  float* p = v + SP * DH;

  const int tid = threadIdx.x;
  const long long b = blockIdx.x / a.N;
  const int n = blockIdx.x % a.N;
  load_rows_f32(q, QK_LD, a.q + b * a.qs.b + n * a.qs.n, a.qs.s, S, SP, tid);
  load_rows_f32(k, QK_LD, a.k + b * a.ks.b + n * a.ks.n, a.ks.s, S, SP, tid);
  load_rows_f32(v, DH, a.v + b * a.vs.b + n * a.vs.n, a.vs.s, S, SP, tid);
  __syncthreads();

  const float* bias = a.bias != nullptr ? a.bias + b * a.bs.b + n * a.bs.n : nullptr;
  const int G = SP / 4;
  for (int item = tid; item < G * G; item += F32_THREADS) {
    const int rg = item / G, cg = item % G;
    float acc[4][4] = {};
    for (int e = 0; e < DH; ++e) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q[(rg * 4 + i) * QK_LD + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = k[(cg * 4 + j) * QK_LD + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qa[i], ka[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg * 4 + j;
        const float add = (bias != nullptr && r < S && c < S) ? bias[r * a.bs.q + c * a.bs.k] : 0.0f;
        p[r * SP + c] = acc[i][j] * SCALE + add;
      }
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < S; r += F32_THREADS / 32) {
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
    if (lane < S) p[r * SP + lane] = e0 / sum;
    if (lane + 32 < S) p[r * SP + lane + 32] = e1 / sum;
  }
  __syncthreads();

  float* out = a.out + b * a.os.b + n * a.os.n;
  for (int item = tid; item < G * (DH / 4); item += F32_THREADS) {
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
      if (r < S) *reinterpret_cast<float4*>(out + r * a.os.s + dg * 4) = acc[i];
    }
  }
}

int launch_f32(const Args<float>& a, int B, void* stream) {
  const int bytes = f32_smem_floats(a.S) * 4;
  cudaError_t err = cudaFuncSetAttribute(mha_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  mha_f32_kernel<<<static_cast<unsigned>(B) * a.N, F32_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Pointers are 16-byte aligned and every
// q/k/v/out stride is a multiple of one 16-byte load (checked by the wrapper).
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B, int N, int S,
           int dtype, Strides qs, Strides ks, Strides vs, Strides os, BiasStrides bs, void* stream) {
  if (B < 1 || N < 1 || S < 1 || S > MAX_S || static_cast<long long>(B) * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const float* fb = static_cast<const float*>(bias);
  if (dtype == 0) {
    const Args<float> a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                        fb, static_cast<float*>(out), qs, ks, vs, os, bs, N, S};
    return launch_f32(a, B, stream);
  }
  if (dtype == 1) {
    const Args<bf16> a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), fb,
                       static_cast<bf16*>(out), qs, ks, vs, os, bs, N, S};
    return launch_bf16(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int kmr_mha_max_seq() { return MAX_S; }
int kmr_mha_head_dim() { return DH; }
// (pair, head) items a CTA of the bf16 kernel holds
int kmr_mha_warps() { return WARPS; }
// dynamic shared memory of one CTA at length S: dtype 0 = float32, 1 = bfloat16
int kmr_mha_smem_bytes(int S, int dtype) {
  return dtype == 0 ? f32_smem_floats(S) * 4 : WARPS * warp_smem_elems(S) * 2;
}

// q, k, v [B, N, S, 64] at element strides (b, n, s); bias f32 at strides
// (b, n, query, key) or null; out [B, N, S, 64] contiguous, q's type.
int kmr_mha(const void* q, const void* k, const void* v, const void* bias, void* out, int B, int N, int S,
            int dtype, long long q_sb, long long q_sn, long long q_ss, long long k_sb, long long k_sn,
            long long k_ss, long long v_sb, long long v_sn, long long v_ss, long long bias_sb,
            long long bias_sn, long long bias_sq, long long bias_sk, void* stream) {
  const Strides os{static_cast<long long>(N) * S * DH, static_cast<long long>(S) * DH, DH};
  return launch(q, k, v, bias, out, B, N, S, dtype, Strides{q_sb, q_sn, q_ss}, Strides{k_sb, k_sn, k_ss},
                Strides{v_sb, v_sn, v_ss}, os, BiasStrides{bias_sb, bias_sn, bias_sq, bias_sk}, stream);
}

// q, k, v [B, S, H] at element strides (b, s), H = num_heads * 64, head n in
// columns n*64..; bias f32 at strides (b, query, key), shared by the heads, or
// null; out [B, S, H] contiguous, q's type.
int kmr_mha_packed(const void* q, const void* k, const void* v, const void* bias, void* out, int B, int S,
                   int H, int num_heads, int dtype, long long q_sb, long long q_ss, long long k_sb,
                   long long k_ss, long long v_sb, long long v_ss, long long bias_sb, long long bias_sq,
                   long long bias_sk, void* stream) {
  if (H != num_heads * DH) return cudaErrorInvalidValue;
  const Strides os{static_cast<long long>(S) * H, DH, H};
  return launch(q, k, v, bias, out, B, num_heads, S, dtype, Strides{q_sb, DH, q_ss}, Strides{k_sb, DH, k_ss},
                Strides{v_sb, DH, v_ss}, os, BiasStrides{bias_sb, 0, bias_sq, bias_sk}, stream);
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
