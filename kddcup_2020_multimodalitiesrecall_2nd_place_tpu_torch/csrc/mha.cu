// Bare multi-head attention of the "pallas" attention backend and of
// ops/attention.py:mha_packed:
//   out[b, n] = softmax(Q[b, n] K[b, n]^T / sqrt(64) + bias[b, n]) V[b, n]
// for q, k, v of one length S <= 64 and head dim 64, in bf16 or f32.
//
// Entry points (one kernel template, two layouts of the heads):
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
// in q's type (:46, :133). Both are instanced for bf16 and f32, as the Pallas
// kernels take either.
//
// Bound on H100 at ImageBERT-A's S = 40, B = 512, N = 12, bf16: bytes. The
// call reads q, k, v and writes out, 4 x 31.5 MB = 126 MB, 0.038 ms at 3.35
// TB/s, against 2.5 GFLOP of products (0.003 ms on the tensor cores). The
// design is attn_core.cu's: one CTA of 128 threads per (pair, head) stages
// its q, k, v rows (coalesced 16-byte loads) and the scores in shared memory
// as f32 (37 KB at S = 40, 66 KB at S = 64), runs both products as 4x4
// register tiles on the CUDA cores, and writes its 64-wide output rows
// once. The TPU blocked 64 (pair, head) slabs per grid step to fill its
// matrix unit; here the 6,144 CTAs of a launch fill the SMs instead. Rows are
// padded to a multiple of 4 with zeros; keys past S are -inf inside the
// kernel only, while masked keys carry the caller's -10000, so a row whose
// keys are all masked gets an ordinary softmax, never NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64, THREADS = 128, MAX_S = 64;
constexpr int QK_LD = DH + 1;  // odd stride: lanes reading different rows hit different banks

__host__ __device__ inline int padded(int s) { return (s + 3) & ~3; }

__host__ __device__ inline int smem_floats(int s) {
  const int p = padded(s);
  return 2 * p * QK_LD + p * DH + p * p;
}

// Element strides of a [B, N, S, 64] operand whose last axis is contiguous.
struct Strides {
  long long b, n, s;
};

// Element strides of the bias over (pair, head, query, key); 0 broadcasts.
struct BiasStrides {
  long long b, n, q, k;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;  // elements in one 16-byte load
  __device__ static void load(const float* src, float* dst) {
    const float4 raw = *reinterpret_cast<const float4*>(src);
    dst[0] = raw.x;
    dst[1] = raw.y;
    dst[2] = raw.z;
    dst[3] = raw.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static void store4(float* dst, float4 val) { *reinterpret_cast<float4*>(dst) = val; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(e[i]);
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  __device__ static void store4(__nv_bfloat16* dst, float4 val) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(val.x, val.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(val.z, val.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
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

// rows x 64 elements of src (row stride ld_src) -> f32 rows of dst (row stride
// ld_dst); rows rows..rows_padded-1 are zero.
template <typename T>
__device__ inline void load_rows(float* dst, int ld_dst, const T* src, long long ld_src, int rows,
                                 int rows_padded, int tid) {
  constexpr int V = Elem<T>::VEC;
  for (int idx = tid; idx < rows_padded * (DH / V); idx += THREADS) {
    const int r = idx / (DH / V), c = (idx % (DH / V)) * V;
    float vals[V];
    if (r < rows) {
      Elem<T>::load(src + r * ld_src + c, vals);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) vals[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dst[r * ld_dst + c + i] = vals[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) mha_kernel(Args<T> a, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int S = a.S, SP = padded(S);
  float* q = sm;
  float* k = q + SP * QK_LD;
  float* v = k + SP * QK_LD;  // 16-byte aligned: 2 * SP * QK_LD is a multiple of 8
  float* p = v + SP * DH;

  const int tid = threadIdx.x;
  const long long b = blockIdx.x / a.N;
  const int n = blockIdx.x % a.N;
  load_rows(q, QK_LD, a.q + b * a.qs.b + n * a.qs.n, a.qs.s, S, SP, tid);
  load_rows(k, QK_LD, a.k + b * a.ks.b + n * a.ks.n, a.ks.s, S, SP, tid);
  load_rows(v, DH, a.v + b * a.vs.b + n * a.vs.n, a.vs.s, S, SP, tid);
  __syncthreads();

  const float* bias = a.bias != nullptr ? a.bias + b * a.bs.b + n * a.bs.n : nullptr;
  const int G = SP / 4;
  for (int item = tid; item < G * G; item += THREADS) {
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
        p[r * SP + c] = acc[i][j] * scale + add;
      }
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
    if (lane < S) p[r * SP + lane] = Elem<T>::round(e0 / sum);
    if (lane + 32 < S) p[r * SP + lane + 32] = Elem<T>::round(e1 / sum);
  }
  __syncthreads();

  T* out = a.out + b * a.os.b + n * a.os.n;
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
      if (r < S) Elem<T>::store4(out + r * a.os.s + dg * 4, acc[i]);
    }
  }
}

template <typename T>
int launch_typed(const Args<T>& a, int B, void* stream) {
  const int bytes = smem_floats(a.S) * 4;
  cudaError_t err = cudaFuncSetAttribute(mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  mha_kernel<T><<<static_cast<unsigned>(B) * a.N, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      a, 0.125f /* 1/sqrt(64) */);
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
    return launch_typed(a, B, stream);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const Args<bf> a{static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), fb,
                     static_cast<bf*>(out), qs, ks, vs, os, bs, N, S};
    return launch_typed(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int kmr_mha_max_seq() { return MAX_S; }
int kmr_mha_head_dim() { return DH; }

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
