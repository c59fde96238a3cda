// Per-head attention core of the fused self-, cross- and dual-cross-attention
// blocks:
//   ctx[b, :, h] = bf16( bf16(softmax(Q_h K_h^T / sqrt(64) + key_bias[b])) @ V_h )
// with Q read from one bf16 buffer (Sq rows a pair) and K, V from another
// (Sk rows a pair), each at its own row stride, written to ctx [B*Sq, H].
// Head h's q, k and v are the 64 columns at h*64 of their pointers.
//
// Entry points (one kernel, three layouts of the projections):
//   kmr_attn_core   self-attention: q, k, v at columns 0, H, 2H of one
//                   [B*S, 3H] QKV buffer (Sq = Sk = S).
//   kmr_attn_cross  cross-attention: q [B*Sq, .] and k, v [B*Sk, .] anywhere.
//   kmr_attn_dual   both shared-weight directions of an LXMERT x-layer in one
//                   launch, grid (heads, B, 2): direction 0 is lang <- visn
//                   (q from the lang QKV buffer, k/v from the visn one, the
//                   visn key mask), direction 1 is visn <- lang.
//
// Replaces the scores/softmax/PV part of _attn_block_kernel(_headpack),
// _cross_block_kernel(_headpack) and _dual_cross_kernel
// (ops/pallas_attention.py:208-227, :327-362, :615-633, :854-880). The TPU
// packs several heads into one 128-lane tile and takes a global max across
// them (packed_softmax, :305-319); here every head gets an exact softmax of
// its own, since a CTA owns one (pair, head, direction) and nothing needs
// lanes filled. Rounding points as in the Pallas bodies: f32 scores and
// softmax, probs -> bf16 (:220, :355, :626, :870), f32 PV accumulation,
// ctx -> bf16 (:225, :360, :631, :875).
//
// Design: one CTA of 128 threads per (head, pair, direction); q, k, v and the
// scores live in shared memory as f32 (38 KB at Sq = Sk = 40, 17 KB at the
// dual launch's 23 x 10). Scores and PV run as 4x4 register tiles on the
// CUDA cores: at these lengths this stage is 1-2.5% of a block's FLOPs, so
// it is bound by bytes (the q/k/v reads and the ctx write), not by the
// tensor cores. Rows are padded to a multiple of 4 with zeros; the softmax
// treats keys past Sk as -inf, inside the kernel only, while masked keys
// carry the caller's -10000 bias, so a row whose keys are all masked gets an
// ordinary softmax, never NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64, THREADS = 128, MAX_S = 64;
constexpr int QK_LD = DH + 1;  // odd stride: lanes reading different rows hit different banks

__host__ __device__ inline int padded(int s) { return (s + 3) & ~3; }

__host__ __device__ inline int smem_floats(int sq, int sk) {
  const int qp = padded(sq), kp = padded(sk);
  return qp * QK_LD + kp * QK_LD + kp * DH + qp * kp;
}

// One attention direction. Row r of pair b, head h: q + (b*sq + r)*q_ld + h*DH,
// and likewise k and v with kv_ld and sk.
struct Dir {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* key_bias;  // [B, sk] additive, or null
  __nv_bfloat16* ctx;     // [B*sq, H]
  int q_ld, kv_ld, sq, sk;
};

__device__ inline void load_rows(float* dst, int ld_dst, const __nv_bfloat16* src, int ld_src,
                                 int rows, int rows_padded, int tid) {
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
    for (int i = 0; i < 8; ++i) dst[r * ld_dst + c8 + i] = vals[i];
  }
}

__global__ void __launch_bounds__(THREADS)
attn_core_kernel(Dir d0, Dir d1, int H, float scale) {
  extern __shared__ __align__(16) float sm[];
  const Dir d = blockIdx.z == 0 ? d0 : d1;
  const int SQ = d.sq, SK = d.sk, QP = padded(SQ), KP = padded(SK);
  float* q = sm;
  float* k = q + QP * QK_LD;
  float* v = k + KP * QK_LD;  // 16-byte aligned: QP + KP is a multiple of 4
  float* p = v + KP * DH;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  load_rows(q, QK_LD, d.q + (size_t)b * SQ * d.q_ld + h * DH, d.q_ld, SQ, QP, tid);
  load_rows(k, QK_LD, d.k + (size_t)b * SK * d.kv_ld + h * DH, d.kv_ld, SK, KP, tid);
  load_rows(v, DH, d.v + (size_t)b * SK * d.kv_ld + h * DH, d.kv_ld, SK, KP, tid);
  __syncthreads();

  const int GQ = QP / 4, GK = KP / 4;
  for (int item = tid; item < GQ * GK; item += THREADS) {
    const int rg = item / GK, cg = item % GK;
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
    for (int j = 0; j < 4; ++j) {
      const int c = cg * 4 + j;
      const float kb = (d.key_bias != nullptr && c < SK) ? d.key_bias[(size_t)b * SK + c] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) p[(rg * 4 + i) * KP + c] = acc[i][j] * scale + kb;
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < SQ; r += THREADS / 32) {
    const float s0 = lane < SK ? p[r * KP + lane] : -INFINITY;
    const float s1 = lane + 32 < SK ? p[r * KP + lane + 32] : -INFINITY;
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = lane < SK ? expf(s0 - m) : 0.0f;
    const float e1 = lane + 32 < SK ? expf(s1 - m) : 0.0f;
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane < SK) p[r * KP + lane] = __bfloat162float(__float2bfloat16(e0 / sum));
    if (lane + 32 < SK) p[r * KP + lane + 32] = __bfloat162float(__float2bfloat16(e1 / sum));
  }
  __syncthreads();

  for (int item = tid; item < GQ * (DH / 4); item += THREADS) {
    const int rg = item / (DH / 4), dg = item % (DH / 4);
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < SK; ++c) {
      const float4 vv = *reinterpret_cast<const float4*>(v + c * DH + dg * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi = p[(rg * 4 + i) * KP + c];
        acc[i].x = fmaf(pi, vv.x, acc[i].x);
        acc[i].y = fmaf(pi, vv.y, acc[i].y);
        acc[i].z = fmaf(pi, vv.z, acc[i].z);
        acc[i].w = fmaf(pi, vv.w, acc[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      if (r < SQ) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i].x, acc[i].y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i].z, acc[i].w);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(d.ctx + ((size_t)b * SQ + r) * H + h * DH + dg * 4) = packed;
      }
    }
  }
}

bool valid(const Dir& d) {
  return d.sq >= 1 && d.sq <= MAX_S && d.sk >= 1 && d.sk <= MAX_S && d.q_ld % 8 == 0 &&
         d.kv_ld % 8 == 0;
}

// Launches `dirs` (1 or 2) directions over B pairs and num_heads heads.
int launch(const Dir& d0, const Dir& d1, int dirs, int B, int H, int num_heads, void* stream) {
  if (B < 1 || B > 65535 || H != num_heads * DH || !valid(d0) || (dirs == 2 && !valid(d1)))
    return cudaErrorInvalidValue;
  int floats = smem_floats(d0.sq, d0.sk);
  if (dirs == 2 && smem_floats(d1.sq, d1.sk) > floats) floats = smem_floats(d1.sq, d1.sk);
  const int bytes = floats * 4;
  cudaError_t err = cudaFuncSetAttribute(attn_core_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(num_heads, B, dirs);
  attn_core_kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      d0, d1, H, 0.125f /* 1/sqrt(64) */);
  return cudaGetLastError();
}

const __nv_bfloat16* bf(const void* p) { return static_cast<const __nv_bfloat16*>(p); }

}  // namespace

extern "C" {

int kmr_attn_max_seq() { return MAX_S; }
int kmr_attn_head_dim() { return DH; }

// qkv [B*S, 3H] bf16, key_bias [B, S] f32 or null, ctx [B*S, H] bf16; H = num_heads * 64.
int kmr_attn_core(const void* qkv, const void* key_bias, void* ctx, int B, int S, int H,
                  int num_heads, void* stream) {
  const Dir d{bf(qkv), bf(qkv) + H, bf(qkv) + 2 * H, static_cast<const float*>(key_bias),
              static_cast<__nv_bfloat16*>(ctx), 3 * H, 3 * H, S, S};
  return launch(d, d, 1, B, H, num_heads, stream);
}

// q rows at stride q_ld ([B*Sq] rows), k and v rows at stride kv_ld ([B*Sk] rows),
// key_bias [B, Sk] f32 or null, ctx [B*Sq, H] bf16. Pointers and strides 16-byte aligned.
int kmr_attn_cross(const void* q, const void* k, const void* v, const void* key_bias, void* ctx,
                   int q_ld, int kv_ld, int B, int Sq, int Sk, int H, int num_heads, void* stream) {
  const Dir d{bf(q), bf(k), bf(v), static_cast<const float*>(key_bias),
              static_cast<__nv_bfloat16*>(ctx), q_ld, kv_ld, Sq, Sk};
  return launch(d, d, 1, B, H, num_heads, stream);
}

// lqkv [B*F, 3H] and vqkv [B*T, 3H] bf16 (each stream projected by the shared
// [H, 3H] weights), lang_bias [B, F] and visn_bias [B, T] f32 (both or neither),
// ctx_l [B*F, H] and ctx_v [B*T, H] bf16.
int kmr_attn_dual(const void* lqkv, const void* vqkv, const void* lang_bias,
                  const void* visn_bias, void* ctx_l, void* ctx_v, int B, int F, int T, int H,
                  int num_heads, void* stream) {
  const Dir lang{bf(lqkv), bf(vqkv) + H, bf(vqkv) + 2 * H, static_cast<const float*>(visn_bias),
                 static_cast<__nv_bfloat16*>(ctx_l), 3 * H, 3 * H, F, T};
  const Dir visn{bf(vqkv), bf(lqkv) + H, bf(lqkv) + 2 * H, static_cast<const float*>(lang_bias),
                 static_cast<__nv_bfloat16*>(ctx_v), 3 * H, 3 * H, T, F};
  return launch(lang, visn, 2, B, H, num_heads, stream);
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
