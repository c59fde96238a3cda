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
// Each lane draws the bits of its own accumulator positions; queries and keys
// past the ends draw nothing.
//
// Replaces the per-head attention of _attn_fwd_kernel and _attn_bwd_kernel
// (ops/pallas_train.py:548-576, :607-622, :753-770, :811-849) and of
// _cross_fwd_kernel and _cross_bwd_kernel (:1041-1067, :1101-1115,
// :1213-1247), with their rounding points: f32 scores, softmax, dprobs and
// the softmax backward; probsd, ctx, ds, dq, dk, dv -> bf16; every product
// takes bf16 operands and sums in f32, as the Pallas bodies ran them on the
// MXU. The TPU packs heads into 128-lane tiles (headpack); its masks are
// drawn per head in every variant, and here every head is a warp's (forward)
// or a CTA's (backward).
//
// Bound on the H100 at ImageBERT-A's B=256, S=40: bytes (forward q, k, v in
// and ctx out, 63 MB, 0.019 ms at 3.35 TB/s; backward also dctx in and dq,
// dk, dv out, 0.033 ms), against 1.3 and 3.1 GFLOP of products. The version
// before this one staged q, k, v (and dctx) in shared memory as f32 and ran
// every product as 4x4 scalar-FMA register tiles on the CUDA cores: the FMA
// pipe and shared memory set its pace, 6.3x (forward) and 9.1x (backward)
// the bound. The design:
//   - Every product on mma.sync m16n8k16 (bf16 in, f32 sums) over operands
//     staged in bf16 by 16-byte cp.async, zero-filled to a multiple of 16
//     rows, rows padded 16 bytes against ldmatrix bank conflicts. wgmma's
//     64-row M would pad 10-40 queries up to 6x (attn_core.cu's reason).
//   - Forward: attn_core's warp routine (warp_attention.cuh:attend) with the
//     dropout as its probability hook, one warp a (pair, head) item
//     flattened over B * N, FWD_WARPS items a CTA; a warp stages its own
//     head's rows and meets its lanes with __syncwarp, so any N and a ragged
//     last CTA need no CTA barrier. The context leaves through the warp's
//     consumed q rows in 16-byte stores.
//   - Backward: one CTA a (pair, head), a warp per 16-row tile, in two
//     phases split by what each product contracts over. Phase 1, a warp per
//     16-query tile (it owns whole score rows): scores, softmax and keep bits
//     on the accumulator fragments as the forward has them, dP = dctx V^T,
//     dprobs and the row sum over the quad, ds; dQ = ds K with ds packed
//     straight into the A fragments; probsd and ds (bf16) into a [Fp x Tp]
//     scratch. One CTA barrier. Phase 2, a warp per 16-key tile:
//     dV = probsd^T dctx and dK = ds^T Q, the A operands read from the scratch
//     by ldmatrix.trans (64 accumulator registers a lane). dQ leaves through
//     a staging tile, dK and dV through the (no longer read) k and v rows, in
//     16-byte stores. The forward and the backward recompute the
//     probabilities with the same steps in the same order, so the backward's
//     probsd equals the forward's bit for bit.
// Keys past Sk are -inf inside the kernel only; masked keys carry the
// caller's -10000 bias, so a row whose keys are all masked gets an ordinary
// softmax, never NaN. No atomics: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "warp_attention.cuh"

namespace {

using namespace warp_attention;
using bf16 = __nv_bfloat16;

constexpr int FWD_WARPS = 2;        // forward (pair, head) items a CTA
constexpr int BWD_WARPS = MAX_S / 16;  // backward: a warp per 16-row tile at most
constexpr int LD = DH + 8;          // bf16 row stride in shared memory: +16 bytes against bank conflicts
constexpr float SCALE = 0.125f;     // 1 / sqrt(64)

// the probsd / ds scratch row stride: an odd number of 16-byte units, conflict-free for ldmatrix.trans
__host__ __device__ inline int scratch_ld(int sk) { return pad16(sk) + 8; }

__host__ __device__ inline int fwd_warp_elems(int sq, int sk) { return (pad16(sq) + 2 * pad16(sk)) * LD; }

__host__ __device__ inline int fwd_smem_bytes(int sq, int sk) { return FWD_WARPS * fwd_warp_elems(sq, sk) * 2; }

// q, dctx, the dq stage, k, v at LD, and the probsd and ds scratch
__host__ __device__ inline int bwd_smem_bytes(int sq, int sk) {
  return ((3 * pad16(sq) + 2 * pad16(sk)) * LD + 2 * pad16(sq) * scratch_ld(sk)) * 2;
}

struct Args {
  const bf16* q;          // [B*Sq] rows at stride ldq
  const bf16* k;          // [B*Sk] rows at stride ldkv
  const bf16* v;          // [B*Sk] rows at stride ldkv
  const float* key_bias;  // [B, Sk] or null
  const bf16* dctx;       // [B*Sq, H] (backward)
  bf16* out;              // ctx [B*Sq, H] (forward) or dq (backward), rows at stride ldo
  bf16* dk;               // backward: dK, dV rows at stride lddkv
  bf16* dv;
  int Sq, Sk, H, num_heads, ldq, ldkv, ldo, lddkv, block;
  uint32_t seed, cutoff;
  float scale;
  int on;
};

// rows_padded rows of one head (64 columns at src, row stride ld) into dst by threads i0, i0 + step, ...;
// rows past `rows` zero-filled
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int ld, int rows, int rows_padded, int i0,
                                           int step) {
  for (int idx = i0; idx < rows_padded * (DH / 8); idx += step) {
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    const bool ok = r < rows;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? r : 0) * ld + c, ok);
  }
}

// rows [r0, r1) of a staged tile (64 columns, rows LD apart) out to dst (row stride ld) by threads
// i0, i0 + step, ..., 16 bytes each
__device__ __forceinline__ void unstage_rows(bf16* dst, int ld, const bf16* src, int r0, int r1, int i0, int step) {
  for (int idx = i0; idx < (r1 - r0) * (DH / 8); idx += step) {
    const int r = r0 + idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) = *reinterpret_cast<const uint4*>(src + r * LD + c);
  }
}

// The keep bits of head h of pair b: element (query r, key c) is kept iff its bits >= cutoff; queries and
// keys past the ends draw nothing (dropped)
struct Keep {
  uint32_t salted, local, cutoff;
  int sq, sk, g, t;
  __device__ __forceinline__ Keep(const Args& a, int b, int h)
      : salted(kmr_dropout::salt(kmr_dropout::block_seed(a.seed, static_cast<uint32_t>(b / a.block)),
                                 static_cast<uint32_t>(1 + h))),
        local(static_cast<uint32_t>(b % a.block)), cutoff(a.cutoff), sq(a.Sq), sk(a.Sk),
        g(threadIdx.x % 32 / 4), t(threadIdx.x % 4) {}
  // element e of key tile j of the 16-row tile at m0, in the accumulator's order
  __device__ __forceinline__ bool operator()(int m0, int j, int e) const {
    const int r = m0 + g + 8 * (e / 2), c = 8 * j + 2 * t + e % 2;
    return r < sq && c < sk && kmr_dropout::bits3(salted, local, r, c) >= cutoff;
  }
};

// attend()'s probability hook in training: bf16 rounding follows, so probsd = bf16(keep ? p *rn scale : 0)
struct DropProbs {
  Keep keep;
  float scale;
  __device__ __forceinline__ float operator()(int m0, int j, int e, float p) const {
    return keep(m0, j, e) ? __fmul_rn(p, scale) : 0.0f;
  }
};

template <bool DROP>
__global__ void __launch_bounds__(32 * FWD_WARPS) attn_train_fwd_kernel(Args a, int items) {
  extern __shared__ __align__(16) bf16 sm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int item = blockIdx.x * FWD_WARPS + warp;
  if (item >= items) return;  // no CTA barrier below: a ragged last CTA's idle warps may leave
  const int b = item / a.num_heads, h = item % a.num_heads;
  const int Sq = a.Sq, Sk = a.Sk, QP = pad16(Sq), KP = pad16(Sk);
  bf16* q = sm + warp * fwd_warp_elems(Sq, Sk);  // then the context rows
  bf16* k = q + QP * LD;
  bf16* v = k + KP * LD;
  stage_rows(q, a.q + (size_t)b * Sq * a.ldq + h * DH, a.ldq, Sq, QP, lane, 32);
  stage_rows(k, a.k + (size_t)b * Sk * a.ldkv + h * DH, a.ldkv, Sk, KP, lane, 32);
  stage_rows(v, a.v + (size_t)b * Sk * a.ldkv + h * DH, a.ldkv, Sk, KP, lane, 32);
  cp_async_wait_all();
  __syncwarp();

  KeyBias kb(a.key_bias != nullptr ? a.key_bias + (size_t)b * Sk : nullptr, 1, Sk);
  if constexpr (DROP) {
    attend<LD>(q, k, v, QP, KP, SCALE, kb, DropProbs{Keep(a, b, h), a.scale});
  } else {
    attend<LD>(q, k, v, QP, KP, SCALE, kb);
  }
  __syncwarp();
  unstage_rows(a.out + (size_t)b * Sq * a.ldo + h * DH, a.ldo, q, 0, Sq, lane, 32);
}

// Phase 1 of the backward for the 16 queries at m0: dQ into the stage rows and out, probsd and ds into the
// scratch (rows m0.., stride SL)
template <bool DROP>
__device__ __forceinline__ void bwd_query_tile(const Args& a, int b, int h, int m0, const bf16* q, const bf16* k,
                                               const bf16* v, const bf16* dc, bf16* dq, bf16* pd, bf16* ds, int SL) {
  const int Sq = a.Sq, Sk = a.Sk, KP = pad16(Sk);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const KeyBias kb(a.key_bias != nullptr ? a.key_bias + (size_t)b * Sk : nullptr, 1, Sk);
  uint32_t fa[DH / 16][4];
  // probs, as the forward computes them
  float p[NT][4];
  load_a<LD>(fa, q, m0);
  mma_abt<LD>(p, fa, k, KP);
  float sum[2];
  softmax_tile(p, SCALE, kb, sum);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = p[j][e] / sum[e / 2];
  // dP = dctx V^T
  float dp[NT][4];
  load_a<LD>(fa, dc, m0);
  mma_abt<LD>(dp, fa, v, KP);
  // probsd into the scratch; dprobs = keep ? dP *rn scale : 0 and its row sums against probs
  [[maybe_unused]] const Keep keep(a, b, h);
  float part[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (8 * j < KP) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pdv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * hh + c;
          pdv[c] = p[j][e];
          if constexpr (DROP) {
            const bool kept = keep(m0, j, e);
            pdv[c] = kept ? __fmul_rn(p[j][e], a.scale) : 0.0f;
            dp[j][e] = kept ? __fmul_rn(dp[j][e], a.scale) : 0.0f;
          }
          part[hh] += dp[j][e] * p[j][e];
        }
        *reinterpret_cast<uint32_t*>(pd + (m0 + g + 8 * hh) * SL + 8 * j + 2 * t) = pack_bf16(pdv[0], pdv[1]);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], o);
  }
  // ds = bf16(probs *rn (dprobs - rowsum) / 8), into the scratch and, packed, the A fragments of dQ = ds K
  uint32_t dsp[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dsp[j][hh] = pack_bf16(__fmul_rn(p[j][2 * hh], dp[j][2 * hh] - part[hh]) * SCALE,
                             __fmul_rn(p[j][2 * hh + 1], dp[j][2 * hh + 1] - part[hh]) * SCALE);
      if (8 * j < KP) *reinterpret_cast<uint32_t*>(ds + (m0 + g + 8 * hh) * SL + 8 * j + 2 * t) = dsp[j][hh];
    }
  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < NT / 2; ++kt) {
    if (16 * kt < KP) {
      const uint32_t sa[4] = {dsp[2 * kt][0], dsp[2 * kt][1], dsp[2 * kt + 1][0], dsp[2 * kt + 1][1]};
      mma_slice<LD>(o, sa, k, kt);
    }
  }
  store_tile<LD>(dq, m0, o);
  __syncwarp();
  unstage_rows(a.out + (size_t)b * Sq * a.ldo + h * DH, a.ldo, dq, m0, min(m0 + 16, Sq), lane, 32);
}

// Phase 2 of the backward for the 16 keys at n0: dV = probsd^T dctx and dK = ds^T Q over every query,
// through the k and v rows n0.. and out
__device__ __forceinline__ void bwd_key_tile(const Args& a, int b, int h, int n0, const bf16* q, bf16* k, bf16* v,
                                             const bf16* dc, const bf16* pd, const bf16* ds, int SL) {
  const int Sk = a.Sk, QP = pad16(a.Sq);
  const int lane = threadIdx.x % 32;
  float dv[DH / 8][4], dk[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.0f;
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.0f;
  }
  for (int kt = 0; kt < QP / 16; ++kt) {  // queries ascending 16 at a time
    // the A fragments of the transposed [16 queries x 16 keys] scratch tiles: keys as rows, queries as k
    const int off = (16 * kt + lane % 8 + 8 * (lane / 16)) * SL + n0 + 8 * ((lane / 8) % 2);
    uint32_t pa[4], sa[4];
    ldmatrix_x4_trans(pa, pd + off);
    ldmatrix_x4_trans(sa, ds + off);
    mma_slice<LD>(dv, pa, dc, kt);
    mma_slice<LD>(dk, sa, q, kt);
  }
  store_tile<LD>(k, n0, dk);
  store_tile<LD>(v, n0, dv);
  __syncwarp();
  const int r1 = min(n0 + 16, Sk);
  unstage_rows(a.dk + (size_t)b * Sk * a.lddkv + h * DH, a.lddkv, k, n0, r1, lane, 32);
  unstage_rows(a.dv + (size_t)b * Sk * a.lddkv + h * DH, a.lddkv, v, n0, r1, lane, 32);
}

template <bool DROP>
__global__ void __launch_bounds__(32 * BWD_WARPS) attn_train_bwd_kernel(Args a) {
  extern __shared__ __align__(16) bf16 sm[];
  const int Sq = a.Sq, Sk = a.Sk, QP = pad16(Sq), KP = pad16(Sk), SL = scratch_ld(Sk);
  bf16* q = sm;
  bf16* dc = q + QP * LD;   // dctx_h
  bf16* dq = dc + QP * LD;  // the dQ stage
  bf16* k = dq + QP * LD;   // then dK
  bf16* v = k + KP * LD;    // then dV
  bf16* pd = v + KP * LD;   // [QP x KP] bf16(probsd), rows SL apart
  bf16* ds = pd + QP * SL;  // [QP x KP] ds
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  stage_rows(q, a.q + (size_t)b * Sq * a.ldq + h * DH, a.ldq, Sq, QP, tid, nt);
  stage_rows(k, a.k + (size_t)b * Sk * a.ldkv + h * DH, a.ldkv, Sk, KP, tid, nt);
  stage_rows(v, a.v + (size_t)b * Sk * a.ldkv + h * DH, a.ldkv, Sk, KP, tid, nt);
  stage_rows(dc, a.dctx + (size_t)b * Sq * a.H + h * DH, a.H, Sq, QP, tid, nt);
  cp_async_wait_all();
  __syncthreads();
  const int warp = tid / 32;
  if (16 * warp < QP) bwd_query_tile<DROP>(a, b, h, 16 * warp, q, k, v, dc, dq, pd, ds, SL);
  __syncthreads();  // the scratch is whole; k and v are read no more
  if (16 * warp < KP) bwd_key_tile(a, b, h, 16 * warp, q, k, v, dc, pd, ds, SL);
}

int launch(bool backward, Args a, int B, void* stream) {
  if (B < 1 || B > 65535 || a.Sq < 1 || a.Sq > MAX_S || a.Sk < 1 || a.Sk > MAX_S || a.num_heads < 1 ||
      a.H != a.num_heads * DH || a.block < 1 || B % a.block != 0 ||
      (a.ldq | a.ldkv | a.ldo | (backward ? a.lddkv : 0)) % 8 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (backward) {
    const int bytes = bwd_smem_bytes(a.Sq, a.Sk);
    auto kernel = a.on ? attn_train_bwd_kernel<true> : attn_train_bwd_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const int warps = (a.Sq > a.Sk ? pad16(a.Sq) : pad16(a.Sk)) / 16;
    kernel<<<dim3(a.num_heads, B), 32 * warps, bytes, s>>>(a);
  } else {
    const int bytes = fwd_smem_bytes(a.Sq, a.Sk);
    auto kernel = a.on ? attn_train_fwd_kernel<true> : attn_train_fwd_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const int items = B * a.num_heads;
    kernel<<<(items + FWD_WARPS - 1) / FWD_WARPS, 32 * FWD_WARPS, bytes, s>>>(a, items);
  }
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* key_bias, const void* dctx, void* out,
               void* dk, void* dv, int Sq, int Sk, int H, int num_heads, int ldq, int ldkv, int ldo, int lddkv,
               int block, int seed, unsigned cutoff, float scale, int on) {
  return Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
              static_cast<const float*>(key_bias), static_cast<const bf16*>(dctx), static_cast<bf16*>(out),
              static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H, num_heads, ldq, ldkv, ldo, lddkv,
              block, static_cast<uint32_t>(seed), static_cast<uint32_t>(cutoff), scale, on};
}

}  // namespace

extern "C" {

int kmr_attn_train_max_seq() { return MAX_S; }
int kmr_attn_train_head_dim() { return DH; }
// (pair, head) items a CTA of the forward holds
int kmr_attn_train_fwd_warps() { return FWD_WARPS; }
// dynamic shared memory of one CTA of the forward (backward = 0) or the backward at Sq queries, Sk keys
int kmr_attn_train_smem_bytes(int Sq, int Sk, int backward) {
  return backward ? bwd_smem_bytes(Sq, Sk) : fwd_smem_bytes(Sq, Sk);
}

// Pair b's Q rows at q + b*Sq*ldq, its K and V rows at k, v + b*Sk*ldkv (bf16, head h at column h*64),
// key_bias [B, Sk] f32 or null -> ctx rows at out + b*Sq*ldo (bf16). Self-attention passes columns 0, H,
// 2H of its [B*S, 3H] QKV buffer (ldq = ldkv = 3H); cross attention q [B*F, H] and columns 0, H of kv
// [B*T, 2H]. Dropout (on != 0): a unit is kept iff its bits >= cutoff, kept probabilities scaled by
// `scale`; `seed` seeds grid block 0 of `block` pairs (B a multiple of block).
int kmr_attn_train_fwd(const void* q, const void* k, const void* v, const void* key_bias, void* out, int B,
                       int Sq, int Sk, int H, int num_heads, int ldq, int ldkv, int ldo, int block, int seed,
                       unsigned cutoff, float scale, int on, void* stream) {
  return launch(false, make_args(q, k, v, key_bias, nullptr, out, nullptr, nullptr, Sq, Sk, H, num_heads, ldq, ldkv,
                                 ldo, 0, block, seed, cutoff, scale, on), B, stream);
}

// as the forward, plus dctx [B*Sq, H] bf16 -> dQ rows at dq (stride ldo) and dK, dV rows at dk, dv (stride
// lddkv), bf16: the QKV buffer's layout for self-attention, dq [B*F, H] and dkv [B*T, 2H] for cross.
int kmr_attn_train_bwd(const void* q, const void* k, const void* v, const void* key_bias, const void* dctx,
                       void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int num_heads, int ldq, int ldkv,
                       int ldo, int lddkv, int block, int seed, unsigned cutoff, float scale, int on,
                       void* stream) {
  return launch(true, make_args(q, k, v, key_bias, dctx, dq, dk, dv, Sq, Sk, H, num_heads, ldq, ldkv, ldo, lddkv,
                                block, seed, cutoff, scale, on), B, stream);
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
