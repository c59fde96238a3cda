// Per-head attention core of the fused self-, cross- and dual-cross-attention
// blocks:
//   ctx[b, :, h] = bf16( bf16(softmax(Q_h K_h^T / sqrt(64) + bias[b])) @ V_h )
// with Q read from one bf16 buffer (Sq rows a pair) and K, V from another
// (Sk rows a pair), each at its own row stride, written to ctx [B*Sq, H].
// Head h's q, k and v are the 64 columns at h*64 of their pointers. The bias
// is f32, shared by the heads: none, a key mask [B, Sk] (read once a warp), or
// a full [B, Sq, Sk] bias (kmr_attn_core and kmr_attn_cross only; each warp
// reads its 16-row tile's part at the tile's start), the JAX blocks'
// broadcast_to(bias, (b, 1, sq, sk)) (ops/pallas_attention.py:544, :780).
//
// Entry points (one kernel, three layouts of the projections):
//   kmr_attn_core   self-attention: q, k, v at columns 0, H, 2H of one
//                   [B*S, 3H] QKV buffer (Sq = Sk = S).
//   kmr_attn_cross  cross-attention: q [B*Sq, .] and k, v [B*Sk, .] anywhere.
//   kmr_attn_dual   both shared-weight directions of an LXMERT x-layer in one
//                   launch, grid (head groups, B, 2): direction 0 is lang <- visn
//                   (q from the lang QKV buffer, k/v from the visn one, the
//                   visn key mask), direction 1 is visn <- lang.
//
// Replaces the scores/softmax/PV part of _attn_block_kernel(_headpack),
// _cross_block_kernel(_headpack) and _dual_cross_kernel
// (ops/pallas_attention.py:208-227, :327-362, :615-633, :854-880). The TPU
// packs several heads into one 128-lane tile and takes a global max across
// them (packed_softmax, :305-319); here every head gets an exact softmax of
// its own. Rounding points as in the Pallas bodies: f32 scores and softmax,
// probs -> bf16 (:220, :355, :626, :870), f32 PV accumulation, ctx -> bf16
// (:225, :360, :631, :875); both products take bf16 operands and sum in f32,
// as the Pallas bodies ran them on the MXU.
//
// Bound on the H100 at ImageBERT-A's B=512, S=40: bytes, 126 MB of q, k, v
// and ctx (0.038 ms at 3.35 TB/s) against 4 GFLOP. The version before this
// one ran both products as 4x4 scalar-FMA register tiles out of f32 shared
// memory, two shared loads an FMA: the FMA pipe and shared memory, not the
// bytes, set its pace (4.6x the bound). The design:
//   - Both products on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//     sums). At these lengths (S = 40, 30, 23, 10 pad to 48, 32, 32, 16
//     rows) wgmma's 64-row M would pad the queries up to 6x, and one
//     warpgroup's 64x64 tile of a head exceeds the work there is; a warp a
//     head with 16-row tiles wastes at most 15 rows.
//   - A CTA of HPC warps owns HPC heads of one pair and direction: it stages
//     their q, k and v rows in bf16 with 16-byte cp.async (row segments of
//     HPC * 128 contiguous bytes, zero-filled to a multiple of 16 rows), rows
//     padded 16 bytes against ldmatrix bank conflicts. Of 1, 2, 4 and 6 heads a
//     CTA, 2 timed best or within a few percent of the best at every length.
//   - Each warp walks its head's queries 16 rows at a time: QK^T from
//     ldmatrix fragments, scale, key bias and softmax on the accumulator
//     fragments in registers (a row lives in the 4 lanes of a quad), probs
//     cast to bf16 straight into the A fragments of PV (the accumulator
//     layout of two n8 tiles is the A layout of one k16 slice), V through
//     ldmatrix.trans. The context rows go back through the (consumed) q rows
//     in shared memory and leave in 16-byte stores. That warp routine lives
//     in warp_attention.cuh, which mha.cu shares.
// Keys past Sk are -inf inside the kernel only; masked keys carry the
// caller's -10000 bias, so a row whose keys are all masked gets an ordinary
// softmax, never NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_attention.cuh"

namespace {

using namespace warp_attention;

constexpr int HPC = 2;                // heads a CTA, one warp each
constexpr int THREADS = 32 * HPC;
constexpr int LD = HPC * DH + 8;      // bf16 row stride in shared memory: +16 bytes against bank conflicts

__host__ __device__ inline int smem_bytes(int sq, int sk) { return (pad16(sq) + 2 * pad16(sk)) * LD * 2; }

// One attention direction. Row r of pair b, head h: q + (b*sq + r)*q_ld + h*DH,
// and likewise k and v with kv_ld and sk.
struct Dir {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;  // additive: [B, sk], or [B, sq, sk] in the FULL instance, or null
  __nv_bfloat16* ctx;     // [B*sq, H]
  int q_ld, kv_ld, sq, sk;
};

// rows_padded rows of the CTA's HPC heads (HPC * 64 columns at src, row stride ld) into dst; rows
// past `rows` zero-filled
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int ld, int rows,
                                          int rows_padded) {
  constexpr int CHUNKS = HPC * DH / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < rows_padded * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    const bool ok = r < rows;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? r : 0) * ld + c, ok);
  }
}

template <bool FULL>
__global__ void __launch_bounds__(THREADS)
attn_core_kernel(Dir d0, Dir d1, int H, float scale) {
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  const Dir d = blockIdx.z == 0 ? d0 : d1;
  const int SQ = d.sq, SK = d.sk, QP = pad16(SQ), KP = pad16(SK);
  __nv_bfloat16* q = sm;  // then the context rows
  __nv_bfloat16* k = q + QP * LD;
  __nv_bfloat16* v = k + KP * LD;
  const int b = blockIdx.y, col0 = blockIdx.x * HPC * DH;
  load_rows(q, d.q + (size_t)b * SQ * d.q_ld + col0, d.q_ld, SQ, QP);
  load_rows(k, d.k + (size_t)b * SK * d.kv_ld + col0, d.kv_ld, SK, KP);
  load_rows(v, d.v + (size_t)b * SK * d.kv_ld + col0, d.kv_ld, SK, KP);
  cp_async_wait_all();
  __syncthreads();

  const int hc = (threadIdx.x / 32) * DH;  // this warp's head: its columns in the staged rows
  if constexpr (FULL) {
    QueryKeyBias qkb(d.bias + (size_t)b * SQ * SK, SK, 1, SQ, SK);
    attend<LD>(q + hc, k + hc, v + hc, QP, KP, scale, qkb);
  } else {
    KeyBias kb(d.bias != nullptr ? d.bias + (size_t)b * SK : nullptr, 1, SK);
    attend<LD>(q + hc, k + hc, v + hc, QP, KP, scale, kb);
  }
  __syncthreads();
  constexpr int CHUNKS = HPC * DH / 8;
  for (int idx = threadIdx.x; idx < SQ * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    *reinterpret_cast<uint4*>(d.ctx + ((size_t)b * SQ + r) * H + col0 + c) = *reinterpret_cast<const uint4*>(q + r * LD + c);
  }
}

bool valid(const Dir& d) {
  return d.sq >= 1 && d.sq <= MAX_S && d.sk >= 1 && d.sk <= MAX_S && d.q_ld % 8 == 0 &&
         d.kv_ld % 8 == 0;
}

// Launches `dirs` (1 or 2) directions over B pairs and num_heads heads; `full`: the biases are [B, sq, sk].
int launch(const Dir& d0, const Dir& d1, int dirs, bool full, int B, int H, int num_heads, void* stream) {
  if (B < 1 || B > 65535 || H != num_heads * DH || num_heads % HPC != 0 || !valid(d0) || (dirs == 2 && !valid(d1)) ||
      (full && (d0.bias == nullptr || dirs != 1)))
    return cudaErrorInvalidValue;
  int bytes = smem_bytes(d0.sq, d0.sk);
  if (dirs == 2 && smem_bytes(d1.sq, d1.sk) > bytes) bytes = smem_bytes(d1.sq, d1.sk);
  void (*kernel)(Dir, Dir, int, float) = full ? &attn_core_kernel<true> : &attn_core_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(num_heads / HPC, B, dirs);
  kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(d0, d1, H, 0.125f /* 1/sqrt(64) */);
  return cudaGetLastError();
}

const __nv_bfloat16* bf(const void* p) { return static_cast<const __nv_bfloat16*>(p); }

}  // namespace

extern "C" {

int kmr_attn_max_seq() { return MAX_S; }
int kmr_attn_head_dim() { return DH; }
int kmr_attn_head_group() { return HPC; }

// qkv [B*S, 3H] bf16, bias f32 [B, S] (full_bias 0) or [B, S, S] (full_bias 1) or null,
// ctx [B*S, H] bf16; H = num_heads * 64.
int kmr_attn_core(const void* qkv, const void* bias, int full_bias, void* ctx, int B, int S, int H,
                  int num_heads, void* stream) {
  const Dir d{bf(qkv), bf(qkv) + H, bf(qkv) + 2 * H, static_cast<const float*>(bias),
              static_cast<__nv_bfloat16*>(ctx), 3 * H, 3 * H, S, S};
  return launch(d, d, 1, full_bias != 0, B, H, num_heads, stream);
}

// q rows at stride q_ld ([B*Sq] rows), k and v rows at stride kv_ld ([B*Sk] rows),
// bias f32 [B, Sk] (full_bias 0) or [B, Sq, Sk] (full_bias 1) or null, ctx [B*Sq, H] bf16.
// Pointers and strides 16-byte aligned.
int kmr_attn_cross(const void* q, const void* k, const void* v, const void* bias, int full_bias, void* ctx,
                   int q_ld, int kv_ld, int B, int Sq, int Sk, int H, int num_heads, void* stream) {
  const Dir d{bf(q), bf(k), bf(v), static_cast<const float*>(bias),
              static_cast<__nv_bfloat16*>(ctx), q_ld, kv_ld, Sq, Sk};
  return launch(d, d, 1, full_bias != 0, B, H, num_heads, stream);
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
  return launch(lang, visn, 2, false, B, H, num_heads, stream);
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
