// Tail of a fused post-LN encoder layer: everything after the attention core.
//
//   y   = ctx @ Wo + bo + x                  f32, registers
//   a   = bf16(LN1(y))                       shared memory, never device memory
//   h_c = bf16(gelu(a @ W1[:, c] + b1[c]))   one 192-column chunk c at a time, shared memory
//   z   = sum_c h_c @ W2[c, :] + b2 + a      f32, registers
//   out = bf16(LN2(z))
//
// ctx, x, out [M, 768] bf16; Wo [768, 768], W1 [768, I], W2 [I, 768] bf16
// row-major (the JAX [in, out] kernel layout); biases, gammas and betas f32;
// I % 64 == 0 (the last chunk holds the remainder); tanh or erf GELU (erff,
// where the TPU needed a polynomial).
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
// Bound on the H100 at ImageBERT-B's B=512, S=30 (M = 15,360 rows):
// operations, 163 GFLOP (0.165 ms at the bf16 tensor-core rate) against ~71 MB
// of activations in and out and 10.6 MB of weights. LayerNorm needs whole rows,
// and a row's FFN sum z lives in registers for the whole loop over I, beside
// the up-projection chunk's sum: the register file sets the rows a CTA holds
// (64 rows x 768 f32 would be 196 KB of the SM's 256 KB), and with them the
// weight bytes that must reach an SM per row. The version before this one
// (WMMA mma.sync out of a cp.async ring every thread addressed, a block
// barrier at every K tile) read every weight through L2 once per 32 rows. The
// design:
//   - 32 rows a CTA, two CTAs a thread-block cluster: each weight tile crosses
//     L2 once per 64 rows. One producer warp a CTA keeps a 5-stage ring of
//     24 KB weight tiles in flight by TMA, each CTA loading half of a stage's
//     boxes multicast into both CTAs' rings; a stage is released to both
//     producers once the consumers of both CTAs are done with it (remote
//     mbarrier arrivals, released at CTA scope: a cluster-scope release on
//     every stage made the kernel several times slower).
//   - The products on wgmma with the operands swapped: z^T [768, 32] = W^T @
//     act^T, the hidden features as wgmma's 64-row M (the weight tile, read
//     MN-major, the transpose bit set) and the 32 rows as its N (the
//     activations, K-major), so 32 rows need no padding to wgmma's 64. Three
//     consumer warpgroups own 256 features each: 4 m64n32 tiles of z, 64
//     registers a thread, and one m64n32 tile of the 192-feature chunk, 16
//     more (four warpgroups and the producer warp leave 96 registers a thread,
//     and spilled).
//   - The activations are wgmma B operands in shared memory in the 128-byte
//     swizzled layout: ctx arrives by TMA, a (LN1's output) and each GELU
//     chunk are written there by the threads that compute them. The FFN is one
//     stream of stages: chunk c + 1's up-projection is issued ahead of chunk
//     c's down-projection and its GELU written, into the next of three chunk
//     buffers, while the down-projection runs.
//   - k order: one f32 accumulator an output, k ascending 16 at a time, as
//     gemm_bf16.cu; wgmma rounds each 16-term step alike at m64n128 and, with
//     the operands swapped, m64n32 on the H100, which keeps the fused layer
//     bit-equal to the two-block route.
//   - Each LayerNorm stages the f32 sums as rows in shared memory (the chunk
//     buffers' space), 8 rows at a time, and one warp a row adds bias and
//     residual and normalises with gemm_bf16.cu's epilogue and layernorm.cu's
//     arithmetic, operation for operation.
// What bounds it now (PERF.md): with 32 rows a CTA every SM still receives
// all 10.6 MB of weights per 32 rows, and the weight stream alone (no
// products) takes ~0.56 ms at B's shape; a cluster that splits 64 rows'
// features between its CTAs halves those bytes but measured slower, its
// cross-CTA exchanges and two consumer warpgroups costing more than it saved.
// Rows past M arrive as zeros (TMA) and are never stored. 210 KB of shared
// memory: one CTA an SM.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int H = 768;
constexpr int BM = 32;                        // rows a CTA
constexpr int CLUSTER = 2;                    // CTAs sharing each weight tile
constexpr int CONSUMERS = 3;                  // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32; // and one producer warp
constexpr int CI = 64 * CONSUMERS;            // FFN features a chunk: one m64 tile a warpgroup
constexpr int FW = 64;                        // ... of which the last one may hold any multiple of FW
constexpr int FT = H / 64 / CONSUMERS;        // m64 tiles of the 768 features a warpgroup
constexpr int STAGES = 5;
constexpr int HBUFS = 3;                      // GELU chunk buffers: chunk c + 1 is written while c is read
constexpr int BK_WIDE = 16;                   // k rows a stage of the 768-wide products (Wo, W2)
constexpr int BK_UP = 64;                     // k rows a stage of a chunk's up-projection (W1)
constexpr int STAGE_BYTES = BK_WIDE * H * 2;  // 12 TMA boxes of [16 k x 64 features]
static_assert(STAGE_BYTES == BK_UP * CI * 2, "the two stage shapes fill the same bytes (3 boxes of [64 x 64])");
constexpr int WIDE_BOX = BK_WIDE * 128, UP_BOX = BK_UP * 128;
constexpr int ACT_BLOCK = BM * 128;           // an activation block: BM rows of 64 k values
constexpr int Y_LD = H + 4;                   // f32 stride of the LayerNorm staging rows
constexpr int PASS = 8;                       // rows a LayerNorm pass stages: accumulator column octet j = pass
constexpr int VEC = H / 128;                  // float4s a lane holds of a row in the LayerNorm pass
constexpr int RING = 0;
constexpr int ACT = RING + STAGES * STAGE_BYTES;   // ctx, then a: [BM, 768] K-major, swizzled
constexpr int HBUF = ACT + (H / 64) * ACT_BLOCK;   // HBUFS GELU chunks: [BM, CI] K-major, swizzled
constexpr int HBUF_BYTES = (CI / 64) * ACT_BLOCK;
constexpr int STAGING = HBUF;                      // the LayerNorm rows, while no GELU chunk is live
constexpr int BARS = HBUF + HBUFS * HBUF_BYTES;    // full[STAGES], empty[STAGES], the ctx load's
constexpr int SMEM_BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + slack to align to the swizzle atom
static_assert(PASS == 8 && PASS * Y_LD * 4 <= HBUFS * HBUF_BYTES, "a pass stages one accumulator column octet");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a Hopper CTA may have");

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// Byte offset of (row, k) in a K-major activation buffer: 64-k blocks of BM rows x 128 bytes,
// 128-byte swizzled (the layout TMA writes and wgmma reads).
__device__ __forceinline__ int swz(int row, int k) {
  return (k >> 6) * ACT_BLOCK + row * 128 + ((((k & 63) >> 3) ^ (row & 7)) << 4) + ((k & 7) << 1);
}

// d[64 features x 32 rows] += W^T[64 x 16] @ act^T[16 x 32]: A the weight tile, MN-major (transpose
// bit set), B the activations, K-major.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
// k step g (16 k values) of the activation buffer at act
__device__ __forceinline__ uint64_t act_desc(uint32_t act, int g) {
  return smem_desc(act + (g >> 2) * ACT_BLOCK + (g & 3) * 32, 16, 1024);
}
// k step kk of the weight box at box (BOX bytes: its k rows x 128 bytes)
template <int BOX>
__device__ __forceinline__ uint64_t w_desc(uint32_t box, int kk) {
  return smem_desc(box + kk * 2048, BOX, 1024);
}

// The ring as a consumer warpgroup sees it: stage g % STAGES is the g-th since the start. Each stage's
// products are one wgmma group; the group before it is waited for, and its stage released, once the
// stage's own group is issued, so one group is always queued behind the running one.
struct Ring {
  uint32_t base, full, empty;
  int g = 0;             // the next stage
  bool pending = false;  // stage g - 1 is issued and not yet released
  __device__ __forceinline__ uint32_t acquire() const {
    mbar_wait(full + 8 * (g % STAGES), (g / STAGES) & 1);
    wgmma_fence();
    return base + (g % STAGES) * STAGE_BYTES;
  }
  // stage s is read by this warpgroup: one arrival on its empty barrier in each CTA of the cluster
  __device__ __forceinline__ void release(int s) const {
    if (threadIdx.x % 128 == 0)
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(empty + 8 * (s % STAGES), r);
  }
  // after the stage's products are issued: every group but this one is done
  __device__ __forceinline__ void issued() {
    wgmma_commit();
    wgmma_wait<1>();
    if (pending) release(g - 1);
    pending = true;
    ++g;
  }
  // every group is done
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    if (pending) release(g - 1);
    pending = false;
  }
};

template <int R, int N>
__device__ __forceinline__ void fence_tiles(float (&d)[R][N]) {
#pragma unroll
  for (int i = 0; i < R; ++i) fence_acc(d[i]);
}

// One wide stage: z[i] (features 64 * (FT * wg + i) ..) += W^T @ act^T at act's k step ks.
__device__ __forceinline__ void wide_stage(float (&z)[FT][16], uint32_t act, int ks, Ring& ring, int wg) {
  const uint32_t stage = ring.acquire();
  const uint64_t db = act_desc(act, ks);
#pragma unroll
  for (int i = 0; i < FT; ++i) wgmma_n32(z[i], w_desc<WIDE_BOX>(stage + (FT * wg + i) * WIDE_BOX, 0), db);
  ring.issued();
}

// One up-projection stage: u (chunk features 64 * wg ..) += W1^T @ a^T over k rows [BK_UP ks, + BK_UP).
// Where a last, narrower chunk ends before the warpgroup's features, the products run on whatever the
// box holds and u is never read (a branch around wgmma made every stage slower).
__device__ __forceinline__ void up_stage(float (&u)[16], uint32_t act, int ks, Ring& ring, int wg) {
  const uint32_t stage = ring.acquire();
#pragma unroll
  for (int kk = 0; kk < BK_UP / 16; ++kk)  // k ascending, 16 at a time
    wgmma_n32(u, w_desc<UP_BOX>(stage + wg * UP_BOX, kk), act_desc(act, ks * (BK_UP / 16) + kk));
  ring.issued();
}

// FFN features of chunk c of I: CI, but for a last chunk of fewer
__host__ __device__ __forceinline__ int chunk_width(int c, int I) { return I - CI * c < CI ? I - CI * c : CI; }

__device__ __forceinline__ float4 unpack4(uint2 raw) {
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(__bfloat162float(b[0]), __bfloat162float(b[1]), __bfloat162float(b[2]), __bfloat162float(b[3]));
}

// LayerNorm over the CTA's rows of the [768, BM] sums held transposed in z: PASS rows at a time,
// the consumers stage their sums as f32 rows (ys, stride Y_LD), then one warp a row computes
// (sum + bias) + residual and LayerNorm with the arithmetic of gemm_bf16.cu's residual epilogue
// followed by layernorm.cu's kernel, operation for operation (lane l holds float4s l, l + 32, ..),
// handing store(row, float4 index, 4 packed bf16) the output. residual(row, c4) gives the 4
// residual values of float4 c4 of the row. Rows are the CTA's, 0 .. BM - 1.
template <class Residual, class Store>
__device__ __forceinline__ void ln_rows(const float (&z)[FT][16], float* ys, const float* __restrict__ bias,
                                        Residual residual, const float* __restrict__ gamma,
                                        const float* __restrict__ beta, float eps, Store store) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const float4* b4 = reinterpret_cast<const float4*>(bias);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* t4 = reinterpret_cast<const float4*>(beta);
#pragma unroll
  for (int pass = 0; pass < BM / PASS; ++pass) {
    bar_sync<CONSUMERS * 128>(1);  // the staging rows are free
    // accumulator element 4j + 2e + q: feature 16 * warp + lane / 4 + 8e of the tile, row 8j + 2 (lane % 4) + q
#pragma unroll
    for (int i = 0; i < FT; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int row = 2 * (lane % 4) + q, f = 64 * (FT * wg + i) + 16 * warp + lane / 4 + 8 * e;
          ys[row * Y_LD + f] = z[i][4 * pass + 2 * e + q];
        }
    bar_sync<CONSUMERS * 128>(1);
    for (int srow = threadIdx.x / 32; srow < PASS; srow += CONSUMERS * 4) {
      const int row = PASS * pass + srow;
      const float4* src = reinterpret_cast<const float4*>(ys + srow * Y_LD);
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
}

template <bool ERF>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
layer_tail_kernel(const __grid_constant__ CUtensorMap map_ctx, const __grid_constant__ CUtensorMap map_wo,
                  const __grid_constant__ CUtensorMap map_w1, const __grid_constant__ CUtensorMap map_w2,
                  const __nv_bfloat16* __restrict__ x, const float* __restrict__ bo,
                  const float* __restrict__ g1, const float* __restrict__ be1, const float* __restrict__ b1,
                  const float* __restrict__ b2, const float* __restrict__ g2, const float* __restrict__ be2,
                  __nv_bfloat16* __restrict__ out, int M, int I, float eps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // the swizzle atom's alignment
  unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
  Ring ring{base + RING, base + BARS, base + BARS + 8 * STAGES};
  const uint32_t act = base + ACT, act_bar = base + BARS + 16 * STAGES;
  const int m0 = blockIdx.x * BM, chunks = (I + CI - 1) / CI;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, CLUSTER * CONSUMERS);
    }
    mbar_init(act_bar, 1);
    fence_barrier_init();
  }
  cluster_sync();  // both CTAs' barriers exist before either multicasts

  if (threadIdx.x >= CONSUMERS * 128) {
    // The producer: one thread loads the ctx rows, then every weight stage in the consumers' order,
    // its half of each stage's boxes multicast into both CTAs' rings.
    if (threadIdx.x == CONSUMERS * 128) {
      const uint32_t rank = cluster_rank();
      prefetch_map(&map_wo);
      prefetch_map(&map_w1);
      prefetch_map(&map_w2);
      mbar_expect_tx(act_bar, (H / 64) * ACT_BLOCK);
      for (int b = 0; b < H / 64; ++b) tma_load(act + b * ACT_BLOCK, &map_ctx, act_bar, 64 * b, m0);
      int g = 0;
      auto stage = [&](int& gg, int bytes) {  // the next stage, free in both CTAs, armed for its bytes
        const int s = gg % STAGES;
        mbar_wait(ring.empty + 8 * s, ((gg / STAGES) & 1) ^ 1);  // the first round finds every stage free
        mbar_expect_tx(ring.full + 8 * s, bytes);
        return s;
      };
      const uint16_t both = (1u << CLUSTER) - 1;
      for (int ks = 0; ks < H / BK_WIDE; ++ks, ++g) {  // Wo
        const int s = stage(g, STAGE_BYTES);
        for (int b = rank; b < H / 64; b += CLUSTER)
          tma_load_multicast(ring.base + s * STAGE_BYTES + b * WIDE_BOX, &map_wo, ring.full + 8 * s, 64 * b,
                             BK_WIDE * ks, both);
      }
      auto up = [&](int c) {  // W1[:, chunk c]
        const int w = chunk_width(c, I);
        for (int ks = 0; ks < H / BK_UP; ++ks, ++g) {
          const int s = stage(g, BK_UP * w * 2);
          for (int b = rank; b < w / 64; b += CLUSTER)
            tma_load_multicast(ring.base + s * STAGE_BYTES + b * UP_BOX, &map_w1, ring.full + 8 * s, CI * c + 64 * b,
                               BK_UP * ks, both);
        }
      };
      up(0);
      for (int c = 0; c < chunks; ++c) {  // the consumers' order: W1[:, chunk c + 1], then W2[chunk c, :]
        if (c + 1 < chunks) up(c + 1);
        for (int ks = 0; ks < chunk_width(c, I) / BK_WIDE; ++ks, ++g) {
          const int s = stage(g, STAGE_BYTES);
          for (int b = rank; b < H / 64; b += CLUSTER)
            tma_load_multicast(ring.base + s * STAGE_BYTES + b * WIDE_BOX, &map_w2, ring.full + 8 * s, 64 * b,
                               CI * c + BK_WIDE * ks, both);
        }
      }
    }
  } else {
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float* ys = reinterpret_cast<float*>(smem + STAGING);
    unsigned char* act_s = smem + ACT;
    float z[FT][16];
#pragma unroll
    for (int i = 0; i < FT; ++i)
#pragma unroll
      for (int r = 0; r < 16; ++r) z[i][r] = 0.0f;
    fence_tiles(z);
    mbar_wait(act_bar, 0);

    // y = ctx @ Wo + bo + x; a = bf16(LN1(y)) over the ctx rows
    for (int ks = 0; ks < H / BK_WIDE; ++ks) wide_stage(z, act, ks, ring, wg);
    ring.drain();
    fence_tiles(z);
    ln_rows(
        z, ys, bo,
        [&](int row, int c4) {
          return m0 + row < M ? unpack4(reinterpret_cast<const uint2*>(x + (size_t)(m0 + row) * H)[c4])
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        },
        g1, be1, eps, [&](int row, int c4, uint2 p) { *reinterpret_cast<uint2*>(act_s + swz(row, 4 * c4)) = p; });
    fence_proxy_async();            // a, written by these threads, is read by wgmma
    bar_sync<CONSUMERS * 128>(1);

    // The FFN, one chunk of CI features at a time: u = a @ W1[:, c + 1] is issued ahead of
    // z += h_c @ W2[c, :], and its GELU written to the next chunk buffer while the down-projection
    // runs. Element 4j + 2e + q of u is feature 64 wg + 16 warp + lane / 4 + 8e of the chunk,
    // row 8j + 2 (lane % 4) + q.
    float u[16], ub[2];  // and u's two biases
    auto live = [&](int c) { return 64 * wg < chunk_width(c, I); };  // the chunk reaches this warpgroup's features
    auto up = [&](int c) {
      if (live(c)) {
        ub[0] = b1[CI * c + 64 * wg + 16 * warp + lane / 4];
        ub[1] = b1[CI * c + 64 * wg + 16 * warp + lane / 4 + 8];
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) u[r] = 0.0f;
      fence_acc(u);
      for (int ks = 0; ks < H / BK_UP; ++ks) up_stage(u, act, ks, ring, wg);
    };
    auto gelu_chunk = [&](int c) {  // h_c = bf16(gelu(u + b1[c])) into chunk buffer c % HBUFS
      fence_acc(u);
      if (!live(c)) return;
      unsigned char* h = smem + HBUF + (c % HBUFS) * HBUF_BYTES;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = 64 * wg + 16 * warp + lane / 4 + 8 * e;
        const float bias = ub[e];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float t = u[4 * j + 2 * e + q] + bias;
            *reinterpret_cast<__nv_bfloat16*>(h + swz(8 * j + 2 * (lane % 4) + q, f)) =
                __float2bfloat16(ERF ? gelu_erf(t) : gelu_tanh(t));
          }
      }
      fence_proxy_async();  // read by wgmma
    };
#pragma unroll
    for (int i = 0; i < FT; ++i)
#pragma unroll
      for (int r = 0; r < 16; ++r) z[i][r] = 0.0f;
    fence_tiles(z);
    up(0);
    ring.drain();
    gelu_chunk(0);
    bar_sync<CONSUMERS * 128>(1);
    for (int c = 0; c < chunks; ++c) {
      const bool next = c + 1 < chunks;
      const uint32_t h = base + HBUF + (c % HBUFS) * HBUF_BYTES;
      if (next) up(c + 1);
      wide_stage(z, h, 0, ring, wg);  // its issue waits out every earlier group: u is final
      if (next) gelu_chunk(c + 1);    // buffer (c + 1) % HBUFS was last read by chunk c - 2's products
      for (int ks = 1; ks < chunk_width(c, I) / BK_WIDE; ++ks) wide_stage(z, h, ks, ring, wg);
      bar_sync<CONSUMERS * 128>(1);   // chunk c + 1 is whole
    }
    ring.drain();
    fence_tiles(z);

    // out = bf16(LN2(z + b2 + a))
    ln_rows(
        z, ys, b2, [&](int row, int c4) { return unpack4(*reinterpret_cast<const uint2*>(act_s + swz(row, 4 * c4))); },
        g2, be2, eps, [&](int row, int c4, uint2 p) {
          if (m0 + row < M) reinterpret_cast<uint2*>(out + (size_t)(m0 + row) * H)[c4] = p;
        });
  }
  cluster_sync();  // no CTA leaves while its partner may still arrive on its barriers
}

template <bool ERF>
cudaError_t launch(const void* ctx, const void* x, const void* wo, const void* bo, const void* g1,
                   const void* be1, const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* g2, const void* be2, void* out, int M, int I, float eps, cudaStream_t stream) {
  CUtensorMap map_ctx, map_wo, map_w1, map_w2;
  const bool ok = tensor_map(&map_ctx, ctx, M, H, BM) && tensor_map(&map_wo, wo, H, H, BK_WIDE) &&
                  tensor_map(&map_w1, w1, H, I, BK_UP) && tensor_map(&map_w2, w2, I, H, BK_WIDE);
  if (!ok) return cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory needs the opt-in (set per device)
  cudaError_t err = cudaFuncSetAttribute(layer_tail_kernel<ERF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int ctas = (M + CLUSTER * BM - 1) / (CLUSTER * BM) * CLUSTER;  // whole clusters
  using bf = __nv_bfloat16;
  layer_tail_kernel<ERF><<<ctas, THREADS, SMEM_BYTES, stream>>>(
      map_ctx, map_wo, map_w1, map_w2, static_cast<const bf*>(x), static_cast<const float*>(bo),
      static_cast<const float*>(g1), static_cast<const float*>(be1), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(g2), static_cast<const float*>(be2),
      static_cast<bf*>(out), M, I, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape constraints, exported so the Python wrapper checks shapes before a launch.
int kmr_layer_tail_hidden() { return H; }
int kmr_layer_tail_chunk() { return FW; }
int kmr_layer_tail_smem_bytes() { return SMEM_BYTES; }

int kmr_layer_tail(const void* ctx, const void* x, const void* wo, const void* bo, const void* g1,
                   const void* be1, const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* g2, const void* be2, void* out, int M, int I, int erf_gelu, float eps,
                   void* stream) {
  if (M <= 0 || I <= 0 || I % FW != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return erf_gelu ? launch<true>(ctx, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, out, M, I, eps, s)
                  : launch<false>(ctx, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2, out, M, I, eps, s);
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
