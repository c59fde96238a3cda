// Tiled bf16 GEMM with fused epilogues for Hopper (sm_90a): out = epilogue(A @ W + bias).
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
// These are the products and rounding points of the Pallas bodies this
// replaces: attention_block_pallas (ops/pallas_attention.py:200-203 and
// :228-236), ffn_block_pallas (ops/pallas_ffn.py:45-56) and the train bodies
// (ops/pallas_train.py:182-188, :210-217, :240-252, :593-596, :796-799,
// :850-855).
//
// Bound on the H100 at the main path's shapes (ImageBERT-A at B=512: M =
// 20,480 rows, K and N 768-3072): operations, the bf16 tensor-core rate, for
// all but the out-projection ([20480x768]x[768x768] + a residual in, f32 out),
// which moves more bytes than it multiplies. Only wgmma reaches that rate; the
// first version of this kernel (WMMA fragments from padded shared memory, a
// cp.async ring addressed by all 256 threads, an epilogue through a per-warp
// staging tile) ran at 14-18% of the peak. The design:
//   - Main loop: TMA loads (cp.async.bulk.tensor, 128-byte swizzle) into a ring
//     of STAGES stages of [128 x 64] A and [64 x 128] W in dynamic shared
//     memory, one "full" and one "empty" mbarrier a stage; A is K-major, W is
//     MN-major ([K, N], the wgmma transpose bit) or, with TRANS_B, K-major
//     ([N, K]); TMA zero-fills the rows past M. The tensor maps are encoded on
//     the host for every launch (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint, so the library needs no -lcuda) and passed as
//     __grid_constant__ parameters.
//   - Warp specialisation: one producer warp (one thread issues every load)
//     and two consumer warpgroups, each issuing wgmma.mma_async m64n128k16
//     (f32 += bf16 x bf16) over BK = 64 a stage, one group in flight before it
//     releases a stage.
//   - Persistent ping-pong: one CTA an SM walks 128 x 128 output tiles; the two
//     warpgroups take the CTA's tiles in turn, each a whole tile (two m64n128
//     accumulators, 128 registers a thread), and take turns at the tensor
//     cores (named barriers), so that one runs its main loop while the other
//     runs its epilogue: the epilogue (GELU, the residual and aux traffic)
//     costs no tensor-core time. A cooperative 128 x 256 tile (both
//     warpgroups on one tile, the epilogue not overlapped) measured slower at
//     every site but ImageBERT-B's label conv (PERF.md).
//   - The epilogue starts from the accumulator registers (a thread holds rows
//     16 * warp + lane / 4 and + 8 of each 64-row half, columns 2 * (lane % 4)
//     + 8j and + 1) and keeps the arithmetic of the version before: f32 bias,
//     GELU and residual, one cast. It moves its matrices by TMA through a
//     per-warpgroup area of shared memory, one 64-row half at a time, in the
//     128-byte-swizzled layout, so the pairs a warp writes or reads land in
//     distinct banks: the residual or aux input is loaded while the main loop
//     runs (zero past M), the output (and the _SAVE epilogues' u) leaves by
//     TMA stores, which clip the rows past M.
//   - Tile order: row-major; in groups of GROUP_M m-tiles, column by column,
//     when W does not fit in L2 beside A (the label conv's 75 MB weight).
//   - k order: one f32 accumulator per output, k ascending, 16 at a time.
//     wgmma's m64nNk16 step rounds as mma.sync's m16n8k16 did on the H100 (the
//     two kernels' f32 sums came out bit-equal), and as layer_tail.cu's
//     m64n32k16 with the operands swapped, which the fused layer's
//     bit-equality with the two blocks relies on.
// Shape rules: N % 128 == 0 and K % 64 == 0 (kmr_gemm_tile_n/_k), which every
// BERT-base width is (768, 1536, 2304, 3072, 6144); any M > 0.

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128, BN = 128, BK = 64;    // a tile; k values a stage (128 bytes of bf16)
constexpr int THREADS = 2 * 128 + 32;         // two consumer warpgroups and one producer warp
constexpr int STAGES = 4;
constexpr int A_STAGE_BYTES = BM * BK * 2;    // 128 rows of 128 bytes
constexpr int W_BLOCK_BYTES = BK * 64 * 2;    // MN-major W: a TMA box of 64 k rows x 64 n values
constexpr int STAGE_BYTES = A_STAGE_BYTES + BK * BN * 2;
constexpr int BOX_BYTES = 64 * 128;           // an epilogue TMA box: 64 rows of 128 bytes
constexpr int AREA_BYTES = 6 * BOX_BYTES;     // a warpgroup's epilogue area: output staging + input
constexpr int EPI_J = 4;                      // column octets whose bias loads the epilogue issues together
constexpr int GROUP_M = 8;                    // m-tiles a group of the grouped tile order
constexpr long long GROUP_W_BYTES = 24ll << 20;  // W bytes from which the tiles go in groups (half of L2)
// the ring, the two epilogue areas, a full and an empty barrier a stage and one a warpgroup (its
// epilogue input's), and slack to align the ring to 1024 bytes (the swizzle atom)
constexpr int BARRIERS = STAGES * STAGE_BYTES + 2 * AREA_BYTES;  // offset of the barriers from the ring
constexpr int SMEM_BYTES = BARRIERS + (2 * STAGES + 2) * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "more shared memory than a Hopper CTA may have");

enum {
  EPI_BIAS = 0, EPI_GELU_TANH = 1, EPI_GELU_ERF = 2, EPI_RESIDUAL = 3, EPI_F32 = 4,
  EPI_GELU_TANH_SAVE = 5, EPI_GELU_ERF_SAVE = 6, EPI_GELU_BWD_TANH = 7, EPI_GELU_BWD_ERF = 8,
  EPI_RESIDUAL_F32 = 9
};
__host__ __device__ constexpr bool f32_out(int epi) { return epi == EPI_RESIDUAL || epi == EPI_F32; }
__host__ __device__ constexpr bool saves_u(int epi) { return epi == EPI_GELU_TANH_SAVE || epi == EPI_GELU_ERF_SAVE; }
__host__ __device__ constexpr bool reads_aux(int epi) {
  return epi == EPI_GELU_BWD_TANH || epi == EPI_GELU_BWD_ERF || epi == EPI_RESIDUAL_F32;
}
// bytes an element of the output, and of the second input (residual bf16, aux f32; 0: none)
__host__ __device__ constexpr int out_bytes(int epi) { return f32_out(epi) ? 4 : 2; }
__host__ __device__ constexpr int in_bytes(int epi) { return epi == EPI_RESIDUAL ? 2 : reads_aux(epi) ? 4 : 0; }

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

// ---- operand descriptors (sm90.cuh's smem_desc) ----

// K-major (A, and W with TRANS_B): rows of 64 k values, 8-row groups 1024 bytes apart; MN-major
// (W [K, N]): 64-wide n blocks W_BLOCK_BYTES apart (LBO), 8-row k groups 1024 bytes apart (SBO).

// rows [row, row + 64) of a stage's A tile, and the stage's W tile, at k step kk (16 k values)
__device__ __forceinline__ uint64_t a_desc(uint32_t a_tile, int row, int kk) {
  return smem_desc(a_tile + row * 128 + 32 * kk, 16, 1024);
}
template <bool TRANS_B>
__device__ __forceinline__ uint64_t w_desc(uint32_t w_tile, int kk) {
  return TRANS_B ? smem_desc(w_tile + 32 * kk, 16, 1024) : smem_desc(w_tile + 16 * 128 * kk, W_BLOCK_BYTES, 1024);
}

// d[64 x 128] += A[64 x 16] @ B[16 x 128], both from shared memory; MN_MAJOR_B is the
// instruction's B transpose bit (1 for W [K, N] with n contiguous).
template <int MN_MAJOR_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(MN_MAJOR_B));
}

// One stage's TMA loads: the [128, 64] A box at (m0, k0) and W's [64, 128] (or, with TRANS_B,
// [128, 64]) at (k0, n0).
template <bool TRANS_B>
__device__ __forceinline__ void load_stage(uint32_t dst, uint32_t bar, const CUtensorMap* map_a,
                                           const CUtensorMap* map_w, int m0, int n0, int k0) {
  mbar_expect_tx(bar, STAGE_BYTES);
  tma_load(dst, map_a, bar, k0, m0);
  if (TRANS_B) {
    tma_load(dst + A_STAGE_BYTES, map_w, bar, k0, n0);  // 128 rows of 64 k values
  } else {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)  // two boxes of 64 k rows x 64 n values
      tma_load(dst + A_STAGE_BYTES + j * W_BLOCK_BYTES, map_w, bar, n0 + 64 * j, k0);
  }
}

// ---- the epilogue ----

// The output pair of (v0, v1) = acc + bias, in f32 ahead of the one cast of bf16 outputs; in: the
// second input's pair at the same place.
template <int EPI>
__device__ __forceinline__ float2 finish(float v0, float v1, float2 in) {
  if (EPI == EPI_RESIDUAL) return make_float2(v0 + in.x, v1 + in.y);
  if (EPI == EPI_F32) return make_float2(v0, v1);
  float x[2] = {v0, v1};
  const float a[2] = {in.x, in.y};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (EPI == EPI_GELU_TANH || EPI == EPI_GELU_TANH_SAVE) x[e] = gelu_tanh(x[e]);
    if (EPI == EPI_GELU_ERF || EPI == EPI_GELU_ERF_SAVE) x[e] = gelu_erf(x[e]);
    if (EPI == EPI_GELU_BWD_TANH) x[e] = __fmul_rn(x[e], gelu_bwd_tanh(a[e]));
    if (EPI == EPI_GELU_BWD_ERF) x[e] = __fmul_rn(x[e], gelu_bwd_erf(a[e]));
    if (EPI == EPI_RESIDUAL_F32) x[e] = __fadd_rn(x[e], a[e]);
  }
  return make_float2(x[0], x[1]);
}

// A warpgroup's epilogue area holds one 64-row half of its tile's output (staging, at the area's
// start) and of its second input (after the output's bytes), each as 128-byte-swizzled TMA boxes of
// 64 rows x 128 bytes (box b of the half's columns at b * BOX_BYTES). E: bytes an element.
template <int E>
__device__ __forceinline__ unsigned char* staged(unsigned char* base, int r, int c) {
  const int byte = c * E;
  return base + (byte >> 7) * BOX_BYTES + r * 128 + ((((byte >> 4) & 7) ^ (r & 7)) << 4) + (byte & 15);
}

// The second input's rows [m0, m0 + 64) x columns [n0, n0 + 128) into the input buffer at dst.
template <int EPI>
__device__ __forceinline__ void load_in_half(uint32_t dst, uint32_t bar, const CUtensorMap* map_x, int m0, int n0) {
  constexpr int E = in_bytes(EPI);
  mbar_expect_tx(bar, E * BOX_BYTES);
#pragma unroll
  for (int b = 0; b < E; ++b) tma_load(dst + b * BOX_BYTES, map_x, bar, n0 + b * (128 / E), m0);
}

// One 64-row half (rows [m0, m0 + 64)) of a warpgroup's tile out through its epilogue area (area,
// at shared address area_addr). U: the half's u = acc + bias (the _SAVE epilogues' f32 aux output),
// else its output, with its second input, whose TMA load the warpgroup's issuing thread started
// earlier on in_bar (the in_loads-th). next_m0 >= 0: the issuing thread then starts the input of the
// half at next_m0. map: the tensor map stored to; map_x: the second input's.
template <int EPI, bool U>
__device__ __forceinline__ void store_half(const float (&acc)[64], unsigned char* area, uint32_t area_addr,
                                           const CUtensorMap* map, const CUtensorMap* map_x, uint32_t in_bar,
                                           int& in_loads, int bar_id, int m0, int n0, int next_m0,
                                           const float* __restrict__ bias) {
  constexpr int E = U ? 4 : out_bytes(EPI), EI = U ? 0 : in_bytes(EPI);
  const bool issuer = threadIdx.x % 128 == 0;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int rl = 16 * warp + lane / 4, cl = 2 * (lane % 4);  // the thread's first row and column in the half
  unsigned char* in_buf = area + out_bytes(EPI) * BOX_BYTES;
  if (issuer) bulk_wait<true>();  // the staging's previous store has read it
  bar_sync<128>(bar_id);
  if (EI) mbar_wait(in_bar, in_loads++ & 1);
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += EPI_J) {
    float2 bv[EPI_J];
#pragma unroll
    for (int j = 0; j < EPI_J; ++j)
      bv[j] = bias != nullptr ? *reinterpret_cast<const float2*>(bias + n0 + cl + 8 * (j0 + j)) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < EPI_J; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = 4 * (j0 + j) + 2 * h, r = rl + 8 * h, c = cl + 8 * (j0 + j);
        const float v0 = acc[a] + bv[j].x, v1 = acc[a + 1] + bv[j].y;
        float2 in = make_float2(0.0f, 0.0f);
        if (EI == 2) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(staged<2>(in_buf, r, c));
          in = make_float2(__low2float(x), __high2float(x));
        } else if (EI == 4) {
          in = *reinterpret_cast<const float2*>(staged<4>(in_buf, r, c));
        }
        if (U) {
          *reinterpret_cast<float2*>(staged<4>(area, r, c)) = make_float2(v0, v1);
        } else {
          const float2 o = finish<EPI>(v0, v1, in);
          if (E == 4)
            *reinterpret_cast<float2*>(staged<4>(area, r, c)) = o;
          else
            *reinterpret_cast<__nv_bfloat162*>(staged<2>(area, r, c)) = __floats2bfloat162_rn(o.x, o.y);
        }
      }
    }
  }
  fence_proxy_async();
  bar_sync<128>(bar_id);  // the staging is written and the input buffer read
  if (issuer) {
#pragma unroll
    for (int b = 0; b < E; ++b)  // the half's 128 columns in E boxes of 128 bytes
      tma_store(map, area_addr + b * BOX_BYTES, n0 + b * (128 / E), m0);
    bulk_commit();
    if (EI && next_m0 >= 0) load_in_half<EPI>(area_addr + out_bytes(EPI) * BOX_BYTES, in_bar, map_x, next_m0, n0);
  }
}

// The origin of the t-th tile: row-major (group_m = 1), or in groups of group_m m-tiles walked
// column by column, so that the tiles in flight at once share their W columns in L2.
__device__ __forceinline__ void tile_origin(int t, int m_tiles, int n_tiles, int group_m, int& m0, int& n0) {
  const int first = t / (group_m * n_tiles) * group_m, in_group = t % (group_m * n_tiles);
  const int rows = m_tiles - first < group_m ? m_tiles - first : group_m;
  m0 = (first + in_group % rows) * BM;
  n0 = in_group / rows * BN;
}

// ---- the kernel ----

// One CTA an SM walks tiles blockIdx.x, + gridDim.x, ...: consumer warpgroup 0 takes its 1st, 3rd,
// .. tile, warpgroup 1 its 2nd, 4th, ... The producer loads the tiles' stages in that order, and
// the warpgroups take turns at the tensor cores (named barriers 1 and 2). The epilogue moves its
// matrices by TMA: the output to map_out, and map_x, the second matrix: the _SAVE epilogues' u out,
// or the residual or aux in.
template <int EPI, bool TRANS_B>
__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_out, const __grid_constant__ CUtensorMap map_x,
                 const float* __restrict__ bias, int M, int N, int K, int group_m) {
  extern __shared__ unsigned char smem[];
  const uint32_t ring = (smem_addr(smem) + 1023) & ~1023u;  // stage s at ring + s * STAGE_BYTES: A, then W
  const uint32_t full = ring + BARRIERS;                    // full[s] at full + 8s
  const uint32_t empty = full + STAGES * 8;                 // empty[s] at empty + 8s, then the inputs'
  const int m_tiles = (M + BM - 1) / BM, n_tiles = N / BN, tiles = m_tiles * n_tiles;
  const int ktiles = K / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    for (int w = 0; w < 2; ++w) mbar_init(empty + 8 * (STAGES + w), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: one thread issues every load, tile after tile
    if (threadIdx.x == 256) {
      prefetch_map(&map_a);
      prefetch_map(&map_w);
      int g = 0;  // stages loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        tile_origin(t, m_tiles, n_tiles, group_m, m0, n0);
        for (int kt = 0; kt < ktiles; ++kt, ++g) {
          const int s = g % STAGES;
          mbar_wait(empty + 8 * s, ((g / STAGES) & 1) ^ 1);  // the first round finds every stage free
          load_stage<TRANS_B>(ring + s * STAGE_BYTES, full + 8 * s, &map_a, &map_w, m0, n0, kt * BK);
        }
      }
    }
    return;
  }

  constexpr bool HAS_IN = in_bytes(EPI) > 0;
  const uint32_t area_addr = ring + STAGES * STAGE_BYTES + wg * AREA_BYTES;  // this warpgroup's
  unsigned char* area = smem + (area_addr - smem_addr(smem));
  const uint32_t in_addr = area_addr + out_bytes(EPI) * BOX_BYTES, in_bar = empty + 8 * (STAGES + wg);
  int in_loads = 0;
  int i = wg;  // the CTA's i-th tile
  for (int t = blockIdx.x + wg * gridDim.x; t < tiles; t += 2 * gridDim.x, i += 2) {
    int m0, n0;
    tile_origin(t, m_tiles, n_tiles, group_m, m0, n0);
    if (HAS_IN && threadIdx.x % 128 == 0) load_in_half<EPI>(in_addr, in_bar, &map_x, m0, n0);  // during the main loop
    float acc0[64], acc1[64];  // rows [0, 64) and [64, 128) of the tile
#pragma unroll
    for (int r = 0; r < 64; ++r) acc0[r] = acc1[r] = 0.0f;
    fence_acc(acc0);
    fence_acc(acc1);
    // Our turn once the other warpgroup has issued its previous tile's products: by then it has
    // waited on every stage before ours, so no full barrier we wait on is a phase behind.
    if (i > 0) bar_sync<256>(1 + wg);
    int g = i * ktiles;  // the stages of the tiles before this one
    for (int kt = 0; kt < ktiles; ++kt, ++g) {
      const int s = g % STAGES;
      mbar_wait(full + 8 * s, (g / STAGES) & 1);
      const uint32_t a_tile = ring + s * STAGE_BYTES, w_tile = a_tile + A_STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {  // k ascending, 16 at a time
        const uint64_t dw = w_desc<TRANS_B>(w_tile, kk);
        wgmma_n128<TRANS_B ? 0 : 1>(acc0, a_desc(a_tile, 0, kk), dw);
        wgmma_n128<TRANS_B ? 0 : 1>(acc1, a_desc(a_tile, 64, kk), dw);
      }
      wgmma_commit();
      wgmma_wait<1>();  // stage g - 1's products are done: release it to the producer
      if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
    }
    if (t + gridDim.x < tiles) bar_arrive<256>(2 - wg);  // the other warpgroup's turn: the CTA's next tile
    wgmma_wait<0>();
    if (ktiles > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
    fence_acc(acc0);
    fence_acc(acc1);
    if (saves_u(EPI)) {
      store_half<EPI, true>(acc0, area, area_addr, &map_x, &map_x, in_bar, in_loads, 3 + wg, m0, n0, -1, bias);
      store_half<EPI, true>(acc1, area, area_addr, &map_x, &map_x, in_bar, in_loads, 3 + wg, m0 + 64, n0, -1, bias);
    }
    store_half<EPI, false>(acc0, area, area_addr, &map_out, &map_x, in_bar, in_loads, 3 + wg, m0, n0, m0 + 64, bias);
    store_half<EPI, false>(acc1, area, area_addr, &map_out, &map_x, in_bar, in_loads, 3 + wg, m0 + 64, n0, -1, bias);
  }
  if (threadIdx.x % 128 == 0) bulk_wait<false>();  // the last stores are done before the CTA's memory goes
}

// ---- host side ----

template <int EPI, bool TRANS_B>
cudaError_t launch(const void* a, const void* w, const void* bias, const void* residual, void* aux, void* out,
                   int M, int N, int K, cudaStream_t stream) {
  // the second matrix: u out (_SAVE), the residual or aux in, else none (map_out stands in)
  const void* second = saves_u(EPI) || reads_aux(EPI) ? aux : residual;
  CUtensorMap map_a, map_w, map_out, map_x;
  const bool ok = tensor_map(&map_a, a, M, K, BM) &&
                  (TRANS_B ? tensor_map(&map_w, w, N, K, BN) : tensor_map(&map_w, w, K, N, BK)) &&
                  tensor_map(&map_out, out, M, N, 64, f32_out(EPI)) &&
                  (second == nullptr || tensor_map(&map_x, second, M, N, 64, in_bytes(EPI) != 2));
  if (!ok) return cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory needs the opt-in (set per device)
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI, TRANS_B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((M + BM - 1) / BM) * (N / BN);
  const int sms = sm_count();
  const int ctas = static_cast<int>(sms > 0 && tiles > sms ? sms : tiles);  // a persistent CTA an SM
  const int group_m = 2ll * K * N >= GROUP_W_BYTES ? GROUP_M : 1;
  gemm_bf16_kernel<EPI, TRANS_B><<<ctas, THREADS, SMEM_BYTES, stream>>>(
      map_a, map_w, map_out, second != nullptr ? map_x : map_out, static_cast<const float*>(bias), M, N, K, group_m);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_epi(const void* a, const void* w, const void* bias, const void* residual, void* aux, void* out,
                       int M, int N, int K, bool trans_b, cudaStream_t s) {
  return trans_b ? launch<EPI, true>(a, w, bias, residual, aux, out, M, N, K, s)
                 : launch<EPI, false>(a, w, bias, residual, aux, out, M, N, K, s);
}

}  // namespace

extern "C" {

// Shape rules, exported so the Python wrapper checks shapes before a launch.
int kmr_gemm_tile_n() { return BN; }
int kmr_gemm_tile_k() { return BK; }

// a [M, K] bf16; w [K, N] bf16, or [N, K] with trans_b; bias [N] f32 or null; residual [M, N] bf16
// (EPI_RESIDUAL); aux [M, N] f32 (written by the _SAVE epilogues, read by GELU_BWD and RESIDUAL_F32)
int kmr_gemm_bf16(const void* a, const void* w, const void* bias, const void* residual, void* aux, void* out,
                  int M, int N, int K, int epilogue, int trans_b, void* stream) {
  if (M <= 0 || N % BN != 0 || K % BK != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool t = trans_b != 0;
  switch (epilogue) {
    case EPI_BIAS: return launch_epi<EPI_BIAS>(a, w, bias, residual, aux, out, M, N, K, t, s);
    case EPI_GELU_TANH: return launch_epi<EPI_GELU_TANH>(a, w, bias, residual, aux, out, M, N, K, t, s);
    case EPI_GELU_ERF: return launch_epi<EPI_GELU_ERF>(a, w, bias, residual, aux, out, M, N, K, t, s);
    case EPI_RESIDUAL: return launch_epi<EPI_RESIDUAL>(a, w, bias, residual, aux, out, M, N, K, t, s);
    case EPI_F32: return launch_epi<EPI_F32>(a, w, bias, residual, aux, out, M, N, K, t, s);
    case EPI_GELU_TANH_SAVE: return launch_epi<EPI_GELU_TANH_SAVE>(a, w, bias, residual, aux, out, M, N, K, t, s);
    case EPI_GELU_ERF_SAVE: return launch_epi<EPI_GELU_ERF_SAVE>(a, w, bias, residual, aux, out, M, N, K, t, s);
    case EPI_GELU_BWD_TANH: return launch_epi<EPI_GELU_BWD_TANH>(a, w, bias, residual, aux, out, M, N, K, t, s);
    case EPI_GELU_BWD_ERF: return launch_epi<EPI_GELU_BWD_ERF>(a, w, bias, residual, aux, out, M, N, K, t, s);
    case EPI_RESIDUAL_F32: return launch_epi<EPI_RESIDUAL_F32>(a, w, bias, residual, aux, out, M, N, K, t, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* kmr_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
