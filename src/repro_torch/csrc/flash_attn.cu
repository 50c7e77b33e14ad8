// Flash attention for LM serving, CUDA C++ for sm_90a: kernels B4 and B5.
//
// Replaces the Pallas TPU kernels of the JAX package
// src/repro/kernels/attention/flash.py::flash_prefill ("B4",
// _prefill_kernel) and ::flash_decode ("B5", _decode_kernel).  Both compute
// masked grouped-query attention with an online softmax and float32
// accumulators, the function of the plain versions in
// repro_torch/kernels/attention/ref.py:
//
//   s_ij = (q_i . k_j) / sqrt(D),  -1e30 unless key j is visible to query i
//   o_i  = sum_j exp(s_ij - m_i) v_j / max(sum_j exp(s_ij - m_i), 1e-30)
//
// Key j sits at absolute position j, query i at p_i (q_offset + i in B4,
// position[b] in B5).  Key j is visible iff j < Skv, j <= p_i when causal
// (B5 always), and j > p_i - window when window > 0.  Query head h reads KV
// head h / (Hq / Hkv), so no repeated K/V is ever made.  Inputs and output
// are float32 or bfloat16 (loads widen exactly, the output rounds to
// nearest even); every exponential and sum is float32.
//
// What bounds them on the card, at the serving shapes of internlm2-1.8b
// (Hq=16, Hkv=8, D=128, bfloat16):
//  * B4, one prompt of 1024 tokens: 4.3 GFLOP of causal products against
//    12.6 MB of q/k/v/o, ~340 FLOP per byte, so operations bound it (about
//    4.4 us at the data sheet's 989 TFLOP/s dense bf16).  In bfloat16 both
//    products run on the tensor cores (mma.sync m16n8k16, float32
//    accumulators), 1.5x the bound's products since P V runs twice (see
//    below).  mma.sync from 8 warps an SM (two blocks, held there by 238
//    registers a thread and 87 KB of shared memory) reaches a part of the
//    rate that wgmma (four warps issuing 64-row products straight from
//    shared memory, asynchronously) and TMA tile copies (no per-thread
//    address work, no registers) unlock.  At this shape that follow-on
//    would feed the same 256 blocks of 64 rows from a TMA ring, with wgmma
//    m64n64k16 for S and m64n128k16 for O and the softmax of one tile
//    overlapping the products of the next.
//  * B5, 8 sequences against a 2048-slot cache: each (sequence, KV head)
//    streams its cache up to its position once, ~1 FLOP per byte, so HBM
//    bytes bound it (~10 us for 34 MB).  With one block per (sequence, KV
//    head) only B*Hkv blocks (64) would run on 132 SMs, so the cache is
//    split over several blocks and a second kernel merges their partials.
//
// Design.  The TPU kernels carry (m, l, acc) in VMEM scratch across a
// sequential KV grid axis; Hopper blocks run in no order, so here the KV
// axis is a loop inside a block (B4) or is cut into chunks that blocks take
// in parallel and a merge pass joins (B5).
//  * B4, bfloat16 (prefill_tc_kernel): one block of 4 warps per (query
//    head, batch, 64-row query tile), each warp owning 16 query rows.  The
//    query tile and a two-stage ring of K/V tiles sit in shared memory as
//    bfloat16, rows padded by 16 bytes so ldmatrix meets no bank conflict,
//    filled by 16-byte cp.async copies (rows past Skv or Sq zero-filled
//    through the copy's source size) while the previous tile computes.
//    S = Q K^T takes Q and K fragments by ldmatrix (at D=128 the Q
//    fragments are loaded once and stay in registers); products of bf16
//    values are exact in float32, so only the order of the sum differs from
//    the plain version.  The online softmax runs on the accumulator
//    fragments (row max by quad shuffles, each thread keeping a partial row
//    sum, the accumulator rescaled only when a row max moved), masked by
//    absolute position as visible() says on the tiles that straddle an edge
//    of the mask (interior tiles skip the test).  P V takes the
//    probabilities in two bf16 halves, p_hi = bf16(p) and p_lo = bf16(p -
//    p_hi), re-laid from the S accumulators as A operands in registers,
//    with V through ldmatrix.trans, two products into one float32
//    accumulator: p keeps ~16 significant bits where one bf16 would keep 8
//    (the reference's Pallas kernel and mha_ref keep it float32).  Key tiles
//    the mask hides are never loaded, and the query tiles with the most
//    keys are issued first and the lightest paired with them after (the
//    grid's slowest axis runs down, then up), so the causal triangle's tail
//    does not idle the card.  At D=256 the key tile halves to 32 rows,
//    keeping the 16 x 256 float32 output fragment of a warp and the scores
//    in registers without spills.
//  * B4, float32 (prefill_kernel): a dtype switch routes every float32 call
//    to the CUDA-core kernel, since the tensor cores take no float32
//    operand at the 2e-5 bar.  One block per (64-row query tile, query
//    head, batch); tiles staged as float32 in shared memory; thread (ty, tx)
//    owns rows ty + NY*i and score columns tx + 16*j of each tile, each
//    row's m, l and accumulator in registers, reductions over a half-warp
//    with xor shuffles.  No main path runs float32 on the card.
//  * B5 (decode_split_kernel + decode_merge_kernel, float32 and bfloat16):
//    grid (n_split, Hkv, B); block (c, hk, b) takes keys [c*chunk,
//    (c+1)*chunk) of the cache, cut to those visible at position[b], for
//    the G query heads of KV head hk.  The chunk length comes from the
//    wrapper and depends only on (B, Hkv, S), never on the positions, so a
//    launch is the same for every wave of a shape.  A block whose chunk is
//    wholly hidden writes m = -1e30, l = 0 and loads nothing.  A live block
//    stages its keys through the same cp.async ring as B4 (in the input
//    type) and keeps its G rows in float32 on the CUDA cores: with G = 2 or
//    4 rows decode is bound by bytes and tensor cores buy nothing.  Its
//    (m, l, acc[G][D]) partial goes to a float32 scratch the wrapper
//    allocates.  The merge kernel, one block per (KV head, sequence),
//    rescales and sums the partials in split order and divides by
//    max(l, 1e-30).  position is a (B,) device array, so one compiled launch
//    serves every position of a ragged decode wave.
// Tiles are copied in 16-byte units, so every operand's base must be
// 16-byte aligned, which the wrappers check.  Scores live in the log2
// domain (scaled by log2(e) / sqrt(D)), so every exponential is base 2:
// one ex2.approx instruction in B4's bf16 loop, exp2f in B5.
// No atomics: every reduction has a fixed order, so two runs give the same
// bits.  Each launcher returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes (8 bf16 or 4 float values) widened to float32.
__device__ __forceinline__ void widen16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen16(const uint4& u, float (&f)[8]) {
  // bfloat16 -> float32 is exact: the 16 bits become the high half.  The
  // first element of each 32-bit word is its low half.
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Two neighbouring elements widened to float32.
__device__ __forceinline__ void widen2(const float* p, float& x, float& y) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  x = u.x;
  y = u.y;
}
__device__ __forceinline__ void widen2(const bf16* p, float& x, float& y) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  x = __uint_as_float(w << 16);
  y = __uint_as_float(w & 0xffff0000u);
}

// Staging for the float32 B4: copy rows [0, valid) of one or two (ROWS, D)
// tiles whose rows lie `stride` elements apart into shared memory (row
// pitch ld_a / ld_b), rows [valid, ROWS) as zeros.  kChunk 16-byte loads
// per source are issued before their stores, so each thread keeps up to
// 2*kChunk loads in flight.
template <int D, int ROWS, int NT, bool kTwo>
__device__ __forceinline__ void stage(float* __restrict__ a, int ld_a,
                                      float* __restrict__ b, int ld_b,
                                      const float* __restrict__ src_a,
                                      const float* __restrict__ src_b,
                                      size_t stride, int valid) {
  constexpr int V = 4;
  constexpr int kPerRow = D / V;
  constexpr int kUnits = ROWS * kPerRow;
  constexpr int kIters = (kUnits + NT - 1) / NT;
  constexpr int kChunk = 4;
#pragma unroll
  for (int i0 = 0; i0 < kIters; i0 += kChunk) {
    uint4 ua[kChunk], ub[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int u = threadIdx.x + (i0 + i) * NT;
      const int r = u / kPerRow, c = (u % kPerRow) * V;
      const bool ok = i0 + i < kIters && u < kUnits && r < valid;
      const size_t off = (size_t)r * stride + c;
      ua[i] = ok ? *reinterpret_cast<const uint4*>(src_a + off)
                 : make_uint4(0u, 0u, 0u, 0u);
      if (kTwo)
        ub[i] = ok ? *reinterpret_cast<const uint4*>(src_b + off)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int u = threadIdx.x + (i0 + i) * NT;
      if (i0 + i < kIters && u < kUnits) {
        const int r = u / kPerRow, c = (u % kPerRow) * V;
        float f[V];
        widen16(ua[i], f);
#pragma unroll
        for (int e = 0; e < V; ++e) a[r * ld_a + c + e] = f[e];
        if (kTwo) {
          widen16(ub[i], f);
#pragma unroll
          for (int e = 0; e < V; ++e) b[r * ld_b + c + e] = f[e];
        }
      }
    }
  }
}

__device__ __forceinline__ bool visible(int j, int p, int skv, int causal,
                                        int window) {
  return j < skv && (!causal || j <= p) && (window <= 0 || j > p - window);
}

// Reductions over the 16 lanes of a half-warp (lanes 0-15 or 16-31).
__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, threadIdx.x & 16);
}

// Reductions over the 4 lanes of a quad (the lanes that share a row of an
// mma accumulator).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// ------------------------------------------------------------------ PTX
// Every asynchronous copy, ldmatrix and mma of the kernels goes through
// these functions.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (all 16 when it is 0, and then nothing is read) become zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices: lanes 8i..8i+7 give the row addresses of matrix
// i; r[i] of lane l holds row l/4, columns 2(l%4) and 2(l%4)+1 of matrix i
// (.trans: rows 2(l%4) and 2(l%4)+1 of column l/4).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// 2^x (relative error ~2^-22; results below 2^-126 flush to zero).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (16x8, f32) += a (16x16, bf16, row major) b (16x8, bf16, column major).
// With g = lane/4, t = lane%4: a[0] holds row g, columns 2t, 2t+1; a[1]
// row g+8; a[2] and a[3] the same rows at columns 8+2t, 9+2t; b0 holds
// rows 2t, 2t+1 of column g, b1 rows 8+2t, 9+2t; d[0], d[1] row g, columns
// 2t, 2t+1, d[2], d[3] row g+8.
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// ------------------------------------------------------------- end of PTX

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const unsigned*>(&h);
}

// (x, y) as two bf16 pairs: hi = bf16(x, y), lo = bf16(x - hi_x, y - hi_y)
// (the differences are exact in float32).
__device__ __forceinline__ void split_bf16x2(float x, float y, unsigned& hi,
                                             unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// Asynchronous copy of rows [0, valid) of a (ROWS, D) tile whose rows lie
// `stride` elements apart into shared memory of row pitch LD; rows [valid,
// ROWS) become zeros.  Every thread of the block takes part.
template <typename T, int D, int ROWS, int NT, int LD>
__device__ __forceinline__ void load_tile_async(T* __restrict__ dst,
                                                const T* __restrict__ src,
                                                size_t stride, int valid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kPerRow = D / V;
  constexpr int kUnits = ROWS * kPerRow;
#pragma unroll
  for (int i = 0; i < (kUnits + NT - 1) / NT; ++i) {
    const int u = threadIdx.x + i * NT;
    if (kUnits % NT == 0 || u < kUnits) {
      const int r = u / kPerRow, c = (u % kPerRow) * V;
      const bool ok = r < valid;
      cp_async16(dst + r * LD + c, src + (ok ? (size_t)r * stride + c : 0),
                 ok ? 16 : 0);
    }
  }
}

// ------------------------------------------------------------------ B4
// float32: the CUDA-core kernel.
template <int D>
struct Prefill {
  static constexpr int kBQ = 64;                       // query rows a block
  static constexpr int kBK = D >= 256 ? 32 : 64;       // keys a tile
  static constexpr int kThreads = D >= 256 ? 256 : 128;
  static constexpr int kNY = kThreads / 16;            // row groups (ty)
  static constexpr int kRows = kBQ / kNY;              // rows a thread
  static constexpr int kCols = kBK / 16;               // score columns a thread
  static constexpr int kOut = D / 16;                  // output columns a thread
  static constexpr int kDP = D + 1;                    // padded Q/K row
  static constexpr int kBKP = kBK + 1;                 // padded P row
  static constexpr size_t smem_bytes() {
    return sizeof(float) * ((size_t)kBQ * kDP + (size_t)kBK * kDP +
                            (size_t)kBK * D + (size_t)kBQ * kBKP);
  }
};

template <int D>
__global__ void __launch_bounds__(Prefill<D>::kThreads)
    prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int Sq,
                   int Skv, int Hq, int Hkv, int causal, int window,
                   int q_offset, float scale) {
  using P = Prefill<D>;
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBQ][kDP]
  float* ks = qs + P::kBQ * P::kDP;        // [kBK][kDP]
  float* vs = ks + P::kBK * P::kDP;        // [kBK][D]
  float* ps = vs + P::kBK * D;             // [kBQ][kBKP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int row0 = blockIdx.x * P::kBQ;
  const int nrows = min(P::kBQ, Sq - row0);
  const int p_lo = q_offset + row0;        // absolute position of row 0
  const int p_hi = p_lo + nrows - 1;

  stage<D, P::kBQ, P::kThreads, false>(
      qs, P::kDP, nullptr, 0, q + (((size_t)b * Sq + row0) * Hq + h) * D,
      nullptr, (size_t)Hq * D, nrows);

  float m[P::kRows], l[P::kRows], acc[P::kRows][P::kOut];
#pragma unroll
  for (int i = 0; i < P::kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < P::kOut; ++c) acc[i][c] = 0.f;
  }

  // Only the key tiles the mask leaves visible to some row of this block.
  const int n_tiles = (Skv + P::kBK - 1) / P::kBK;
  int t_end = n_tiles;
  if (causal) t_end = p_hi < 0 ? 0 : min(n_tiles, p_hi / P::kBK + 1);
  int t_begin = 0;
  if (window > 0 && p_lo - window + 1 > 0)
    t_begin = (p_lo - window + 1) / P::kBK;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * P::kBK;
    __syncthreads();   // Q is staged; the previous tile's K, V, P are read
    {
      const size_t off = (((size_t)b * Skv + k0) * Hkv + hk) * D;
      stage<D, P::kBK, P::kThreads, true>(ks, P::kDP, vs, D, k + off,
                                             v + off, (size_t)Hkv * D,
                                             Skv - k0);
    }
    __syncthreads();

    float s[P::kRows][P::kCols];
#pragma unroll
    for (int i = 0; i < P::kRows; ++i)
#pragma unroll
      for (int j = 0; j < P::kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[P::kRows], kv[P::kCols];
#pragma unroll
      for (int i = 0; i < P::kRows; ++i)
        qv[i] = qs[(ty + P::kNY * i) * P::kDP + d];
#pragma unroll
      for (int j = 0; j < P::kCols; ++j) kv[j] = ks[(tx + 16 * j) * P::kDP + d];
#pragma unroll
      for (int i = 0; i < P::kRows; ++i)
#pragma unroll
        for (int j = 0; j < P::kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < P::kRows; ++i) {
      const int r = ty + P::kNY * i;
      const int p = p_lo + r;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < P::kCols; ++j) {
        const float x = visible(k0 + tx + 16 * j, p, Skv, causal, window)
                            ? s[i][j] * scale
                            : kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = group16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < P::kCols; ++j) {
        const float pj = expf(s[i][j] - m_new);
        ps[r * P::kBKP + tx + 16 * j] = pj;
        sum += pj;
      }
      sum = group16_sum(sum);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < P::kOut; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < P::kBK; ++j) {
      float pv[P::kRows], vv[P::kOut];
#pragma unroll
      for (int i = 0; i < P::kRows; ++i)
        pv[i] = ps[(ty + P::kNY * i) * P::kBKP + j];
#pragma unroll
      for (int c = 0; c < P::kOut; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < P::kRows; ++i)
#pragma unroll
        for (int c = 0; c < P::kOut; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < P::kRows; ++i) {
    const int r = ty + P::kNY * i;
    if (r < nrows) {
      const float den = fmaxf(l[i], 1e-30f);
      float* out = o + (((size_t)b * Sq + row0 + r) * Hq + h) * D;
#pragma unroll
      for (int c = 0; c < P::kOut; ++c) out[tx + 16 * c] = acc[i][c] / den;
    }
  }
}

// bfloat16: the tensor-core kernel.
template <int D>
struct PrefillTC {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;              // query rows a block
  static constexpr int kBK = D >= 256 ? 32 : 64;       // keys a stage
  static constexpr int kStages = 2;
  static constexpr int kLd = D + 8;                    // row pitch: +16 bytes
  static constexpr size_t smem_bytes() {
    return sizeof(bf16) * (size_t)kLd * (kBQ + 2 * kStages * kBK);
  }
};

template <int D>
__global__ void __launch_bounds__(PrefillTC<D>::kThreads)
    prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int Sq, int Skv, int Hq, int Hkv, int causal,
                      int window, int q_offset, float scale_log2) {
  using P = PrefillTC<D>;
  constexpr int kLd = P::kLd, kBK = P::kBK;
  constexpr int kN = kBK / 8;        // score fragments (8 keys each) a warp
  constexpr int kO = D / 8;          // output fragments (8 columns each)
  extern __shared__ float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);            // [kBQ][kLd]
  bf16* ks = qs + P::kBQ * kLd;                        // [kStages][kBK][kLd]
  bf16* vs = ks + P::kStages * kBK * kLd;              // [kStages][kBK][kLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  // The grid's slowest axis issues the query tiles with the most keys
  // first, descending, then the rest ascending: a block of the second wave
  // lands beside one of the first with about as many keys left.
  const int half = (gridDim.z + 1) / 2;
  const int tile = blockIdx.z < half ? gridDim.z - 1 - blockIdx.z
                                     : blockIdx.z - half;
  const int hk = h / (Hq / Hkv);
  const int row0 = tile * P::kBQ;
  const int nrows = min(P::kBQ, Sq - row0);
  const int p_lo = q_offset + row0;        // absolute position of row 0
  const int p_hi = p_lo + nrows - 1;
  // This thread's two rows of the warp's 16: r_pos and r_pos + 8.
  const int r_pos = p_lo + warp * 16 + (lane >> 2);

  // Only the key tiles the mask leaves visible to some row of this block.
  const int n_tiles = (Skv + kBK - 1) / kBK;
  int t_end = n_tiles;
  if (causal) t_end = p_hi < 0 ? 0 : min(n_tiles, p_hi / kBK + 1);
  int t_begin = 0;
  if (window > 0 && p_lo - window + 1 > 0) t_begin = (p_lo - window + 1) / kBK;

  const size_t kv_stride = (size_t)Hkv * D;
  const bf16* kb = k + ((size_t)b * Skv * Hkv + hk) * D;   // key 0 of head hk
  const bf16* vb = v + ((size_t)b * Skv * Hkv + hk) * D;
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * kBK;
    load_tile_async<bf16, D, kBK, P::kThreads, kLd>(
        ks + stage * kBK * kLd, kb + k0 * kv_stride, kv_stride, Skv - k0);
    load_tile_async<bf16, D, kBK, P::kThreads, kLd>(
        vs + stage * kBK * kLd, vb + k0 * kv_stride, kv_stride, Skv - k0);
  };

  load_tile_async<bf16, D, P::kBQ, P::kThreads, kLd>(
      qs, q + (((size_t)b * Sq + row0) * Hq + h) * D, (size_t)Hq * D, nrows);
  cp_async_commit();
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();

  float acc[kO][4];
#pragma unroll
  for (int n = 0; n < kO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // l: this lane's part

  // ldmatrix row addresses of this lane (see ldmatrix_x4): Q as the A
  // operand, K as B of S = Q K^T, V (transposed) as B of O = P V.
  const bf16* q_frag = qs + (warp * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;
  const int k_frag = ((lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8;
  const int v_frag = ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + (lane >> 4) * 8;
  // At D=128, the serving models' head dim, the warp's Q fragments stay in
  // registers for the whole loop (32 of them, 238 in all); at D=256 they
  // do not fit, and at 16 and 64 ptxas then spilled.
  constexpr bool kQReg = D == 128;
  unsigned qf[kQReg ? D / 16 : 1][4];
  if constexpr (kQReg) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 16);
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();      // this tile (and Q) has landed
    __syncthreads();
    const bf16* kt = ks + stage * kBK * kLd;
    const bf16* vt = vs + stage * kBK * kLd;

    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4];
      if constexpr (kQReg) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, q_frag + kk * 16);
      }
#pragma unroll
      for (int n = 0; n < kBK / 16; ++n) {
        unsigned bk[4];
        ldmatrix_x4(bk, kt + k_frag + n * 16 * kLd + kk * 16);
        mma_16816(s[2 * n], a, bk[0], bk[1]);
        mma_16816(s[2 * n + 1], a, bk[2], bk[3]);
      }
    }

    // Online softmax on the fragments: element e of fragment n is row
    // r_pos + 8*(e/2), key k0 + 8n + 2*(lane%4) + e%2.  Only tiles on an
    // edge of the mask (the causal diagonal, the window's start, keys past
    // Skv) test each element.
    const int t0 = t * kBK;
    const bool edge = (causal && t0 + kBK - 1 > p_lo) ||
                      (window > 0 && t0 <= p_hi - window) || t0 + kBK > Skv;
    const int k0 = t0 + 2 * (lane & 3);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = !edge || visible(k0 + 8 * n + (e & 1),
                                         r_pos + 8 * (e >> 1), Skv, causal,
                                         window)
                            ? s[n][e] * scale_log2
                            : kNeg;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = exp2_approx(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    // Once the row maxima settle, most tiles leave them as they were.
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < kO; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
    }

    // O += P V over 16 keys a step, P in two bf16 halves: fragments 2kk
    // and 2kk+1 of S are the A operand's columns 0-7 and 8-15.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vt + v_frag + kk * 16 * kLd + dn * 16);
        mma_16816(acc[2 * dn], ph, bv[0], bv[1]);
        mma_16816(acc[2 * dn], pl, bv[0], bv[1]);
        mma_16816(acc[2 * dn + 1], ph, bv[2], bv[3]);
        mma_16816(acc[2 * dn + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();         // this stage is read before it is refilled
  }
  cp_async_wait<0>();

  const int r = warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(quad_sum(l[i]), 1e-30f);
    if (r + 8 * i < nrows) {
      bf16* out = o + (((size_t)b * Sq + row0 + r + 8 * i) * Hq + h) * D +
                  2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < kO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
  }
}

// ------------------------------------------------------------------ B5
template <typename T, int D>
struct DecodeSplit {
  static constexpr int kBK = 32;                       // keys a stage
  static constexpr int kThreads = 128;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kLd = D + 16 / (int)sizeof(T);  // row pitch: +16 bytes
  static size_t smem_bytes(int G) {
    return sizeof(T) * 2 * 2 * (size_t)kBK * kLd +
           sizeof(float) * (2 * (size_t)G * D + (size_t)G * kBK + 3 * (size_t)G);
  }
};

template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* __restrict__ qr,
                                         const T* __restrict__ kr) {
  constexpr int V = 16 / sizeof(T);
  float a = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += V) {
    float f[V];
    widen16(*reinterpret_cast<const uint4*>(kr + d), f);
#pragma unroll
    for (int e = 0; e < V; ++e) a = fmaf(qr[d + e], f[e], a);
  }
  return a;
}

template <typename T, int D>
__global__ void __launch_bounds__(DecodeSplit<T, D>::kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, float* __restrict__ part,
                        const int* __restrict__ position, int S, int Hq,
                        int Hkv, int window, int chunk, float scale_log2) {
  using P = DecodeSplit<T, D>;
  constexpr int kBK = P::kBK, kLd = P::kLd;
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  T* ks = reinterpret_cast<T*>(smem);                  // [2][kBK][kLd]
  T* vs = ks + 2 * kBK * kLd;                          // [2][kBK][kLd]
  float* qs = reinterpret_cast<float*>(vs + 2 * kBK * kLd);   // [G][D]
  float* accs = qs + G * D;                // [G][D]
  float* ps = accs + G * D;                // [G][kBK]
  float* ms = ps + G * kBK;                // [G] running max
  float* ls = ms + G;                      // [G] running sum
  float* cs = ls + G;                      // [G] this tile's correction

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int pos = position[b];
  // Partials: (m, l) of all rows, then acc of all rows; row (slot, g).
  const size_t slot = ((size_t)b * Hkv + hk) * n_split + split;
  const size_t n_rows = (size_t)gridDim.z * Hkv * n_split * G;
  float* ml = part + 2 * slot * G;
  float* pacc = part + 2 * n_rows + slot * G * D;

  // Keys [first, last): this block's chunk, cut to those visible at pos.
  const int first = max(split * chunk, window > 0 ? pos - window + 1 : 0);
  const int last = min(min(S, (split + 1) * chunk), pos + 1);
  if (first >= last) {
    for (int g = tid; g < G; g += P::kThreads) {
      ml[2 * g] = kNeg;
      ml[2 * g + 1] = 0.f;
    }
    return;
  }

  const size_t kv_stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)b * S * Hkv + hk) * D;   // key 0 of head hk
  const T* vb = v + ((size_t)b * S * Hkv + hk) * D;
  auto load_kv = [&](int j0, int stage) {
    load_tile_async<T, D, kBK, P::kThreads, kLd>(
        ks + stage * kBK * kLd, kb + j0 * kv_stride, kv_stride, last - j0);
    load_tile_async<T, D, kBK, P::kThreads, kLd>(
        vs + stage * kBK * kLd, vb + j0 * kv_stride, kv_stride, last - j0);
  };
  load_kv(first, 0);
  cp_async_commit();

  // q and o are (B, 1, Hq, D): the G heads of KV head hk are contiguous.
  const size_t qbase = ((size_t)b * Hq + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += P::kThreads) {
    qs[i] = widen(q[qbase + i]);
    accs[i] = 0.f;
  }
  for (int g = tid; g < G; g += P::kThreads) {
    ms[g] = kNeg;
    ls[g] = 0.f;
  }

  const int n_tiles = (last - first + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const int j0 = first + t * kBK;
    const int n = min(kBK, last - j0);     // keys of this tile, all visible
    if (t + 1 < n_tiles) load_kv(j0 + kBK, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();         // this tile has landed; q is staged
    const T* kt = ks + stage * kBK * kLd;
    const T* vt = vs + stage * kBK * kLd;

    for (int it = tid; it < G * kBK; it += P::kThreads) {
      const int g = it / kBK, j = it % kBK;
      if (j < n) ps[it] = dot_row<T, D>(qs + g * D, kt + j * kLd) * scale_log2;
    }
    __syncthreads();

    for (int g = warp; g < G; g += P::kWarps) {
      float* pr = ps + g * kBK;
      const float m_old = ms[g];
      float mx = kNeg;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pr[j]);
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float pj = exp2f(pr[j] - m_new);
        pr[j] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float corr = exp2f(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int it = tid; it < G * (D / 2); it += P::kThreads) {
      const int g = it / (D / 2), c = 2 * (it % (D / 2));
      const float* pr = ps + g * kBK;
      float a0 = accs[g * D + c] * cs[g], a1 = accs[g * D + c + 1] * cs[g];
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        float v0, v1;
        widen2(vt + j * kLd + c, v0, v1);
        a0 = fmaf(pr[j], v0, a0);
        a1 = fmaf(pr[j], v1, a1);
      }
      accs[g * D + c] = a0;
      accs[g * D + c + 1] = a1;
    }
    __syncthreads();         // this stage and ps are read before reuse
  }

  for (int i = tid; i < G * D; i += P::kThreads) pacc[i] = accs[i];
  for (int g = tid; g < G; g += P::kThreads) {
    ml[2 * g] = ms[g];
    ml[2 * g + 1] = ls[g];
  }
}

// One block per (KV head, sequence): the partials of its n_split chunks
// rescaled to their common max and summed in split order.
template <typename T, int D>
__global__ void __launch_bounds__(128)
    decode_merge_kernel(const float* __restrict__ part, T* __restrict__ o,
                        int Hq, int Hkv, int n_split) {
  const int G = Hq / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  const size_t n_rows = (size_t)gridDim.y * Hkv * n_split * G;
  const size_t slot0 = ((size_t)b * Hkv + hk) * n_split;
  for (int it = threadIdx.x; it < G * D; it += blockDim.x) {
    const int g = it / D, d = it % D;
    float mx = kNeg;
    for (int c = 0; c < n_split; ++c)
      mx = fmaxf(mx, part[2 * ((slot0 + c) * G + g)]);
    float l = 0.f, a = 0.f;
    for (int c = 0; c < n_split; ++c) {
      const size_t r = (slot0 + c) * G + g;
      const float lc = part[2 * r + 1];
      if (lc > 0.f) {        // a chunk with no visible key adds nothing
        const float w = exp2f(part[2 * r] - mx);
        l = fmaf(w, lc, l);
        a = fmaf(w, part[2 * n_rows + r * D + d], a);
      }
    }
    store(o + ((size_t)b * Hq + (size_t)hk * G + g) * D + d,
          a / fmaxf(l, 1e-30f));
  }
}

// ------------------------------------------------------------ launchers
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
int prefill_t(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Skv, int Hq, int Hkv, int causal, int window,
              int q_offset, void* stream) {
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (sizeof(T) == 2) {
    using P = PrefillTC<D>;
    auto kern = prefill_tc_kernel<D>;
    constexpr size_t smem = P::smem_bytes();
    static const cudaError_t attr = allow_smem(kern, smem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid(Hq, B, (Sq + P::kBQ - 1) / P::kBQ);
    kern<<<grid, P::kThreads, smem, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Sq, Skv,
        Hq, Hkv, causal, window, q_offset, scale * kLog2e);
  } else {
    using P = Prefill<D>;
    auto kern = prefill_kernel<D>;
    constexpr size_t smem = P::smem_bytes();
    static const cudaError_t attr = allow_smem(kern, smem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((Sq + P::kBQ - 1) / P::kBQ, Hq, B);
    kern<<<grid, P::kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Skv,
        Hq, Hkv, causal, window, q_offset, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int decode_t(const void* q, const void* k, const void* v, void* o,
             const int* pos, float* part, int B, int S, int Hq, int Hkv,
             int window, int chunk, void* stream) {
  using P = DecodeSplit<T, D>;
  auto split = decode_split_kernel<T, D>;
  // The smem size grows with G = Hq / Hkv: raise the opt-in when a wider
  // group than before arrives.
  static size_t allowed = 48 * 1024;
  const size_t smem = P::smem_bytes(Hq / Hkv);
  if (smem > allowed) {
    const cudaError_t e = allow_smem(split, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const int n_split = (S + chunk - 1) / chunk;
  split<<<dim3(n_split, Hkv, B), P::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, part, pos, S, Hq, Hkv, window,
      chunk, kLog2e / sqrtf((float)D));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_merge_kernel<T, D><<<dim3(Hkv, B), 128, 0, (cudaStream_t)stream>>>(
      part, (T*)o, Hq, Hkv, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int prefill_d(int D, const void* q, const void* k, const void* v, void* o,
              int B, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
              int q_offset, void* stream) {
  switch (D) {
    case 16: return prefill_t<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, q_offset, stream);
    case 32: return prefill_t<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, q_offset, stream);
    case 64: return prefill_t<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, q_offset, stream);
    case 128: return prefill_t<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, q_offset, stream);
    case 256: return prefill_t<T, 256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int decode_d(int D, const void* q, const void* k, const void* v, void* o,
             const int* pos, float* part, int B, int S, int Hq, int Hkv,
             int window, int chunk, void* stream) {
  switch (D) {
    case 16: return decode_t<T, 16>(q, k, v, o, pos, part, B, S, Hq, Hkv, window, chunk, stream);
    case 32: return decode_t<T, 32>(q, k, v, o, pos, part, B, S, Hq, Hkv, window, chunk, stream);
    case 64: return decode_t<T, 64>(q, k, v, o, pos, part, B, S, Hq, Hkv, window, chunk, stream);
    case 128: return decode_t<T, 128>(q, k, v, o, pos, part, B, S, Hq, Hkv, window, chunk, stream);
    case 256: return decode_t<T, 256>(q, k, v, o, pos, part, B, S, Hq, Hkv, window, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int smem_d(int kernel, int G) {
  switch (kernel) {
    case 0: return (int)Prefill<D>::smem_bytes();
    case 1: return (int)PrefillTC<D>::smem_bytes();
    case 2: return (int)DecodeSplit<float, D>::smem_bytes(G);
    case 3: return (int)DecodeSplit<bf16, D>::smem_bytes(G);
    default: return 0;
  }
}

}  // namespace

extern "C" {

// B4.  q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o like q, all contiguous;
// dtype 0 = float32 (prefill_kernel), 1 = bfloat16 (prefill_tc_kernel).
// Query row i sits at q_offset + i.
int flash_prefill_launch(const void* q, const void* k, const void* v, void* o,
                         int dtype, int B, int Sq, int Skv, int Hq, int Hkv,
                         int D, int causal, int window, int q_offset,
                         void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return prefill_d<float>(D, q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                            q_offset, stream);
  if (dtype == 1)
    return prefill_d<bf16>(D, q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                           q_offset, stream);
  return (int)cudaErrorInvalidValue;
}

// B5.  q/o (B, 1, Hq, D), k/v (B, S, Hkv, D), position (B,) int32, all on
// the device and contiguous; dtype as above.  The cache splits into
// ceil(S / chunk) chunks; part is float32 scratch of B * Hkv * n_split *
// (Hq / Hkv) * (D + 2) elements.
int flash_decode_launch(const void* q, const void* k, const void* v, void* o,
                        const int* position, float* part, int dtype, int B,
                        int S, int Hq, int Hkv, int D, int window, int chunk,
                        void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return decode_d<float>(D, q, k, v, o, position, part, B, S, Hq, Hkv,
                           window, chunk, stream);
  if (dtype == 1)
    return decode_d<bf16>(D, q, k, v, o, position, part, B, S, Hq, Hkv,
                          window, chunk, stream);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block in bytes: kernel 0 is B4 in float32
// (prefill_kernel), 1 B4 in bfloat16 (prefill_tc_kernel), 2 and 3 B5's
// decode_split_kernel in float32 and bfloat16 with G query heads per KV
// head (decode_merge_kernel takes none); 0 for a head dim the kernels do
// not take.
int flash_attn_smem_bytes(int kernel, int D, int G) {
  switch (D) {
    case 16: return smem_d<16>(kernel, G);
    case 32: return smem_d<32>(kernel, G);
    case 64: return smem_d<64>(kernel, G);
    case 128: return smem_d<128>(kernel, G);
    case 256: return smem_d<256>(kernel, G);
    default: return 0;
  }
}

}  // extern "C"
