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
// are float32 or bfloat16 (loads widen with __bfloat162float, the output
// rounds to nearest even); every product, exponential and sum is float32,
// and the probabilities stay float32 into the PV product, as in the plain
// version (the reference's XLA blockwise_attention rounds them to v's type;
// the Pallas kernels and mha_ref do not).
//
// What bounds them on the card, at the serving shapes of internlm2-1.8b
// (Hq=16, Hkv=8, D=128, bfloat16):
//  * B4, one prompt of 1024 tokens: 4.3 GFLOP of causal products against
//    12.6 MB of q/k/v/o, ~340 FLOP per byte, so operations bound it (about
//    4.4 us at the data sheet's 989 TFLOP/s dense bf16).  This first kernel
//    runs the products on the CUDA cores in float32 (67 TFLOP/s at best), so
//    it sits an order of magnitude or more above that bound; moving QK^T and
//    PV onto the tensor cores (mma.sync / wgmma with the probabilities split
//    into two bf16 halves) is the next step.
//  * B5, 8 sequences against a 2048-slot cache: each block streams its KV
//    head's cache up to its position once, ~1 FLOP per byte, so HBM bytes
//    bound it.  One block per (sequence, KV head) gives only B*Hkv blocks
//    (64 at the serving shape, under half the 132 SMs); splitting the cache
//    over several blocks with a second merge pass is the next step.
//
// Design.  The TPU kernels carry (m, l, acc) in VMEM scratch across a
// sequential KV grid axis; Hopper blocks run in no order, so here the KV
// axis is a loop inside one block.
//  * B4: one block per (64-row query tile, query head, batch).  The query
//    tile, a K tile and a V tile are staged in shared memory as float32 (Q
//    and K rows padded by one word so the column walks of QK^T hit distinct
//    banks).  Thread (ty, tx) owns rows ty + NY*i and score columns
//    tx + 16*j of each tile, and output columns tx + 16*c; each row's
//    running max m, sum l and accumulator live in registers.  Row max and
//    row sum reduce over the 16 lanes of a half-warp with xor shuffles (the
//    sum is then taken from the group's first lane, so every lane of a row
//    divides by the same l).  Key tiles the mask hides (beyond the tile's
//    last query when causal, before its first query's window) are never
//    loaded: the loop runs only over the tiles the mask leaves.  At D=256
//    the key tile shrinks to 32 rows and the block grows to 256 threads, so
//    the tiles fit in 139 KB of dynamic shared memory.
//  * B5: one block per (KV head, sequence); its rows are the G query heads
//    of that KV head.  The cache is walked in key tiles staged in shared
//    memory; threads split the G x tile scores, one warp per row reduces max
//    and sum with xor shuffles (fixed order), and the G x D accumulator is
//    kept in shared memory, each element owned by one thread.  position is
//    a (B,) device array read by the block, so one compiled kernel serves
//    every position of a ragged decode wave.
// Tiles are staged with 16-byte loads, several in flight per thread: B5 has
// few blocks, and element-wise loads would leave it waiting on memory
// latency.  So every operand's base must be 16-byte aligned, which the
// wrappers check.
// No atomics: every reduction has a fixed order, so two runs give the same
// bits.  Each launcher returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Staging: 16-byte loads (8 bf16 or 4 float values), several in flight per
// thread before any is stored, widened to float32 in shared memory.
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

// Copy rows [0, valid) of one or two (ROWS, D) tiles whose rows lie
// `stride` elements apart into shared memory (row pitch ld_a / ld_b), rows
// [valid, ROWS) as zeros.  kChunk 16-byte loads per source are issued
// before their stores, so each thread keeps up to 2*kChunk loads in flight.
template <typename T, int D, int ROWS, int NT, bool kTwo>
__device__ __forceinline__ void stage(float* __restrict__ a, int ld_a,
                                      float* __restrict__ b, int ld_b,
                                      const T* __restrict__ src_a,
                                      const T* __restrict__ src_b,
                                      size_t stride, int valid) {
  constexpr int V = 16 / sizeof(T);
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

// ------------------------------------------------------------------ B4
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

template <typename T, int D>
__global__ void __launch_bounds__(Prefill<D>::kThreads)
    prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int Sq,
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

  stage<T, D, P::kBQ, P::kThreads, false>(
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
      stage<T, D, P::kBK, P::kThreads, true>(ks, P::kDP, vs, D, k + off,
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
      T* out = o + (((size_t)b * Sq + row0 + r) * Hq + h) * D;
#pragma unroll
      for (int c = 0; c < P::kOut; ++c) store(out + tx + 16 * c, acc[i][c] / den);
    }
  }
}

// ------------------------------------------------------------------ B5
template <int D>
struct Decode {
  static constexpr int kBK = D >= 256 ? 32 : 64;   // keys a tile
  static constexpr int kThreads = 128;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kDP = D + 1;                // padded K row
  static size_t smem_bytes(int G) {
    return sizeof(float) * (2 * (size_t)G * D + (size_t)kBK * kDP +
                            (size_t)kBK * D + (size_t)G * kBK + 3 * (size_t)G);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(Decode<D>::kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  const int* __restrict__ position, int S, int Hq, int Hkv,
                  int window, float scale) {
  using P = Decode<D>;
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  float* qs = smem;                        // [G][D]
  float* accs = qs + G * D;                // [G][D]
  float* ks = accs + G * D;                // [kBK][kDP]
  float* vs = ks + P::kBK * P::kDP;        // [kBK][D]
  float* ps = vs + P::kBK * D;             // [G][kBK]
  float* ms = ps + G * P::kBK;             // [G] running max
  float* ls = ms + G;                      // [G] running sum
  float* cs = ls + G;                      // [G] this tile's correction

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int pos = position[b];
  // q and o are (B, 1, Hq, D): the G heads of KV head hk are contiguous.
  const size_t qbase = ((size_t)b * Hq + (size_t)hk * G) * D;

  for (int i = tid; i < G * D; i += P::kThreads) {
    qs[i] = widen(q[qbase + i]);
    accs[i] = 0.f;
  }
  for (int i = tid; i < G; i += P::kThreads) {
    ms[i] = kNeg;
    ls[i] = 0.f;
  }

  const int n_tiles = (S + P::kBK - 1) / P::kBK;
  const int t_end = pos < 0 ? 0 : min(n_tiles, pos / P::kBK + 1);
  int t_begin = 0;
  if (window > 0 && pos - window + 1 > 0) t_begin = (pos - window + 1) / P::kBK;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * P::kBK;
    __syncthreads();   // q staged; the previous tile's K, V, P are read
    {
      const size_t off = (((size_t)b * S + k0) * Hkv + hk) * D;
      stage<T, D, P::kBK, P::kThreads, true>(ks, P::kDP, vs, D, k + off,
                                             v + off, (size_t)Hkv * D,
                                             S - k0);
    }
    __syncthreads();

    for (int it = tid; it < G * P::kBK; it += P::kThreads) {
      const int g = it / P::kBK, j = it % P::kBK;
      const float* qr = qs + g * D;
      const float* kr = ks + j * P::kDP;
      float a = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
      ps[it] = visible(k0 + j, pos, S, 1, window) ? a * scale : kNeg;
    }
    __syncthreads();

    for (int g = warp; g < G; g += P::kWarps) {
      float* pr = ps + g * P::kBK;
      const float m_old = ms[g];
      float mx = kNeg;
      for (int j = lane; j < P::kBK; j += 32) mx = fmaxf(mx, pr[j]);
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < P::kBK; j += 32) {
        const float pj = expf(pr[j] - m_new);
        pr[j] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int it = tid; it < G * D; it += P::kThreads) {
      const int g = it / D, c = it % D;
      const float* pr = ps + g * P::kBK;
      float a = accs[it] * cs[g];
#pragma unroll 8
      for (int j = 0; j < P::kBK; ++j) a = fmaf(pr[j], vs[j * D + c], a);
      accs[it] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += P::kThreads)
    store(o + qbase + i, accs[i] / fmaxf(ls[i / D], 1e-30f));
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
  using P = Prefill<D>;
  auto kern = prefill_kernel<T, D>;
  constexpr size_t smem = P::smem_bytes();
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Sq + P::kBQ - 1) / P::kBQ, Hq, B);
  kern<<<grid, P::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, Hq, Hkv, causal,
      window, q_offset, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int decode_t(const void* q, const void* k, const void* v, void* o,
             const int* pos, int B, int S, int Hq, int Hkv, int window,
             void* stream) {
  using P = Decode<D>;
  auto kern = decode_kernel<T, D>;
  // The smem size grows with G = Hq / Hkv: raise the opt-in when a wider
  // group than before arrives.
  static size_t allowed = 48 * 1024;
  const size_t smem = P::smem_bytes(Hq / Hkv);
  if (smem > allowed) {
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  const dim3 grid(Hkv, B);
  kern<<<grid, P::kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, pos, S, Hq, Hkv, window,
      1.0f / sqrtf((float)D));
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
             const int* pos, int B, int S, int Hq, int Hkv, int window,
             void* stream) {
  switch (D) {
    case 16: return decode_t<T, 16>(q, k, v, o, pos, B, S, Hq, Hkv, window, stream);
    case 32: return decode_t<T, 32>(q, k, v, o, pos, B, S, Hq, Hkv, window, stream);
    case 64: return decode_t<T, 64>(q, k, v, o, pos, B, S, Hq, Hkv, window, stream);
    case 128: return decode_t<T, 128>(q, k, v, o, pos, B, S, Hq, Hkv, window, stream);
    case 256: return decode_t<T, 256>(q, k, v, o, pos, B, S, Hq, Hkv, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// B4.  q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), o like q, all contiguous;
// dtype 0 = float32, 1 = bfloat16.  Query row i sits at q_offset + i.
int flash_prefill_launch(const void* q, const void* k, const void* v, void* o,
                         int dtype, int B, int Sq, int Skv, int Hq, int Hkv,
                         int D, int causal, int window, int q_offset,
                         void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return prefill_d<float>(D, q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window,
                            q_offset, stream);
  if (dtype == 1)
    return prefill_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, Hq, Hkv, causal,
                                    window, q_offset, stream);
  return (int)cudaErrorInvalidValue;
}

// B5.  q/o (B, 1, Hq, D), k/v (B, S, Hkv, D), position (B,) int32, all on
// the device and contiguous; dtype as above.
int flash_decode_launch(const void* q, const void* k, const void* v, void* o,
                        const int* position, int dtype, int B, int S, int Hq,
                        int Hkv, int D, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return decode_d<float>(D, q, k, v, o, position, B, S, Hq, Hkv, window,
                           stream);
  if (dtype == 1)
    return decode_d<__nv_bfloat16>(D, q, k, v, o, position, B, S, Hq, Hkv,
                                   window, stream);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block in bytes: kernel 0 is B4, 1 is B5 with
// G query heads per KV head; 0 for a head dim the kernels do not take.
int flash_attn_smem_bytes(int kernel, int D, int G) {
  switch (D) {
    case 16: return (int)(kernel ? Decode<16>::smem_bytes(G) : Prefill<16>::smem_bytes());
    case 32: return (int)(kernel ? Decode<32>::smem_bytes(G) : Prefill<32>::smem_bytes());
    case 64: return (int)(kernel ? Decode<64>::smem_bytes(G) : Prefill<64>::smem_bytes());
    case 128: return (int)(kernel ? Decode<128>::smem_bytes(G) : Prefill<128>::smem_bytes());
    case 256: return (int)(kernel ? Decode<256>::smem_bytes(G) : Prefill<256>::smem_bytes());
    default: return 0;
  }
}

}  // extern "C"
