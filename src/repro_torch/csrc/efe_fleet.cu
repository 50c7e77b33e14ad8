// Fused fleet belief update -> expected free energy, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernels of the JAX package
// src/repro/kernels/efe/efe.py::belief_efe_fleet_pallas (fused belief
// update then EFE, "B1") and ::efe_fleet_pallas (EFE alone, "B2").  Both are
// one template here: kFuseBelief switches the posterior step on, kMasked the
// per-modality observation mask.  It computes the same function as the
// plain PyTorch versions in repro_torch/kernels/efe/ref.py:
//
//   q'    = norm(exp(loglik + log(max(norm(B_prev q), 1e-30))))   (B1 only)
//   s_a   = norm(B_a q')                 for every action a
//   o_a   = A s_a                        (M*NB rows of the observation model)
//   G[a]  = sum_j [o_aj > 1e-20] o_aj (log max(o_aj, 1e-30) - logC_j) mask_j
//           + s_a . amb + cost[a]
//
// What bounds it: HBM bytes.  Each launch streams the whole cached
// transition stack nb (R, A, S, S) in float32 once, and B1 also reads the
// applied action's row B_prev in place.  At the paper's widths (S=243,
// A=20) and R=1024 that is 1024*20*243*243*4 B = 4.84 GB of nb plus 0.24 GB
// of B_prev, so at the H100 data sheet's 3.35 TB/s a launch cannot take less
// than about 1.5 ms; the work is ~0.5 FLOP per byte, far below the card's
// balance point.
//
// Design.  One thread block per router.  The block stages the router's
// small operands (belief, ambiguity, the M*NB observation rows, preferences,
// mask) in shared memory, computes the posterior there once (B1), then
// loops over the A actions: one warp per output row s' of B_a q, lanes
// striding over the contiguous s axis (coalesced loads) and a warp-shuffle
// reduction per row; then the block normalizes, projects through the staged
// observation rows and reduces risk and ambiguity.  This replaces the TPU
// kernel's carried VMEM scratch (posterior computed at action step 0 and
// reused across a sequential grid axis) with a loop inside the block, since
// Hopper blocks run in no order.  S needs no lane padding: every loop is
// bounds-checked.  B_prev is read from nb[r, prev_action[r]] in place, so
// the (R, S, S) gathered copy of the reference path is never made.
//
// Numerics: float32 throughout, accurate expf/logf (built without
// --use_fast_math), the reference's guard constants (1e-30 clamps, the 1e-20
// risk threshold).  No atomics: every reduction has a fixed order, so a
// launch is deterministic.
//
// This first design streams each byte of nb once and makes no attempt at
// TMA bulk copies or L2 residency tuning; that is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum; every thread gets the result.  `red` holds kWarps floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();  // red is rewritten by the next reduction
  return s;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// out[t] = sum_s mat[t, s] * x[s] for t < S: one warp per row, lanes over s.
__device__ __forceinline__ void matvec_rows(const float* __restrict__ mat,
                                            const float* x, float* out,
                                            int S) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < S; t += kWarps) {
    const float* row = mat + (size_t)t * S;
    float acc = 0.f;
#pragma unroll 4
    for (int s = lane; s < S; s += 32) acc = fmaf(__ldg(row + s), x[s], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[t] = acc;
  }
}

// In-place normalization of v[0:S) by max(sum, 1e-30).
__device__ void normalize(float* v, int S, float* red) {
  float part = 0.f;
  for (int i = threadIdx.x; i < S; i += kThreads) part += v[i];
  const float z = fmaxf(block_sum(part, red), 1e-30f);
  for (int i = threadIdx.x; i < S; i += kThreads) v[i] = v[i] / z;
  __syncthreads();
}

// 8 resident blocks per SM (<= 32 registers a thread): R=1024 routers then
// run in one wave on 132 SMs instead of leaving a partial second wave.
template <bool kFuseBelief, bool kMasked>
__global__ void __launch_bounds__(kThreads, 8)
efe_fleet_kernel(const float* __restrict__ nb,
                 const long long* __restrict__ prev_action,
                 const float* __restrict__ q_in,
                 const float* __restrict__ loglik,
                 const float* __restrict__ na,
                 const float* __restrict__ logc,
                 const float* __restrict__ amb,
                 const float* __restrict__ cost,
                 const float* __restrict__ mask,
                 float* __restrict__ g_out,
                 float* __restrict__ q_out,
                 int A, int S, int M, int NB) {
  extern __shared__ float smem[];
  const int J = M * NB;
  float* q = smem;              // S      belief (posterior when fused)
  float* sp = q + S;            // S      predicted state of one action
  float* am = sp + S;           // S      per-state ambiguity
  float* ob = am + S;           // J * S  observation model rows
  float* lc = ob + J * S;       // J      log-preferences
  float* mk = lc + J;           // J      mask per row (unused if unmasked)
  float* terms = mk + J;        // J + 1  risk terms, then the ambiguity
  float* red = terms + J + 1;   // kWarps reduction scratch

  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t ss = (size_t)S * S;
  const float* nb_r = nb + (size_t)r * A * ss;

  for (int i = threadIdx.x; i < S; i += kThreads) {
    q[i] = q_in[(size_t)r * S + i];
    am[i] = amb[(size_t)r * S + i];
  }
  for (int i = threadIdx.x; i < J * S; i += kThreads)
    ob[i] = na[(size_t)r * J * S + i];
  for (int j = threadIdx.x; j < J; j += kThreads) {
    lc[j] = logc[(size_t)r * J + j];
    if (kMasked) mk[j] = mask[(size_t)r * M + j / NB];
  }
  __syncthreads();

  if (kFuseBelief) {
    // The JAX reference gathers with clamped indices; clamp the same way so
    // an out-of-range action can never read outside the router's stack.
    long long ap = prev_action[r];
    ap = ap < 0 ? 0 : (ap >= A ? A - 1 : ap);
    matvec_rows(nb_r + (size_t)ap * ss, q, sp, S);
    __syncthreads();
    normalize(sp, S, red);                       // prior = norm(B_prev q)
    float mx = -INFINITY;
    for (int i = threadIdx.x; i < S; i += kThreads) {
      const float lp = loglik[(size_t)r * S + i] + logf(fmaxf(sp[i], 1e-30f));
      sp[i] = lp;
      mx = fmaxf(mx, lp);
    }
    mx = block_max(mx, red);
    float part = 0.f;
    for (int i = threadIdx.x; i < S; i += kThreads) {
      const float e = expf(sp[i] - mx);
      sp[i] = e;
      part += e;
    }
    const float zq = fmaxf(block_sum(part, red), 1e-30f);
    for (int i = threadIdx.x; i < S; i += kThreads) {
      const float qi = sp[i] / zq;
      q[i] = qi;
      q_out[(size_t)r * S + i] = qi;
    }
    __syncthreads();
  }

  for (int a = 0; a < A; ++a) {
    matvec_rows(nb_r + (size_t)a * ss, q, sp, S);
    __syncthreads();
    normalize(sp, S, red);                       // s_a = norm(B_a q)
    // rows 0..J-1: o_a = A s_a and its risk term; row J: s_a . amb
    for (int j = warp; j <= J; j += kWarps) {
      const float* row = (j < J) ? ob + (size_t)j * S : am;
      float acc = 0.f;
      for (int s = lane; s < S; s += 32) acc = fmaf(row[s], sp[s], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        float term = acc;
        if (j < J) {
          term = acc > 1e-20f ? acc * (logf(fmaxf(acc, 1e-30f)) - lc[j])
                              : 0.f;
          if (kMasked) term *= mk[j];
        }
        terms[j] = term;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float risk = 0.f;
      for (int j = 0; j < J; ++j) risk += terms[j];
      g_out[(size_t)r * A + a] = risk + terms[J] + cost[a];
    }
    // terms is rewritten only after the next action's matvec and two more
    // barriers, which thread 0 reaches only after this read.
  }
}

size_t smem_bytes(int S, int M, int NB) {
  const size_t J = (size_t)M * NB;
  return sizeof(float) * (3 * (size_t)S + J * S + 3 * J + 1 + kWarps);
}

template <bool kFuse, bool kMasked>
int launch(const float* nb, const long long* prev, const float* q,
           const float* ll, const float* na, const float* logc,
           const float* amb, const float* cost, const float* mask, float* g,
           float* q_out, int R, int A, int S, int M, int NB, void* stream) {
  const size_t smem = smem_bytes(S, M, NB);
  auto kern = efe_fleet_kernel<kFuse, kMasked>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      nb, prev, q, ll, na, logc, amb, cost, mask, g, q_out, A, S, M, NB);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B1: fused belief update -> EFE.  mask may be null (unmasked kernel).
// Returns cudaGetLastError() after the launch (0 on success).
int belief_efe_fleet_launch(const float* nb, const long long* prev_action,
                            const float* q_prev, const float* loglik,
                            const float* na, const float* logc,
                            const float* amb, const float* cost,
                            const float* mask, float* g, float* q_out, int R,
                            int A, int S, int M, int NB, void* stream) {
  if (mask != nullptr)
    return launch<true, true>(nb, prev_action, q_prev, loglik, na, logc, amb,
                              cost, mask, g, q_out, R, A, S, M, NB, stream);
  return launch<true, false>(nb, prev_action, q_prev, loglik, na, logc, amb,
                             cost, mask, g, q_out, R, A, S, M, NB, stream);
}

// B2: EFE of the given beliefs.  mask may be null (unmasked kernel).
int efe_fleet_launch(const float* nb, const float* q, const float* na,
                     const float* logc, const float* amb, const float* cost,
                     const float* mask, float* g, int R, int A, int S, int M,
                     int NB, void* stream) {
  if (mask != nullptr)
    return launch<false, true>(nb, nullptr, q, nullptr, na, logc, amb, cost,
                               mask, g, nullptr, R, A, S, M, NB, stream);
  return launch<false, false>(nb, nullptr, q, nullptr, na, logc, amb, cost,
                              mask, g, nullptr, R, A, S, M, NB, stream);
}

}  // extern "C"
