// Whole-window AIF fleet kernel ("B3"), CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel of the JAX package
// src/repro/kernels/efe/mega.py::mega_window_pallas.  One launch advances
// every router of the fleet through the W fast ticks of one slow period and
// computes what the plain PyTorch version
// repro_torch/core/mega.py::mega_window computes.  Per tick and router:
//
//   observe   discretize the published telemetry and the utilization scrape
//   EMA       error EMA (held where the error modality is masked)
//   evidence  loglik[s] = sum_m mask_m logna[m, bin_m, s] (+ scrape term)
//   prior     qt = q / colsum[a_prev];  pend_j = coefact[j, a_prev] (qp_j.qt)
//             num = u sum(qt) + d qt + sum_j pend_j qn_j;  prior = norm(num)
//   posterior q' = norm(exp(loglik + log max(prior, 1e-30) - max))
//   EFE       on selecting ticks (w % dwell == 0): qa_a = q' / colsum[a],
//             o_a = (u sqa_a projsum + d proj qa_a + sum_j pend_ja qnproj_j)
//                   / max((uS + d) sqa_a + sum_j pend_ja sumqn_j, 1e-30),
//             G = risk + ambiguity + cost; sampled = argmax(log max(softmax(
//             -beta G), 1e-30) + gumbel), lowest index on ties
//   dwell     the action changes only where (t + w) % dwell == 0
//   push      slot t0 + w of the tape gets (q, q', bins, mask, a_prev, dt)
//   env       the fluid window of repro_torch/envsim/batched.py
//             ::fluid_window_step: queues, restarts from the given uniforms,
//             the completion-weighted P95, masked and blacked-out telemetry
//
// What bounds it: HBM bytes.  The slot tape q_prev/q_next (R, J, S) is the
// big operand; only slots j < t0 carry weight (the slow steps have sampled
// nothing at or after the window's first tick, so coefact[j, :] == 0 there)
// and this kernel reads only those.  At R=4096, t0=150, S=243 in float32
// those rows are 1.19 GB, about 0.36 ms at the H100 data sheet's 3.35 TB/s;
// the work is a few FLOP per byte, far below the card's balance point.
//
// Design.  One 256-thread block per router; the W-tick loop runs inside the
// block.  Shared memory holds the router's EFE projection rows proj (P, S),
// the per-action scaled posteriors qa (A, S), the posterior and its
// temporaries, the slot chunk coefficients and the env carry; the slot tape
// streams from global memory on every tick (it does not fit: at J=300 the
// f32 planes are 583 KB per router, and the Pallas design that keeps them
// resident needs more than a block's 227 KB).  Slots are visited in chunks
// of kJChunk: one warp per slot dots the slot's q_prev row with qt (or with
// qa of the slot's actions), then every thread adds the chunk into its own
// accumulators in slot order.  coefact is one-hot per slot (its action), so
// a slot with a zero coefficient is skipped: its term is an exact zero.
// In-window pushes land in place at column t0 + w, never read by this
// launch.  bf16 slots are a template instantiation: loads widen with
// __bfloat162float, pushes round to nearest even with __float2bfloat16,
// as torch's cast does.  The env, the observation and the sampling are
// scalar work per router and run on thread 0.
//
// Numerics: float32, accurate expf/logf, the plain version's guard
// constants, built with -fmad=false so that plain multiplies and adds round
// one at a time as PyTorch's elementwise kernels do (the dot products use
// explicit fmaf).  No atomics: every reduction has a fixed order, so a
// launch is deterministic.  The P95 sorts the K atoms by (latency, index)
// with an insertion sort, the stable order of the plain version's argsort.
//
// This first design rereads the used tape rows on every tick (about
// 2 x (W + 2) passes per window); keeping them in L2 or shared memory
// across ticks, TMA copies and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

extern "C" {

// Mirrored field for field by repro_torch/kernels/efe/mega.py::MegaArgs.
struct MegaArgs {
  // slot tape, written in place at columns [t0, t0 + W)
  void* q_prev;             // (R, J, S) float or bf16
  void* q_next;             // (R, J, S) float or bf16
  long long* slot_bins;     // (R, J, M)
  float* slot_mask;         // (R, J, M)
  long long* slot_action;   // (R, J)
  float* slot_dt;           // (R, J)
  // quasi-static cache
  const float* colsum;      // (R, A, S)
  const float* proj;        // (R, P, S)
  const float* projsum;     // (R, P)
  const float* qnproj;      // (R, J, P)
  const float* sumqn;       // (R, J)
  const float* coefact;     // (R, J, A)
  const float* logna;       // (R, M, NB, S)
  // router carry, updated in place
  float* belief;            // (R, S)
  long long* prev_action;   // (R)
  float* scal;              // (R, 2): dt_since_change, error_ema
  const long long* t;       // (R) fleet clock at the window's start
  // env, updated in place
  float* obsm;              // (3, R, M): raw_obs, obs_mask, held_obs
  float* tier_util;         // (R, K)
  float* envk;              // (8, R, K)
  float* envr;              // (R, 9)
  const float* pstack;      // (12, R, K)
  // this window's schedules and noise
  const float* arrival;     // (W, R)
  const float* hazard;      // (W, R, K)
  const float* obs_valid;   // (W, R, M) or null
  const float* uniforms;    // (W, 2, R, K): fire, duration
  const float* gumbel;      // (W, R, A)
  // shared tables
  const int* sf_tbl;        // (S, K) utilization level per state, heaviest first
  const float* logc;        // (2, M, NB): nominal, unstable log-preferences
  const float* cost;        // (A)
  const float* ptable;      // (A, K) routing weights
  const float* obs_edges;   // (M, E) bin edges, +inf padded
  const int* n_edges;       // (M)
  const float* util_edges;  // (n_util_edges)
  // traces
  long long* tr_act;        // (W, R)
  float* tr_rk;             // (W, 8, R, K)
  float* tr_r;              // (W, 4, R)
  float* tr_rm;             // (W, 3, R, M)
  int R, J, S, A, M, NB, K, W, P, E, n_util_edges, n_used, t0, dwell,
      util_period, scrape_every, err_ix, emits_mask, masked_obs,
      restart_blackout, bf16_slots;
  float dt, fast_period_s, err_decay, err_keep, error_trigger, beta, u_c, d_c,
      usd, log_match, log_miss, timeout_s, a_lat, a_err, a_rps, keep_lat,
      keep_err, keep_rps, scrape_den;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kJChunk = 32;      // slots staged per chunk
constexpr int kSPer = 4;         // S <= kSPer * kThreads
constexpr int kAccPer = 4;       // A * (P + 1) <= kAccPer * kThreads
constexpr int kMaxKM = 8;        // K, M <= 8
constexpr float kEps = 1e-9f;    // envsim.batched._EPS

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

// Block-wide sum and max; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
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

// Warp-wide dot of a tape row with a shared vector; lane 0 holds the sum.
template <typename TS>
__device__ __forceinline__ float row_dot(const TS* row, const float* x,
                                         int S) {
  float acc = 0.f;
  for (int s = threadIdx.x & 31; s < S; s += 32)
    acc = fmaf(load(row + s), x[s], acc);
  return warp_sum(acc);
}

// The env carry of one router, in shared memory.
struct Env {
  float backlog[kMaxKM], down_left[kMaxKM], util_accum[kMaxKM],
      util_scrape[kMaxKM], prev_rps[kMaxKM], tier_requests[kMaxKM],
      tier_success[kMaxKM], n_restarts[kMaxKM];
  float p95_ema, rps_ema, err_ema, acct[6];
  float raw[kMaxKM], omask[kMaxKM], held[kMaxKM], tutil[kMaxKM];
  // this tick's observation, set by thread 0
  int bins[kMaxKM], ubins[kMaxKM], util_valid, a_prev, sampled, unstable;
  float ema, dtc;
};

// One fluid window for router r (thread 0): the arithmetic of
// envsim/batched.py::fluid_window_step in the same order.
__device__ void env_window(const MegaArgs& a, Env& e, int r, int w,
                           int action) {
  const int R = a.R, K = a.K, M = a.M;
  const size_t rk = (size_t)r * K;
  const float* ps = a.pstack;
  const size_t pl = (size_t)R * K;  // one pstack plane
  float wn[kMaxKM], lam[kMaxKM], arr[kMaxKM], served[kMaxKM], b1[kMaxKM],
      over[kMaxKM], lat[kMaxKM], p95[kMaxKM], timed[kMaxKM], comp[kMaxKM],
      cap_rate[kMaxKM], restarted[kMaxKM], killed[kMaxKM], util_old[kMaxKM];
  int up[kMaxKM];
  float wsum = 0.f;
  for (int k = 0; k < K; ++k) {
    wn[k] = fmaxf(a.ptable[(size_t)action * K + k], 0.f);
    wsum += wn[k];
  }
  wsum = fmaxf(wsum, 1e-12f);
  const float rate = a.arrival[(size_t)w * R + r];
  float refused = 0.f;
  for (int k = 0; k < K; ++k) {
    wn[k] = wn[k] / wsum;
    up[k] = e.down_left[k] <= kEps;
    const float upf = up[k] ? 1.f : 0.f;
    lam[k] = wn[k] * rate;
    arr[k] = lam[k] * a.dt;
    refused += arr[k] * (1.f - upf);
    const float admitted = arr[k] * upf;
    const float servers = ps[0 * pl + rk + k], mu = ps[1 * pl + rk + k];
    cap_rate[k] = servers * mu;
    const float cap = cap_rate[k] * a.dt * upf;
    const float avail = e.backlog[k] + admitted;
    served[k] = fminf(avail, cap);
    b1[k] = avail - served[k];
    const float syscap = ps[4 * pl + rk + k] + servers;
    over[k] = fmaxf(b1[k] - syscap, 0.f);
    b1[k] = b1[k] - over[k];
    const float wait =
        cap_rate[k] > 0.f
            ? 0.5f * (e.backlog[k] + b1[k]) / fmaxf(cap_rate[k], kEps)
            : 0.f;
    const float svc = ps[2 * pl + rk + k];
    lat[k] = wait + svc;
    p95[k] = wait + svc * ps[3 * pl + rk + k];
    timed[k] = lat[k] > a.timeout_s ? served[k] : 0.f;
    comp[k] = served[k] - timed[k];
    const float util =
        cap > 0.f ? served[k] / fmaxf(cap_rate[k] * a.dt, kEps) : 0.f;
    e.util_accum[k] = e.util_accum[k] + util * a.dt;
  }
  const int t_idx = a.t0 + w;
  const bool scrape_now = ((t_idx + 1) % a.scrape_every) == 0;
  for (int k = 0; k < K; ++k) {
    util_old[k] = e.util_scrape[k];
    if (scrape_now) {
      e.util_scrape[k] = e.util_accum[k] / a.scrape_den;
      e.util_accum[k] = 0.f;
    }
  }
  const float* uf = a.uniforms + ((size_t)w * 2 + 0) * pl + rk;
  const float* ud = a.uniforms + ((size_t)w * 2 + 1) * pl + rk;
  const float* hz = a.hazard + (size_t)w * pl + rk;
  for (int k = 0; k < K; ++k) {
    const float rps_delta = lam[k] - e.prev_rps[k];
    const float hazard =
        hz[k] * ps[5 * pl + rk + k] *
        (ps[6 * pl + rk + k] +
         ps[7 * pl + rk + k] * fmaxf(e.util_scrape[k] - ps[8 * pl + rk + k],
                                     0.f) +
         ps[9 * pl + rk + k] * fmaxf(rps_delta, 0.f) /
             fmaxf(cap_rate[k], kEps));
    const float p_restart = 1.f - expf(-hazard * a.dt);
    restarted[k] = (up[k] && uf[k] < p_restart) ? 1.f : 0.f;
    killed[k] = b1[k] * restarted[k];
    e.backlog[k] = b1[k] * (1.f - restarted[k]);
    const float rmin = ps[10 * pl + rk + k], rmax = ps[11 * pl + rk + k];
    const float dur = rmin + ud[k] * (rmax - rmin);
    const float dl = fmaxf(e.down_left[k] - a.dt, 0.f);
    e.down_left[k] = restarted[k] > 0.f ? dur : dl;
  }

  // accounting
  float win_success = 0.f, over_sum = 0.f, to_sum = 0.f, kill_sum = 0.f,
        arr_sum = 0.f;
  for (int k = 0; k < K; ++k) {
    win_success += comp[k];
    over_sum += over[k];
    to_sum += timed[k];
    kill_sum += killed[k];
    arr_sum += arr[k];
  }
  const float win_fail = refused + over_sum + to_sum + kill_sum;

  // completion-weighted P95: stable (latency, index) order, first atom
  // whose cumulative share reaches 0.95
  int order[kMaxKM];
  for (int k = 0; k < K; ++k) {
    int i = k;
    while (i > 0 && p95[order[i - 1]] > p95[k]) {
      order[i] = order[i - 1];
      --i;
    }
    order[i] = k;
  }
  float total = 0.f;
  for (int i = 0; i < K; ++i) total += comp[order[i]];
  total = fmaxf(total, kEps);
  float p95_win = 0.f, cum = 0.f;
  for (int i = 0; i < K; ++i) {
    cum += comp[order[i]];
    if (cum / total >= 0.95f) {
      p95_win = p95[order[i]];
      break;
    }
  }
  if (win_success > kEps)
    e.p95_ema = a.keep_lat * e.p95_ema + a.a_lat * p95_win;
  const float total_win = win_success + win_fail;
  const float err_frac = win_fail / fmaxf(total_win, kEps);
  if (total_win > kEps)
    e.err_ema = a.keep_err * e.err_ema + a.a_err * err_frac;
  e.rps_ema = a.keep_rps * e.rps_ema + a.a_rps * rate;
  float queue[kMaxKM], depth = 0.f;
  for (int k = 0; k < K; ++k) {
    queue[k] = fmaxf(e.backlog[k] - ps[0 * pl + rk + k], 0.f);
    depth += queue[k];
  }

  // telemetry: validity mask, blackout, stale hold
  const float fresh[4] = {e.p95_ema, e.rps_ema, depth, e.err_ema};
  float wmask[kMaxKM], pub[kMaxKM];
  bool cell_up = true;
  for (int k = 0; k < K; ++k) cell_up = cell_up && e.down_left[k] <= kEps;
  for (int m = 0; m < M; ++m) {
    wmask[m] = 1.f;
    pub[m] = fresh[m];
    if (a.masked_obs) {
      if (a.obs_valid) wmask[m] = a.obs_valid[((size_t)w * R + r) * M + m];
      if (a.restart_blackout) wmask[m] = wmask[m] * (cell_up ? 1.f : 0.f);
      pub[m] = wmask[m] > 0.f ? fresh[m] : e.held[m];
    }
  }
  if (a.masked_obs && a.restart_blackout && !cell_up)
    for (int k = 0; k < K; ++k) e.util_scrape[k] = util_old[k];

  e.acct[0] += arr_sum;
  e.acct[1] += win_success;
  e.acct[2] += to_sum;
  e.acct[3] += over_sum;
  e.acct[4] += refused;
  e.acct[5] += kill_sum;
  for (int k = 0; k < K; ++k) {
    e.tier_requests[k] += arr[k];
    e.tier_success[k] += comp[k];
    e.n_restarts[k] += restarted[k];
    e.prev_rps[k] = lam[k];
  }

  // traces
  float* rk_row = a.tr_rk + (size_t)w * 8 * pl + rk;
  for (int k = 0; k < K; ++k) {
    rk_row[0 * pl + k] = a.ptable[(size_t)action * K + k];
    rk_row[1 * pl + k] = e.util_scrape[k];
    rk_row[2 * pl + k] = e.down_left[k] <= kEps ? 1.f : 0.f;
    rk_row[3 * pl + k] = queue[k];
    rk_row[4 * pl + k] = lat[k];
    rk_row[5 * pl + k] = p95[k];
    rk_row[6 * pl + k] = comp[k];
    rk_row[7 * pl + k] = restarted[k];
  }
  a.tr_r[((size_t)w * 4 + 0) * R + r] = win_success;
  a.tr_r[((size_t)w * 4 + 1) * R + r] = win_fail;
  const size_t rm = (size_t)R * M;
  for (int m = 0; m < M; ++m) {
    a.tr_rm[((size_t)w * 3 + 0) * rm + (size_t)r * M + m] = pub[m];
    a.tr_rm[((size_t)w * 3 + 1) * rm + (size_t)r * M + m] = wmask[m];
    e.raw[m] = pub[m];
    e.held[m] = pub[m];
    if (a.emits_mask) e.omask[m] = wmask[m];
  }
  for (int k = 0; k < K; ++k) e.tutil[k] = e.util_scrape[k];
}

template <typename TS>
__global__ void __launch_bounds__(kThreads)
mega_window_kernel(const MegaArgs a) {
  extern __shared__ float smem[];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int S = a.S, A = a.A, P = a.P, M = a.M, NB = a.NB, K = a.K,
            J = a.J, MNB = a.M * a.NB, P1 = a.P + 1;
  float* proj = smem;             // P * S
  float* qa = proj + P * S;       // A * S
  float* q = qa + A * S;          // S   belief
  float* qn = q + S;              // S   posterior
  float* qt = qn + S;             // S   q / colsum[a_prev]
  float* lp = qt + S;             // S   loglik, then the log-posterior
  float* pend = lp + S;           // kJChunk * A
  float* so = pend + kJChunk * A; // A * (P + 1) slot sums
  float* pd = so + A * P1;        // A * P proj . qa
  float* gsh = pd + A * P;        // A   G
  float* sqa = gsh + A;           // A
  float* red = sqa + A;           // kWarps
  Env& e = *reinterpret_cast<Env*>(red + kWarps);

  const TS* qp_r = reinterpret_cast<const TS*>(a.q_prev) + (size_t)r * J * S;
  const TS* qn_r = reinterpret_cast<const TS*>(a.q_next) + (size_t)r * J * S;
  const float* colsum_r = a.colsum + (size_t)r * A * S;
  const float* coef_r = a.coefact + (size_t)r * J * A;
  const float* qnproj_r = a.qnproj + (size_t)r * J * P;
  const float* sumqn_r = a.sumqn + (size_t)r * J;
  const float* projsum_r = a.projsum + (size_t)r * P;
  const float* logna_r = a.logna + (size_t)r * MNB * S;
  const size_t rk = (size_t)r * K, pl = (size_t)a.R * K;
  const size_t rm = (size_t)r * M, ml = (size_t)a.R * M;
  const int n_used = a.n_used;

  for (int i = tid; i < P * S; i += kThreads)
    proj[i] = a.proj[(size_t)r * P * S + i];
  for (int i = tid; i < S; i += kThreads) q[i] = a.belief[(size_t)r * S + i];
  if (tid == 0) {
    for (int k = 0; k < K; ++k) {
      e.backlog[k] = a.envk[0 * pl + rk + k];
      e.down_left[k] = a.envk[1 * pl + rk + k];
      e.util_accum[k] = a.envk[2 * pl + rk + k];
      e.util_scrape[k] = a.envk[3 * pl + rk + k];
      e.prev_rps[k] = a.envk[4 * pl + rk + k];
      e.tier_requests[k] = a.envk[5 * pl + rk + k];
      e.tier_success[k] = a.envk[6 * pl + rk + k];
      e.n_restarts[k] = a.envk[7 * pl + rk + k];
      e.tutil[k] = a.tier_util[rk + k];
    }
    e.p95_ema = a.envr[(size_t)r * 9 + 0];
    e.rps_ema = a.envr[(size_t)r * 9 + 1];
    e.err_ema = a.envr[(size_t)r * 9 + 2];
    for (int i = 0; i < 6; ++i) e.acct[i] = a.envr[(size_t)r * 9 + 3 + i];
    for (int m = 0; m < M; ++m) {
      e.raw[m] = a.obsm[0 * ml + rm + m];
      e.omask[m] = a.obsm[1 * ml + rm + m];
      e.held[m] = a.obsm[2 * ml + rm + m];
    }
    long long ap = a.prev_action[r];
    e.a_prev = (int)(ap < 0 ? 0 : (ap >= A ? A - 1 : ap));
    e.dtc = a.scal[(size_t)r * 2 + 0];
    e.ema = a.scal[(size_t)r * 2 + 1];
  }
  const long long t_r = a.t[r];
  __syncthreads();

  for (int w = 0; w < a.W; ++w) {
    const int t_idx = a.t0 + w;
    const bool selecting = (w % a.dwell) == 0;

    // ---- observe, error EMA, adaptive preference switch (thread 0)
    if (tid == 0) {
      for (int m = 0; m < M; ++m) {
        int b = 0;
        for (int i = 0; i < a.n_edges[m]; ++i)
          b += e.raw[m] >= a.obs_edges[m * a.E + i];
        e.bins[m] = b;
      }
      for (int k = 0; k < K; ++k) {
        int b = 0;
        for (int i = 0; i < a.n_util_edges; ++i)
          b += e.tutil[K - 1 - k] >= a.util_edges[i];
        e.ubins[k] = b;
      }
      e.util_valid = (t_idx % a.util_period) == 0 && t_idx > 0;
      const float ema_new =
          a.err_decay * e.ema + a.err_keep * e.raw[a.err_ix];
      if (!a.emits_mask || e.omask[a.err_ix] > 0.f) e.ema = ema_new;
      e.unstable = e.ema > a.error_trigger;
    }
    __syncthreads();

    // ---- evidence and q / colsum[a_prev]
    const int ap = e.a_prev;
    float part = 0.f;
    for (int s = tid; s < S; s += kThreads) {
      float ll = 0.f;
      for (int m = 0; m < M; ++m) {
        float v = logna_r[((size_t)m * NB + e.bins[m]) * S + s];
        if (a.emits_mask) v = v * e.omask[m];
        ll += v;
      }
      if (e.util_valid) {
        float ul = 0.f;
        for (int k = 0; k < K; ++k)
          ul += a.sf_tbl[s * K + k] == e.ubins[k] ? a.log_match : a.log_miss;
        ll = ll + ul;
      }
      lp[s] = ll;
      qt[s] = q[s] / colsum_r[(size_t)ap * S + s];
      part += qt[s];
    }
    __syncthreads();
    const float sum_qt = block_sum(part, red);

    // ---- slot term of the prior: sum_j pend_j qn_j, slots j < t0 only
    float acc[kSPer];
#pragma unroll
    for (int i = 0; i < kSPer; ++i) acc[i] = 0.f;
    for (int j0 = 0; j0 < n_used; j0 += kJChunk) {
      const int jn = min(kJChunk, n_used - j0);
      for (int jj = warp; jj < jn; jj += kWarps) {
        const int j = j0 + jj;
        const float c = coef_r[(size_t)j * A + ap];
        float v = 0.f;
        if (c != 0.f) v = c * row_dot(qp_r + (size_t)j * S, qt, S);
        if (lane == 0) pend[jj] = v;
      }
      __syncthreads();
      for (int jj = 0; jj < jn; ++jj) {
        const float pj = pend[jj];
        if (pj == 0.f) continue;
        const TS* row = qn_r + (size_t)(j0 + jj) * S;
#pragma unroll
        for (int i = 0; i < kSPer; ++i) {
          const int s = tid + i * kThreads;
          if (s < S) acc[i] = fmaf(pj, load(row + s), acc[i]);
        }
      }
      __syncthreads();
    }

    // ---- prior, posterior
    part = 0.f;
#pragma unroll
    for (int i = 0; i < kSPer; ++i) {
      const int s = tid + i * kThreads;
      if (s < S) {
        const float num = a.u_c * sum_qt + a.d_c * qt[s] + acc[i];
        qn[s] = num;
        part += num;
      }
    }
    const float zp = fmaxf(block_sum(part, red), 1e-30f);
    float mx = -INFINITY;
    for (int s = tid; s < S; s += kThreads) {
      const float v = lp[s] + logf(fmaxf(qn[s] / zp, 1e-30f));
      lp[s] = v;
      mx = fmaxf(mx, v);
    }
    mx = block_max(mx, red);
    part = 0.f;
    for (int s = tid; s < S; s += kThreads) {
      const float v = expf(lp[s] - mx);
      lp[s] = v;
      part += v;
    }
    const float zq = fmaxf(block_sum(part, red), 1e-30f);
    for (int s = tid; s < S; s += kThreads) qn[s] = lp[s] / zq;
    __syncthreads();

    // ---- EFE and the sampled action (selecting ticks)
    if (selecting) {
      for (int i = tid; i < A * S; i += kThreads)
        qa[i] = qn[i % S] / colsum_r[i];
      __syncthreads();
      for (int ai = warp; ai < A; ai += kWarps) {
        float v = 0.f;
        for (int s = lane; s < S; s += 32) v += qa[(size_t)ai * S + s];
        v = warp_sum(v);
        if (lane == 0) sqa[ai] = v;
      }
      for (int i = warp; i < A * P; i += kWarps) {
        const int ai = i / P, p = i % P;
        float v = 0.f;
        for (int s = lane; s < S; s += 32)
          v = fmaf(proj[(size_t)p * S + s], qa[(size_t)ai * S + s], v);
        v = warp_sum(v);
        if (lane == 0) pd[i] = v;
      }
      float acc2[kAccPer];
#pragma unroll
      for (int i = 0; i < kAccPer; ++i) acc2[i] = 0.f;
      for (int j0 = 0; j0 < n_used; j0 += kJChunk) {
        const int jn = min(kJChunk, n_used - j0);
        for (int jj = warp; jj < jn; jj += kWarps) {
          const int j = j0 + jj;
          const TS* row = qp_r + (size_t)j * S;
          for (int a0 = 0; a0 < A; a0 += 32) {
            const int ai = a0 + lane;
            const float c = ai < A ? coef_r[(size_t)j * A + ai] : 0.f;
            if (ai < A) pend[jj * A + ai] = 0.f;
            unsigned nz = __ballot_sync(0xffffffffu, c != 0.f);
            __syncwarp();
            while (nz) {
              const int b = __ffs(nz) - 1;
              nz &= nz - 1;
              const float cb = __shfl_sync(0xffffffffu, c, b);
              const float d = row_dot(row, qa + (size_t)(a0 + b) * S, S);
              if (lane == 0) pend[jj * A + a0 + b] = cb * d;
            }
            __syncwarp();
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kAccPer; ++i) {
          const int idx = tid + i * kThreads;
          if (idx < A * P1) {
            const int ai = idx / P1, p = idx % P1;
            for (int jj = 0; jj < jn; ++jj) {
              const float pv = pend[jj * A + ai];
              if (pv == 0.f) continue;
              const int j = j0 + jj;
              const float x =
                  p < P ? qnproj_r[(size_t)j * P + p] : sumqn_r[j];
              acc2[i] = fmaf(pv, x, acc2[i]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < kAccPer; ++i) {
        const int idx = tid + i * kThreads;
        if (idx < A * P1) so[idx] = acc2[i];
      }
      __syncthreads();
      const float* logc = a.logc + (e.unstable ? MNB : 0);
      for (int ai = tid; ai < A; ai += kThreads) {
        const float sq = sqa[ai];
        const float sden = fmaxf(a.usd * sq + so[ai * P1 + P], 1e-30f);
        float risk = 0.f, amb = 0.f;
        for (int p = 0; p < P; ++p) {
          const float onum = a.u_c * sq * projsum_r[p] +
                             a.d_c * pd[ai * P + p] + so[ai * P1 + p];
          const float o = onum / sden;
          if (p < MNB) {
            float term =
                o > 1e-20f ? o * (logf(fmaxf(o, 1e-30f)) - logc[p]) : 0.f;
            if (a.emits_mask) term = term * e.omask[p / NB];
            risk += term;
          } else {
            amb += a.emits_mask ? o * e.omask[p - MNB] : o;
          }
        }
        gsh[ai] = risk + amb + a.cost[ai];
      }
      __syncthreads();
      if (tid == 0) {
        float gmax = -INFINITY;
        for (int ai = 0; ai < A; ++ai) gmax = fmaxf(gmax, -a.beta * gsh[ai]);
        float z = 0.f;
        for (int ai = 0; ai < A; ++ai) z += expf(-a.beta * gsh[ai] - gmax);
        const float* gum = a.gumbel + ((size_t)w * a.R + r) * A;
        int best = 0;
        float best_v = -INFINITY;
        for (int ai = 0; ai < A; ++ai) {
          const float pr = expf(-a.beta * gsh[ai] - gmax) / z;
          const float v = logf(fmaxf(pr, 1e-30f)) + gum[ai];
          if (v > best_v) {  // strict: the lowest index wins a tie
            best_v = v;
            best = ai;
          }
        }
        e.sampled = best;
      }
    } else if (tid == 0) {
      e.sampled = e.a_prev;
    }

    // ---- push the transition slot (column t0 + w), carry the posterior
    const size_t col = (size_t)r * J + t_idx;
    TS* qp_w = reinterpret_cast<TS*>(a.q_prev) + col * S;
    TS* qn_w = reinterpret_cast<TS*>(a.q_next) + col * S;
    for (int s = tid; s < S; s += kThreads) {
      store(qp_w + s, q[s]);
      store(qn_w + s, qn[s]);
      q[s] = qn[s];
    }
    __syncthreads();
    if (tid == 0) {
      for (int m = 0; m < M; ++m) {
        a.slot_bins[col * M + m] = e.bins[m];
        a.slot_mask[col * M + m] = a.emits_mask ? e.omask[m] : 1.f;
      }
      a.slot_action[col] = a.prev_action[r];
      a.slot_dt[col] = e.dtc;

      // ---- dwell gate, traces, env window
      const long long a_in = a.prev_action[r];
      const bool select = ((t_r + w) % a.dwell) == 0;
      const long long act = select ? (long long)e.sampled : a_in;
      e.dtc = act != a_in ? 0.f : e.dtc + a.fast_period_s;
      a.prev_action[r] = act;
      e.a_prev = (int)(act < 0 ? 0 : (act >= A ? A - 1 : act));
      a.tr_act[(size_t)w * a.R + r] = act;
      float frac = 0.f;
      for (int m = 0; m < M; ++m) frac += e.omask[m];
      a.tr_r[((size_t)w * 4 + 2) * a.R + r] = e.unstable ? 1.f : 0.f;
      a.tr_r[((size_t)w * 4 + 3) * a.R + r] = frac / (float)M;
      for (int m = 0; m < M; ++m)
        a.tr_rm[((size_t)w * 3 + 2) * ml + rm + m] = e.raw[m];
      env_window(a, e, r, w, e.a_prev);
    }
    __syncthreads();
  }

  // ---- final carries back to global memory
  for (int i = tid; i < S; i += kThreads) a.belief[(size_t)r * S + i] = q[i];
  if (tid == 0) {
    a.scal[(size_t)r * 2 + 0] = e.dtc;
    a.scal[(size_t)r * 2 + 1] = e.ema;
    for (int k = 0; k < K; ++k) {
      a.envk[0 * pl + rk + k] = e.backlog[k];
      a.envk[1 * pl + rk + k] = e.down_left[k];
      a.envk[2 * pl + rk + k] = e.util_accum[k];
      a.envk[3 * pl + rk + k] = e.util_scrape[k];
      a.envk[4 * pl + rk + k] = e.prev_rps[k];
      a.envk[5 * pl + rk + k] = e.tier_requests[k];
      a.envk[6 * pl + rk + k] = e.tier_success[k];
      a.envk[7 * pl + rk + k] = e.n_restarts[k];
      a.tier_util[rk + k] = e.tutil[k];
    }
    a.envr[(size_t)r * 9 + 0] = e.p95_ema;
    a.envr[(size_t)r * 9 + 1] = e.rps_ema;
    a.envr[(size_t)r * 9 + 2] = e.err_ema;
    for (int i = 0; i < 6; ++i) a.envr[(size_t)r * 9 + 3 + i] = e.acct[i];
    for (int m = 0; m < M; ++m) {
      a.obsm[0 * ml + rm + m] = e.raw[m];
      a.obsm[1 * ml + rm + m] = e.omask[m];
      a.obsm[2 * ml + rm + m] = e.held[m];
    }
  }
}

size_t smem_bytes(const MegaArgs& a) {
  const size_t floats = (size_t)a.P * a.S + (size_t)a.A * a.S + 4 * a.S +
                        (size_t)kJChunk * a.A + (size_t)a.A * (a.P + 1) +
                        (size_t)a.A * a.P + 2 * a.A + kWarps;
  return floats * sizeof(float) + sizeof(Env);
}

template <typename TS>
int launch(const MegaArgs& a, void* stream) {
  const size_t smem = smem_bytes(a);
  auto kern = mega_window_kernel<TS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.R, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One whole window for every router.  Returns cudaGetLastError() after the
// launch (0 on success); 1 (cudaErrorInvalidValue) for widths beyond the
// kernel's fixed per-thread accumulators.
int mega_window_launch(const MegaArgs* a, void* stream) {
  if (a->S > kSPer * kThreads || a->A * (a->P + 1) > kAccPer * kThreads ||
      a->K > kMaxKM || a->M > kMaxKM || a->M > 4 || a->W < 1)
    return (int)cudaErrorInvalidValue;
  return a->bf16_slots ? launch<__nv_bfloat16>(*a, stream)
                       : launch<float>(*a, stream);
}

}  // extern "C"
