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
//             (warm: num = b_base[a_prev] qt + sum_j pend_j qn_j)
//   posterior q' = norm(exp(loglik + log max(prior, 1e-30) - max))
//   EFE       on selecting ticks (w % dwell == 0): qa_a = q' / colsum[a],
//             o_a = (u sqa_a projsum + d proj qa_a + sum_j pend_ja qnproj_j)
//                   / max((uS + d) sqa_a + sum_j pend_ja sumqn_j, 1e-30),
//             (warm: s_num_a = b_base[a] qa_a, o_a = (proj s_num_a + sum_j
//             pend_ja qnproj_j) / max(sum s_num_a + sum_j pend_ja sumqn_j,
//             1e-30)),
//             G = risk + ambiguity + cost; sampled = argmax(log max(softmax(
//             -beta G), 1e-30) + gumbel), lowest index on ties
//   dwell     the action changes only where (t + w) % dwell == 0
//   push      slot t0 + w of the tape gets (q, q', bins, mask, a_prev, dt)
//   env       the fluid window of repro_torch/envsim/batched.py
//             ::fluid_window_step: queues, restarts from the given uniforms,
//             the completion-weighted P95, masked and blacked-out telemetry,
//             the fault schedules and, on a fleet graph, the cross-cell
//             spillover and the neighbour-pressure column
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
// temporaries, and, copied once at the window's start by all threads, the
// window's operands (Stage): the router's schedules (arrival, hazard,
// restart uniforms, Gumbel noise, telemetry validity), its pstack rows and
// the shared tables (bin edges, log-preferences, costs, routing weights).
// So the scalar work of a tick (the observation's binning, the sampling
// and the dwell gate on thread 0; the fluid env window on warp 0, lane k
// taking tier k, sums over the tiers gathered by shuffles in tier order)
// reads shared memory only, and the router's carries, prev_action
// included, stay in the block's Env until they are written back once at
// the end: in the first design each of those steps was a chain of global
// loads behind global stores on one thread while 255 waited at a barrier,
// the fixed cost of a window whatever the tape.  The slot tape streams from global memory (at
// J=300 the f32 planes are 583 KB per router, and the Pallas design that
// keeps them resident needs more than a block's 227 KB), but only the
// rows that carry weight: coefact is one-hot per slot (its action), and
// at the window's start the used slots' coefficient rows are read once and
// sorted, stably, into per-action lists of (slot, coefficient) with a
// nonzero coefficient.  A tick's prior walks a_prev's list: one warp per
// entry dots the slot's q_prev row with qt, then every thread adds the
// entries' q_next rows into its own accumulators in slot order, with one
// barrier between.  A selecting tick's EFE walks every entry once (its
// q_prev row against qa of its action), then each (action, p) accumulator
// sums its action's list in slot order.  The terms and their order are
// those of the slot-by-slot walk that skipped zero coefficients, so the
// outputs keep their bits.  The EFE's A x P projection dots go one warp
// per (action, 8 rows of proj), so one qa load serves 8 dots.  In-window pushes land in place at column
// t0 + w, never read by this launch.  bf16 slots are a template
// instantiation: loads widen with __bfloat162float, pushes round to
// nearest even with __float2bfloat16, as torch's cast does.
//
// Numerics: float32, accurate expf/logf, the plain version's guard
// constants, built with -fmad=false so that plain multiplies and adds round
// one at a time as PyTorch's elementwise kernels do (the dot products use
// explicit fmaf).  No atomics: every reduction has a fixed order, so a
// launch is deterministic.  The P95 sorts the K atoms by (latency, index)
// with an insertion sort, the stable order of the plain version's argsort.
// A coefact with more nonzero entries than used slots (the cache never
// builds one) does not fit the lists: the router's belief comes back NaN.
//
// Warm fleets.  A fleet promoted from the dense per-tick path carries its
// learned transition counts as a dense baseline b_base (R, A, S, S) in
// place of the scalar sticky prior (the second template switch, kWarm; a
// fresh fleet's launch compiles and computes as before).  The prior's base
// term becomes the (S, S) matvec b_base[a_prev] qt, one warp per output
// row t reading the row's S contiguous floats (coalesced), into shared
// memory that the selecting branch's qa takes over later; on a selecting
// tick the EFE forms s_num[a] = b_base[a] qa[a] the same way, one warp per
// (a, t) row, into an (A, S) array of shared memory, and projects s_num
// where the fresh branch projects qa.  One router's b_base is A S^2 4 B,
// 4.7 MB at the paper's widths, far above an SM's 228 KB, so it streams
// from L2/HBM: all of it on each selecting tick, one (S, S) slab on every
// tick.  Each dot sums its lane's terms in s order, then across the warp:
// a fixed order, so two launches give the same bits.
//
// Fault schedules (chaos).  forced_down and speed (W, R, K) are staged
// with the other schedules; a null pointer leaves the env's arithmetic as
// it was without them, and a window with neither them nor a graph runs the
// instantiation without their code (the third template switch, kWorld).  env_flow takes the admin-down mask into up, the
// post-restart liveness, the blackout's cell liveness and the published
// tier_up, kills an admin-down tier's in-system mass, and scales service
// rate and time by the speed (clamped at 1e-3), in fluid_window_step's
// order.
//
// Graph windows.  The spillover is a cross-cell exchange inside every
// tick: tick w's admission and fifth telemetry column need the neighbours'
// rejected mass and pressure of the same tick, and tick w + 1's belief
// needs this cell's telemetry of tick w.  With one block a router and far
// more routers than resident blocks (R=4096 against 4 x 132), no barrier
// across the grid exists inside one launch, so a graph window is W + 1
// launches of this kernel over the tick range [w_lo, w_hi): launch i first
// publishes tick i - 1 (env_publish gathers the neighbours' rows of xch,
// written by every block of launch i - 1, along the padded edge lists in
// core/graph.py::segment_sum's order), then runs tick i up to env_flow,
// whose rejected mass and pressure it leaves in xch for launch i + 1.  xch
// holds two ticks by parity, so a launch never overwrites a row that
// another block of it still reads.  The router's carries go back to global
// memory and the slot lists are rebuilt at every launch; no float atomics,
// so two runs give the same bits.  A window without a graph is one launch
// over [0, W) and runs as before.  A cooperative persistent grid looping
// over routers would need the same per-router save and restore of the
// block's state at every tick; the launch split keeps the kernel's shape.
//
// Row blocks (a sharded fleet).  A launch covers one shard's R rows of the
// padded fleet; every operand but the graph's is cut to them, so a block
// index r stays local.  The exchange buffer (2, G_R, kMid) and the padded
// edge lists name global rows: router r is row row0 + r of them.  The
// wrapper runs launch i of every block before launch i + 1 of any, so a
// block reads every other block's rows of the tick; a fleet of one block
// has row0 = 0 and G_R = R and runs as before.
//
// The tape rows are still reread on every tick that needs them; keeping
// them in L2 or shared memory across ticks, TMA copies and wgmma are later
// work.

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
  const float* b_base;      // (R, A, S, S) warm baseline, or null (fresh)
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
  // fault schedules of this window, or null
  const float* forced_down; // (W, R, K) 1 = tier administratively down
  const float* speed;       // (W, R, K) service-speed multiplier
  // fleet graph (null src: no graph), see core/graph.py::GraphData
  const long long* g_src;   // (G_E) edge sources
  const long long* g_dst;   // (G_E) edge destinations
  const float* g_share;     // (G_E) 1 / out-degree of the source
  const float* g_hop;       // (G_E) hop latency, seconds
  const float* g_has_out;   // (G_R) 1 where the cell has an out-edge
  const long long* g_in;    // (G_R, G_din) in-edges in edge order, padded with G_E
  const long long* g_out;   // (G_R, G_dout) out-edges, padded with G_E
  float* xch;               // (2, G_R, kMid) per-tick exchange, by tick parity
  float* tr_g;              // (W, 4, R): spill_out, spill_in, spill_admitted,
                            //   nbr_pressure
  int R, J, S, A, M, NB, K, W, P, E, n_util_edges, n_used, t0, dwell,
      util_period, scrape_every, err_ix, emits_mask, masked_obs,
      restart_blackout, bf16_slots, G_E, G_din, G_dout, G_R, row0, w_lo,
      w_hi;
  float dt, fast_period_s, err_decay, err_keep, error_trigger, beta, u_c, d_c,
      usd, log_match, log_miss, timeout_s, a_lat, a_err, a_rps, keep_lat,
      keep_err, keep_rps, scrape_den;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSPer = 4;         // S <= kSPer * kThreads
constexpr int kAccPer = 4;       // A * (P + 1) <= kAccPer * kThreads
constexpr int kMaxKM = 8;        // K, M <= 8
constexpr float kEps = 1e-9f;    // envsim.batched._EPS
// The env's per-router results of a tick's flow that its publish step
// reads (Env::mid; on a graph window also xch's rows between launches).
enum Mid {
  kSuccess, kOver, kTimedOut, kKilled, kArrived, kRefused, kP95, kCellUp,
  kRej, kPress, kMid
};

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
  long long pa;             // prev_action[r] as carried (a_prev is clamped)
  int bad;                  // coefact had more nonzeros than the lists hold
  float mid[kMid];          // env_flow's results for env_publish
};

// The window's operands of one router, copied into shared memory once at
// the window's start, so that the per-tick scalar work reads no global
// memory.
struct Stage {
  float *arrival;           // (W)
  float *hazard;            // (W, K)
  float *uni;               // (W, 2, K): fire, duration
  float *gumbel;            // (W, A)
  float *ov;                // (W, M), when obs_valid is given
  float *fd;                // (W, K), when forced_down is given
  float *sp;                // (W, K), when speed is given
  float *ps;                // (12, K) this router's pstack rows
  float *obs_edges;         // (M, E)
  float *util_edges;        // (n_util_edges)
  float *logc;              // (2, M, NB)
  float *cost;              // (A)
  float *ptable;            // (A, K)
  int *n_edges;             // (M)
  // per-action slot lists: entries [off[a], off[a + 1]) hold, in slot
  // order, the used slots j with coefact[j, a] != 0
  int *off;                 // (A + 1)
  int *slot;                // (n_used) entries' slots
  int *act;                 // (n_used) entries' actions
  float *coef;              // (n_used) entries' coefficients
  float *pend;              // (n_used) entries' pend terms
};

// floats (or ints) of shared memory the Stage takes.
__host__ __device__ inline size_t stage_words(const MegaArgs& a) {
  return (size_t)a.W * (1 + 5 * a.K + a.A + a.M) + 12 * a.K +
         (size_t)a.M * a.E + a.n_util_edges + 2 * a.M * a.NB + a.A +
         (size_t)a.A * a.K + a.M + (a.A + 1) + 4 * (size_t)a.n_used;
}

// lane k's v summed over the K tiers in tier order; every lane gets it.
__device__ __forceinline__ float tier_sum(float v, int K) {
  float s = 0.f;
  for (int i = 0; i < K; ++i) s += __shfl_sync(0xffffffffu, v, i);
  return s;
}

// One fluid window for router r, in two steps that run on warp 0 over the
// window's operands staged in shared memory: the arithmetic of
// envsim/batched.py::fluid_window_step in the same order.  Lane k < K does
// tier k's work; every sum over the tiers is taken in tier order
// (tier_sum), and the router's scalars are updated by lane 0.
//
// env_flow: arrivals, service, queue caps, the restart draw and, with the
// fault schedules, admin-down tiers (refuse arrivals, serve nothing, lose
// their in-system mass, probe as down) and the speed multiplier (capacity
// and service time, speed clamped at 1e-3); then the sums over the tiers,
// the P95 atom, the tier traces and, on a graph window, the cell's
// rejected mass and pressure, the two numbers its neighbours read.  Its
// per-router results go to e.mid.
template <bool kWorld>
__device__ void env_flow(const MegaArgs& a, const Stage& g, Env& e, int r,
                         int w, int action, int lane) {
  const int R = a.R, K = a.K;
  const int k = lane;
  const bool tier = k < K;
  const size_t rk = (size_t)r * K;
  const float* ps = g.ps;           // (12, K): plane i at ps[i * K]
  float wsum = 0.f;
  for (int i = 0; i < K; ++i) wsum += fmaxf(g.ptable[action * K + i], 0.f);
  wsum = fmaxf(wsum, 1e-12f);
  const float rate = g.arrival[w];
  float lam = 0.f, arr = 0.f, over = 0.f, lat = 0.f, p95 = 0.f, timed = 0.f,
        comp = 0.f, cap_rate = 0.f, b1 = 0.f, refusing = 0.f, adminf = 0.f;
  bool up = false;
  if (tier) {
    const float wn = fmaxf(g.ptable[action * K + k], 0.f) / wsum;
    up = e.down_left[k] <= kEps;
    if (kWorld && a.forced_down) {
      adminf = g.fd[w * K + k];
      up = up && adminf <= 0.5f;
    }
    const float upf = up ? 1.f : 0.f;
    float mu = ps[1 * K + k], svc = ps[2 * K + k];
    if (kWorld && a.speed) {
      const float sp = fmaxf(g.sp[w * K + k], 1e-3f);
      mu = mu * sp;
      svc = svc / sp;
    }
    lam = wn * rate;
    arr = lam * a.dt;
    refusing = arr * (1.f - upf);
    const float admitted = arr * upf;
    const float servers = ps[0 * K + k];
    cap_rate = servers * mu;
    const float cap = cap_rate * a.dt * upf;
    const float avail = e.backlog[k] + admitted;
    const float served = fminf(avail, cap);
    b1 = avail - served;
    const float syscap = ps[4 * K + k] + servers;
    over = fmaxf(b1 - syscap, 0.f);
    b1 = b1 - over;
    const float wait =
        cap_rate > 0.f ? 0.5f * (e.backlog[k] + b1) / fmaxf(cap_rate, kEps)
                       : 0.f;
    lat = wait + svc;
    p95 = wait + svc * ps[3 * K + k];
    timed = lat > a.timeout_s ? served : 0.f;
    comp = served - timed;
    const float util =
        cap > 0.f ? served / fmaxf(cap_rate * a.dt, kEps) : 0.f;
    e.util_accum[k] = e.util_accum[k] + util * a.dt;
  }
  const float refused = tier_sum(refusing, K);
  const int t_idx = a.t0 + w;
  const bool scrape_now = ((t_idx + 1) % a.scrape_every) == 0;
  float util_old = 0.f, restarted = 0.f, killed = 0.f;
  if (tier) {
    util_old = e.util_scrape[k];
    if (scrape_now) {
      e.util_scrape[k] = e.util_accum[k] / a.scrape_den;
      e.util_accum[k] = 0.f;
    }
    const float rps_delta = lam - e.prev_rps[k];
    const float hazard =
        g.hazard[w * K + k] * ps[5 * K + k] *
        (ps[6 * K + k] +
         ps[7 * K + k] * fmaxf(e.util_scrape[k] - ps[8 * K + k], 0.f) +
         ps[9 * K + k] * fmaxf(rps_delta, 0.f) / fmaxf(cap_rate, kEps));
    const float p_restart = 1.f - expf(-hazard * a.dt);
    restarted = (up && g.uni[(w * 2 + 0) * K + k] < p_restart) ? 1.f : 0.f;
    killed = b1 * restarted;
    e.backlog[k] = b1 * (1.f - restarted);
    if (kWorld && a.forced_down) {
      // an admin-down tier strands its in-system mass (a restart cannot
      // fire there, so nothing is counted twice)
      killed = killed + e.backlog[k] * adminf;
      e.backlog[k] = e.backlog[k] * (1.f - adminf);
    }
    const float rmin = ps[10 * K + k], rmax = ps[11 * K + k];
    const float dur = rmin + g.uni[(w * 2 + 1) * K + k] * (rmax - rmin);
    const float dl = fmaxf(e.down_left[k] - a.dt, 0.f);
    e.down_left[k] = restarted > 0.f ? dur : dl;
  }

  // accounting
  const float win_success = tier_sum(comp, K), over_sum = tier_sum(over, K),
              to_sum = tier_sum(timed, K), kill_sum = tier_sum(killed, K),
              arr_sum = tier_sum(arr, K);

  // completion-weighted P95: stable (latency, index) order, first atom
  // whose cumulative share reaches 0.95 (every lane, on the gathered atoms)
  float p95s[kMaxKM], comps[kMaxKM];
  for (int i = 0; i < K; ++i) {
    p95s[i] = __shfl_sync(0xffffffffu, p95, i);
    comps[i] = __shfl_sync(0xffffffffu, comp, i);
  }
  int order[kMaxKM];
  for (int j = 0; j < K; ++j) {
    int i = j;
    while (i > 0 && p95s[order[i - 1]] > p95s[j]) {
      order[i] = order[i - 1];
      --i;
    }
    order[i] = j;
  }
  float total = 0.f;
  for (int i = 0; i < K; ++i) total += comps[order[i]];
  total = fmaxf(total, kEps);
  float p95_win = 0.f, cum = 0.f;
  for (int i = 0; i < K; ++i) {
    cum += comps[order[i]];
    if (cum / total >= 0.95f) {
      p95_win = p95s[order[i]];
      break;
    }
  }
  // post-restart liveness (admin-down tiers are down): the blackout's cell
  // liveness and the spillover's live capacity
  const bool live = tier && e.down_left[k] <= kEps && adminf <= 0.5f;
  const bool cell_up = __ballot_sync(0xffffffffu, tier && !live) == 0;
  if (a.masked_obs && a.restart_blackout && !cell_up && tier)
    e.util_scrape[k] = util_old;
  float press = 0.f;
  if (kWorld && a.g_src) {
    // in-system mass over live system capacity (down cells saturate the
    // clip): the pressure a neighbour publishes
    const float bsum = tier_sum(tier ? e.backlog[k] : 0.f, K);
    const float csum = tier_sum(
        tier ? (ps[4 * K + k] + ps[0 * K + k]) * (live ? 1.f : 0.f) : 0.f,
        K);
    press = fminf(bsum / fmaxf(csum, kEps), 1e3f);
  }
  if (tier) {
    e.tier_requests[k] += arr;
    e.tier_success[k] += comp;
    e.n_restarts[k] += restarted;
    e.prev_rps[k] = lam;
    // traces (the queue row is env_publish's)
    const size_t rl = (size_t)R * K;  // one trace plane
    float* rk_row = a.tr_rk + (size_t)w * 8 * rl + rk + k;
    float tier_up = e.down_left[k] <= kEps ? 1.f : 0.f;
    if (kWorld && a.forced_down) tier_up = tier_up * (1.f - adminf);
    rk_row[0 * rl] = g.ptable[action * K + k];
    rk_row[1 * rl] = e.util_scrape[k];
    rk_row[2 * rl] = tier_up;
    rk_row[4 * rl] = lat;
    rk_row[5 * rl] = p95;
    rk_row[6 * rl] = comp;
    rk_row[7 * rl] = restarted;
    e.tutil[k] = e.util_scrape[k];
  }
  if (lane == 0) {
    e.mid[kSuccess] = win_success;
    e.mid[kOver] = over_sum;
    e.mid[kTimedOut] = to_sum;
    e.mid[kKilled] = kill_sum;
    e.mid[kArrived] = arr_sum;
    e.mid[kRefused] = refused;
    e.mid[kP95] = p95_win;
    e.mid[kCellUp] = cell_up ? 1.f : 0.f;
    e.mid[kRej] = refused + over_sum;
    e.mid[kPress] = press;
  }
  __syncwarp();
}

// env_publish: the rest of the tick from e.mid.  On a graph window first
// the spillover: the mass this cell's in-neighbours rejected (offered along
// each edge split 1/out-degree, paying the edge's hop) is admitted into the
// live headroom whose estimated response beats the timeout, and the mean
// pressure of its out-neighbours becomes the fifth telemetry column; the
// neighbours' rejected mass and pressure of tick w are read from xch,
// gathered along the padded edge lists and added left to right as
// core/graph.py::segment_sum adds them.  Then the queues, the observation
// EMAs, the telemetry mask and stale hold, and the accounting.
template <bool kWorld>
__device__ void env_publish(const MegaArgs& a, const Stage& g, Env& e, int r,
                            int w, int lane) {
  const int R = a.R, K = a.K, M = a.M;
  const int k = lane;
  const bool tier = k < K;
  const size_t rk = (size_t)r * K;
  const float* ps = g.ps;
  const bool graph = kWorld && a.g_src != nullptr;
  float spill_in = 0.f, hop_mass = 0.f, nbr = 0.f, spill_adm = 0.f,
        spill_drop = 0.f, keep = 1.f, has_out = 0.f;
  const size_t rg = (size_t)a.row0 + r;   // the router's global row
  if (graph) {
    if (lane == 0) {
      const float* x = a.xch + (size_t)(w & 1) * a.G_R * kMid;
      const long long* in = a.g_in + rg * a.G_din;
      for (int d = 0; d < a.G_din; ++d) {
        const long long ei = in[d];
        float v = 0.f, hv = 0.f;
        if (ei < a.G_E) {
          v = x[(size_t)a.g_src[ei] * kMid + kRej] * a.g_share[ei];
          hv = v * a.g_hop[ei];
        }
        spill_in = d ? spill_in + v : v;
        hop_mass = d ? hop_mass + hv : hv;
      }
      const long long* out = a.g_out + rg * a.G_dout;
      for (int d = 0; d < a.G_dout; ++d) {
        const long long ei = out[d];
        const float v =
            ei < a.G_E ? x[(size_t)a.g_dst[ei] * kMid + kPress] * a.g_share[ei]
                       : 0.f;
        nbr = d ? nbr + v : v;
      }
    }
    spill_in = __shfl_sync(0xffffffffu, spill_in, 0);
    hop_mass = __shfl_sync(0xffffffffu, hop_mass, 0);
    nbr = __shfl_sync(0xffffffffu, nbr, 0);
    const float hop_mean = hop_mass / fmaxf(spill_in, kEps);
    float room = 0.f;
    if (tier) {
      float mu = ps[1 * K + k], svc = ps[2 * K + k], adminf = 0.f;
      if (kWorld && a.forced_down) adminf = g.fd[w * K + k];
      if (kWorld && a.speed) {
        const float sp = fmaxf(g.sp[w * K + k], 1e-3f);
        mu = mu * sp;
        svc = svc / sp;
      }
      const float cap_rate = ps[0 * K + k] * mu;
      const float syscap = ps[4 * K + k] + ps[0 * K + k];
      const bool live = e.down_left[k] <= kEps && adminf <= 0.5f;
      const float est = hop_mean + e.backlog[k] / fmaxf(cap_rate, kEps) + svc;
      const float viable =
          (est <= a.timeout_s ? 1.f : 0.f) * (live ? 1.f : 0.f);
      room = fmaxf(syscap - e.backlog[k], 0.f) * viable;
    }
    const float room_tot = tier_sum(room, K);
    spill_adm = fminf(spill_in, room_tot);
    if (tier)
      e.backlog[k] = e.backlog[k] + room * (spill_adm / fmaxf(room_tot, kEps));
    spill_drop = spill_in - spill_adm;
    has_out = a.g_has_out[rg];
    keep = 1.f - has_out;    // exporters keep none of their rejects
  }
  const float queue = tier ? fmaxf(e.backlog[k] - ps[0 * K + k], 0.f) : 0.f;
  const float depth = tier_sum(queue, K);
  if (tier) a.tr_rk[((size_t)w * 8 + 3) * R * K + rk + k] = queue;
  if (lane == 0) {
    const float* mid = e.mid;
    const float win_success = mid[kSuccess];
    const float win_fail =
        graph ? mid[kRefused] * keep + mid[kOver] * keep + spill_drop +
                    mid[kTimedOut] + mid[kKilled]
              : mid[kRefused] + mid[kOver] + mid[kTimedOut] + mid[kKilled];
    if (win_success > kEps)
      e.p95_ema = a.keep_lat * e.p95_ema + a.a_lat * mid[kP95];
    const float total_win = win_success + win_fail;
    const float err_frac = win_fail / fmaxf(total_win, kEps);
    if (total_win > kEps)
      e.err_ema = a.keep_err * e.err_ema + a.a_err * err_frac;
    e.rps_ema = a.keep_rps * e.rps_ema + a.a_rps * g.arrival[w];

    // telemetry: validity mask, blackout, stale hold (a graph world's
    // fifth column is the neighbour pressure)
    const float fresh[5] = {e.p95_ema, e.rps_ema, depth, e.err_ema, nbr};
    const bool cell_up = mid[kCellUp] > 0.f;
    float wmask[kMaxKM], pub[kMaxKM];
    for (int m = 0; m < M; ++m) {
      wmask[m] = 1.f;
      pub[m] = fresh[m];
      if (a.masked_obs) {
        if (a.obs_valid) wmask[m] = g.ov[w * M + m];
        if (a.restart_blackout) wmask[m] = wmask[m] * (cell_up ? 1.f : 0.f);
        pub[m] = wmask[m] > 0.f ? fresh[m] : e.held[m];
      }
    }
    e.acct[0] += mid[kArrived];
    e.acct[1] += win_success;
    e.acct[2] += mid[kTimedOut];
    if (graph) {
      e.acct[3] = e.acct[3] + mid[kOver] * keep + spill_drop;
      e.acct[4] += mid[kRefused] * keep;
    } else {
      e.acct[3] += mid[kOver];
      e.acct[4] += mid[kRefused];
    }
    e.acct[5] += mid[kKilled];
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
    if (graph) {
      float* tg = a.tr_g + (size_t)w * 4 * R + r;
      tg[0 * R] = mid[kRej] * has_out;
      tg[1 * R] = spill_in;
      tg[2 * R] = spill_adm;
      tg[3 * R] = nbr;
    }
  }
  __syncwarp();
}

// Four blocks an SM (64 registers a thread, no spills at the paper's
// widths): the per-tick scalar chains and barriers of one router hide
// behind the others'.  kWarm: the fleet has a dense b_base baseline.
// kWorld: the window has fault schedules or a fleet graph (their code is
// compiled out of the other instantiations, whose registers stay unspilled).
template <typename TS, bool kWarm, bool kWorld>
__global__ void __launch_bounds__(kThreads, 4)
mega_window_kernel(const MegaArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int S = a.S, A = a.A, P = a.P, M = a.M, NB = a.NB, K = a.K,
            J = a.J, W = a.W, MNB = a.M * a.NB, P1 = a.P + 1;
  Env& e = *reinterpret_cast<Env*>(smem);
  float* proj = smem + sizeof(Env) / sizeof(float);   // P * S
  float* qa = proj + P * S;       // A * S
  float* q = qa + A * S;          // S   belief
  float* qn = q + S;              // S   posterior
  float* qt = qn + S;             // S   q / colsum[a_prev]
  float* lp = qt + S;             // S   loglik, then the log-posterior
  float* so = lp + S;             // A * (P + 1) slot sums
  float* pd = so + A * P1;        // A * P proj . qa
  float* gsh = pd + A * P;        // A   G
  float* sqa = gsh + A;           // A
  float* red = sqa + A;           // kWarps
  float* sn = red + kWarps;       // A * S  s_num (kWarm only)
  Stage g;
  g.arrival = sn + (kWarm ? A * S : 0);
  g.hazard = g.arrival + W;
  g.uni = g.hazard + W * K;
  g.gumbel = g.uni + 2 * W * K;
  g.ov = g.gumbel + W * A;
  g.fd = g.ov + W * M;
  g.sp = g.fd + W * K;
  g.ps = g.sp + W * K;
  g.obs_edges = g.ps + 12 * K;
  g.util_edges = g.obs_edges + M * a.E;
  g.logc = g.util_edges + a.n_util_edges;
  g.cost = g.logc + 2 * MNB;
  g.ptable = g.cost + A;
  g.n_edges = reinterpret_cast<int*>(g.ptable + A * K);
  g.off = g.n_edges + M;
  g.slot = g.off + A + 1;
  g.act = g.slot + a.n_used;
  g.coef = reinterpret_cast<float*>(g.act + a.n_used);
  g.pend = g.coef + a.n_used;

  const TS* qp_r = reinterpret_cast<const TS*>(a.q_prev) + (size_t)r * J * S;
  const TS* qn_r = reinterpret_cast<const TS*>(a.q_next) + (size_t)r * J * S;
  const float* colsum_r = a.colsum + (size_t)r * A * S;
  const float* coef_r = a.coefact + (size_t)r * J * A;
  const float* qnproj_r = a.qnproj + (size_t)r * J * P;
  const float* sumqn_r = a.sumqn + (size_t)r * J;
  const float* projsum_r = a.projsum + (size_t)r * P;
  const float* logna_r = a.logna + (size_t)r * MNB * S;
  const float* bb_r = kWarm ? a.b_base + (size_t)r * A * S * S : nullptr;
  const size_t rk = (size_t)r * K, pl = (size_t)a.R * K;
  const size_t rm = (size_t)r * M, ml = (size_t)a.R * M;
  const int n_used = a.n_used;

  for (int i = tid; i < P * S; i += kThreads)
    proj[i] = a.proj[(size_t)r * P * S + i];
  for (int i = tid; i < S; i += kThreads) q[i] = a.belief[(size_t)r * S + i];
  // the window's schedules, noise and tables (see Stage)
  for (int i = tid; i < W; i += kThreads)
    g.arrival[i] = a.arrival[(size_t)i * a.R + r];
  for (int i = tid; i < W * K; i += kThreads)
    g.hazard[i] = a.hazard[((size_t)(i / K) * a.R + r) * K + i % K];
  for (int i = tid; i < 2 * W * K; i += kThreads)
    g.uni[i] = a.uniforms[((size_t)(i / K) * a.R + r) * K + i % K];
  for (int i = tid; i < W * A; i += kThreads)
    g.gumbel[i] = a.gumbel[((size_t)(i / A) * a.R + r) * A + i % A];
  if (a.obs_valid)
    for (int i = tid; i < W * M; i += kThreads)
      g.ov[i] = a.obs_valid[((size_t)(i / M) * a.R + r) * M + i % M];
  if (kWorld && a.forced_down)
    for (int i = tid; i < W * K; i += kThreads)
      g.fd[i] = a.forced_down[((size_t)(i / K) * a.R + r) * K + i % K];
  if (kWorld && a.speed)
    for (int i = tid; i < W * K; i += kThreads)
      g.sp[i] = a.speed[((size_t)(i / K) * a.R + r) * K + i % K];
  for (int i = tid; i < 12 * K; i += kThreads)
    g.ps[i] = a.pstack[((size_t)(i / K) * a.R + r) * K + i % K];
  for (int i = tid; i < M * a.E; i += kThreads) g.obs_edges[i] = a.obs_edges[i];
  for (int i = tid; i < a.n_util_edges; i += kThreads)
    g.util_edges[i] = a.util_edges[i];
  for (int i = tid; i < 2 * MNB; i += kThreads) g.logc[i] = a.logc[i];
  for (int i = tid; i < A; i += kThreads) g.cost[i] = a.cost[i];
  for (int i = tid; i < A * K; i += kThreads) g.ptable[i] = a.ptable[i];
  for (int i = tid; i < M; i += kThreads) g.n_edges[i] = a.n_edges[i];
  // Per-action slot lists, a stable counting sort of the used slots' nonzero
  // coefficients by action: each warp counts its actions' entries, thread 0
  // turns the counts into offsets, then each warp writes its actions'
  // entries in slot order.  coefact is one-hot per slot, so the entries
  // number at most n_used; more (a coefact the cache never builds) set bad.
  for (int ai = warp; ai < A; ai += kWarps) {
    int n = 0;
    for (int j0 = 0; j0 < n_used; j0 += 32) {
      const int j = j0 + lane;
      n += __popc(__ballot_sync(
          0xffffffffu, j < n_used && coef_r[(size_t)j * A + ai] != 0.f));
    }
    if (lane == 0) g.off[ai + 1] = n;
  }
  __syncthreads();
  if (tid == 0) {
    g.off[0] = 0;
    for (int ai = 0; ai < A; ++ai) g.off[ai + 1] += g.off[ai];
    e.bad = g.off[A] > n_used;
  }
  __syncthreads();
  if (!e.bad) {
    for (int ai = warp; ai < A; ai += kWarps) {
      int at = g.off[ai];
      for (int j0 = 0; j0 < n_used; j0 += 32) {
        const int j = j0 + lane;
        const float c = j < n_used ? coef_r[(size_t)j * A + ai] : 0.f;
        const unsigned nz = __ballot_sync(0xffffffffu, c != 0.f);
        if (c != 0.f) {
          const int i = at + __popc(nz & ((1u << lane) - 1u));
          g.slot[i] = j;
          g.act[i] = ai;
          g.coef[i] = c;
        }
        at += __popc(nz);
      }
    }
  }
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
    const long long ap = a.prev_action[r];
    e.pa = ap;
    e.a_prev = (int)(ap < 0 ? 0 : (ap >= A ? A - 1 : ap));
    e.dtc = a.scal[(size_t)r * 2 + 0];
    e.ema = a.scal[(size_t)r * 2 + 1];
  }
  const long long t_r = a.t[r];
  const bool graph = kWorld && a.g_src != nullptr;
  __syncthreads();

  // a graph window's launch first publishes the previous tick, whose
  // spillover needed every cell's flow of that tick (the previous launch)
  if (graph && a.w_lo > 0) {
    if (warp == 0) {
      const int wp = a.w_lo - 1;
      if (lane < kMid)
        e.mid[lane] =
            a.xch[((size_t)(wp & 1) * a.G_R + a.row0 + r) * kMid + lane];
      __syncwarp();
      env_publish<kWorld>(a, g, e, r, wp, lane);
    }
    __syncthreads();
  }

  for (int w = a.w_lo; w < a.w_hi; ++w) {
    const int t_idx = a.t0 + w;
    const bool selecting = (w % a.dwell) == 0;

    // ---- observe, error EMA, adaptive preference switch (thread 0)
    if (tid == 0) {
      for (int m = 0; m < M; ++m) {
        int b = 0;
        for (int i = 0; i < g.n_edges[m]; ++i)
          b += e.raw[m] >= g.obs_edges[m * a.E + i];
        e.bins[m] = b;
      }
      for (int k = 0; k < K; ++k) {
        int b = 0;
        for (int i = 0; i < a.n_util_edges; ++i)
          b += e.tutil[K - 1 - k] >= g.util_edges[i];
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

    // ---- slot term of the prior: sum_j pend_j qn_j over a_prev's list
    // (the used slots j < t0 whose coefficient for a_prev is not zero), in
    // slot order: one warp per entry forms pend, then every thread adds
    // the entries into its own accumulators
    float acc[kSPer];
#pragma unroll
    for (int i = 0; i < kSPer; ++i) acc[i] = 0.f;
    const int l0 = e.bad ? 0 : g.off[ap], l1 = e.bad ? 0 : g.off[ap + 1];
    for (int i = l0 + warp; i < l1; i += kWarps) {
      const float v = g.coef[i] * row_dot(qp_r + (size_t)g.slot[i] * S, qt, S);
      if (lane == 0) g.pend[i] = v;
    }
    // warm: the baseline term b_base[a_prev] qt, one warp per row t, into
    // qa's first S floats (qa is free until the selecting branch)
    if (kWarm) {
      const float* bp = bb_r + (size_t)ap * S * S;
      for (int t = warp; t < S; t += kWarps) {
        const float v = row_dot(bp + (size_t)t * S, qt, S);
        if (lane == 0) qa[t] = v;
      }
    }
    __syncthreads();
    for (int i = l0; i < l1; ++i) {
      const float pj = g.pend[i];
      if (pj == 0.f) continue;
      const TS* row = qn_r + (size_t)g.slot[i] * S;
#pragma unroll
      for (int u = 0; u < kSPer; ++u) {
        const int s = tid + u * kThreads;
        if (s < S) acc[u] = fmaf(pj, load(row + s), acc[u]);
      }
    }

    // ---- prior, posterior
    part = 0.f;
#pragma unroll
    for (int i = 0; i < kSPer; ++i) {
      const int s = tid + i * kThreads;
      if (s < S) {
        const float num =
            kWarm ? qa[s] + acc[i] : a.u_c * sum_qt + a.d_c * qt[s] + acc[i];
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
      // warm: s_num[a] = b_base[a] qa[a], one warp per (a, t) row; the
      // sums and projections below then read s_num where they read qa
      if (kWarm) {
        for (int u = warp; u < A * S; u += kWarps) {
          const int ai = u / S;
          const float v = row_dot(bb_r + (size_t)u * S, qa + (size_t)ai * S, S);
          if (lane == 0) sn[u] = v;
        }
        __syncthreads();
      }
      const float* src = kWarm ? sn : qa;
      for (int ai = warp; ai < A; ai += kWarps) {
        float v = 0.f;
        for (int s = lane; s < S; s += 32) v += src[(size_t)ai * S + s];
        v = warp_sum(v);
        if (lane == 0) sqa[ai] = v;
      }
      // proj . qa: one warp per (action, 8 rows of proj), so a qa load
      // serves 8 dots; each dot sums its lane's terms in s order, then
      // across the warp
      const int p8 = (P + 7) / 8;
      for (int u = warp; u < A * p8; u += kWarps) {
        const int ai = u / p8, p0 = (u % p8) * 8;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
        for (int s = lane; s < S; s += 32) {
          const float x = src[(size_t)ai * S + s];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (p0 + j < P) v[j] = fmaf(proj[(size_t)(p0 + j) * S + s], x, v[j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (p0 + j >= P) break;
          v[j] = warp_sum(v[j]);
          if (lane == 0) pd[ai * P + p0 + j] = v[j];
        }
      }
      // every list entry's pend against qa of its action (one warp per
      // entry), then each (action, p) sum over its action's list in slot
      // order
      float acc2[kAccPer];
#pragma unroll
      for (int i = 0; i < kAccPer; ++i) acc2[i] = 0.f;
      const int n_ent = e.bad ? 0 : g.off[A];
      for (int i = warp; i < n_ent; i += kWarps) {
        const float d = row_dot(qp_r + (size_t)g.slot[i] * S,
                                qa + (size_t)g.act[i] * S, S);
        if (lane == 0) g.pend[i] = g.coef[i] * d;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kAccPer; ++i) {
        const int idx = tid + i * kThreads;
        if (idx < A * P1 && !e.bad) {
          const int ai = idx / P1, p = idx % P1;
          for (int u = g.off[ai]; u < g.off[ai + 1]; ++u) {
            const float pv = g.pend[u];
            if (pv == 0.f) continue;
            const int j = g.slot[u];
            const float x = p < P ? qnproj_r[(size_t)j * P + p] : sumqn_r[j];
            acc2[i] = fmaf(pv, x, acc2[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kAccPer; ++i) {
        const int idx = tid + i * kThreads;
        if (idx < A * P1) so[idx] = acc2[i];
      }
      __syncthreads();
      const float* logc = g.logc + (e.unstable ? MNB : 0);
      for (int ai = tid; ai < A; ai += kThreads) {
        const float sq = sqa[ai];
        const float sden = fmaxf(
            kWarm ? sq + so[ai * P1 + P] : a.usd * sq + so[ai * P1 + P],
            1e-30f);
        float risk = 0.f, amb = 0.f;
        for (int p = 0; p < P; ++p) {
          const float onum =
              kWarm ? pd[ai * P + p] + so[ai * P1 + p]
                    : a.u_c * sq * projsum_r[p] + a.d_c * pd[ai * P + p] +
                          so[ai * P1 + p];
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
        gsh[ai] = risk + amb + g.cost[ai];
      }
      __syncthreads();
      if (tid == 0) {
        float gmax = -INFINITY;
        for (int ai = 0; ai < A; ++ai) gmax = fmaxf(gmax, -a.beta * gsh[ai]);
        float z = 0.f;
        for (int ai = 0; ai < A; ++ai) z += expf(-a.beta * gsh[ai] - gmax);
        const float* gum = g.gumbel + w * A;
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
      a.slot_action[col] = e.pa;
      a.slot_dt[col] = e.dtc;

      // ---- dwell gate, traces, env window
      const long long a_in = e.pa;
      const bool select = ((t_r + w) % a.dwell) == 0;
      const long long act = select ? (long long)e.sampled : a_in;
      e.dtc = act != a_in ? 0.f : e.dtc + a.fast_period_s;
      e.pa = act;
      e.a_prev = (int)(act < 0 ? 0 : (act >= A ? A - 1 : act));
      a.tr_act[(size_t)w * a.R + r] = act;
      float frac = 0.f;
      for (int m = 0; m < M; ++m) frac += e.omask[m];
      a.tr_r[((size_t)w * 4 + 2) * a.R + r] = e.unstable ? 1.f : 0.f;
      a.tr_r[((size_t)w * 4 + 3) * a.R + r] = frac / (float)M;
      for (int m = 0; m < M; ++m)
        a.tr_rm[((size_t)w * 3 + 2) * ml + rm + m] = e.raw[m];
    }
    if (warp == 0) {
      __syncwarp();
      env_flow<kWorld>(a, g, e, r, w, e.a_prev, lane);
      if (!graph)
        env_publish<kWorld>(a, g, e, r, w, lane);
      else if (lane < kMid)   // for the next launch: this router and its
        a.xch[((size_t)(w & 1) * a.G_R + a.row0 + r) * kMid + lane] =
            e.mid[lane];

    }
    __syncthreads();
  }

  // ---- final carries back to global memory (NaN beliefs flag a coefact
  // the slot lists could not hold)
  for (int i = tid; i < S; i += kThreads)
    a.belief[(size_t)r * S + i] = e.bad ? NAN : q[i];
  if (tid == 0) {
    a.prev_action[r] = e.pa;
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
                        (size_t)a.A * (a.P + 1) + (size_t)a.A * a.P +
                        2 * a.A + kWarps + stage_words(a) +
                        (a.b_base ? (size_t)a.A * a.S : 0);
  return floats * sizeof(float) + sizeof(Env);
}

template <typename TS, bool kWarm, bool kWorld>
int launch(const MegaArgs& a, void* stream) {
  const size_t smem = smem_bytes(a);
  auto kern = mega_window_kernel<TS, kWarm, kWorld>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.R, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kWarm, bool kWorld>
int launch_slots(const MegaArgs& a, void* stream) {
  return a.bf16_slots ? launch<__nv_bfloat16, kWarm, kWorld>(a, stream)
                      : launch<float, kWarm, kWorld>(a, stream);
}

}  // namespace

extern "C" {

// One whole window for every router.  Returns cudaGetLastError() after the
// launch (0 on success); 1 (cudaErrorInvalidValue) for widths beyond the
// kernel's fixed per-thread accumulators.
int mega_window_launch(const MegaArgs* a, void* stream) {
  if (a->S > kSPer * kThreads || a->A * (a->P + 1) > kAccPer * kThreads ||
      a->K > kMaxKM || a->M != 4 + (a->g_src ? 1 : 0) || a->W < 1 ||
      a->w_lo < 0 || a->w_hi < a->w_lo || a->w_hi > a->W ||
      (!a->g_src && (a->w_lo != 0 || a->w_hi != a->W)) ||
      (a->g_src && (!a->xch || !a->tr_g || !a->g_in || !a->g_out ||
                    a->row0 < 0 || a->row0 + a->R > a->G_R)))
    return (int)cudaErrorInvalidValue;
  const bool world = a->forced_down || a->speed || a->g_src;
  if (world) return a->b_base ? launch_slots<true, true>(*a, stream)
                              : launch_slots<false, true>(*a, stream);
  return a->b_base ? launch_slots<true, false>(*a, stream)
                   : launch_slots<false, false>(*a, stream);
}

}  // extern "C"
