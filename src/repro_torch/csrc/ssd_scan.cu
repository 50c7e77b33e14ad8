// Mamba-2 SSD chunked scan, CUDA C++ for sm_90a: kernel B6.
//
// Replaces the Pallas TPU kernel of the JAX package
// src/repro/kernels/ssd/ssd.py::ssd_pallas ("B6", _ssd_kernel) and, on the
// model path, the XLA oracle it stands in for,
// src/repro/models/ssm.py::ssd_chunked (the reference's mamba_forward calls
// the oracle directly).  It computes the function of the plain version in
// repro_torch/kernels/ssd/ref.py::ssd_chunked.  Per (batch, head), over
// chunks of Q rows with cs = cumsum(dt * a) inside each chunk:
//
//   y_r   = sum_{s<=r} (C_r . B_s) exp(cs_r - cs_s) xbar_s      (intra-chunk)
//         + exp(cs_r) (C_r . state^T)                           (carried state)
//   state = exp(cs_last) state + sum_s exp(cs_last - cs_s) xbar_s^T B_s
//
// with xbar = x * dt.  x, b, c, y and the final state are float32 or
// bfloat16; dt, a and an optional initial state are float32.  As in the
// oracle (and not in the Pallas kernel), xbar is rounded to x's type before
// it is widened, so the card's engine emits the CPU engine's tokens; every
// sum is float32 and y and the state are rounded to x's type once, at the
// end.  Rows past S load x = 0, dt = 0 (the oracle's dt=0 padding: exact
// identities on the state) and are never written, so any S works,
// including a single chunk shorter than Q.  Head h reads group h / (H / G)
// of b and c: no repeated copy is made.
//
// What bounds it on the card, at mamba2-2.7b's serve shape (b=1, S=1024,
// H=80, P=64, G=1, N=128, Q=256, bfloat16): 23.1 MB of x, y, the state,
// dt, B and C, 6.9 us at 3.35 TB/s, against 4.1 GFLOP of least work (C B^T
// once per group over each chunk's causal pairs, then per head the
// intra-chunk product, the carried state's term and the state update),
// 4.1 us at the data sheet's dense bf16 rate: bytes bound it.  (Counted
// the TPU kernel's way, full Q x Q planes per head, it is 10.7 GFLOP.)
//
// Design.  The Pallas kernel carries the (P, N) state in VMEM scratch
// across a sequential chunk axis of its grid.  Hopper blocks run in no
// order, and a chunk loop inside one block (this source's first design,
// kept below for float32) leaves 160 blocks each walking four chunks in
// series and recomputing C B^T for every head.  A dtype switch routes the
// calls:
//
//  * bfloat16 with Q <= 256 and P in {16, 32, 64, 128}: the chunk-parallel
//    decomposition in three launches, on the tensor cores (mma.sync
//    m16n8k16, bf16 operands, float32 accumulators):
//    1. ssd_state_tc_kernel, one block of 4 warps per (head, chunk, batch;
//       and slice of N past 128 columns): the chunk's dt a summed by a block
//       scan (two rows a thread, warp shuffles, warp totals added in warp
//       order: a fixed order) into cs, written to scratch (B, nc, Q, H);
//       then the local state x_w^T B (P x Q by Q x N, x_w = xbar
//       exp(cs_last - cs)) over key tiles of 64 rows, into scratch
//       (B, nc, H, P, N) float32.  x_w is staged row by row as two bf16
//       halves (16-byte stores, no bank conflicts) and taken transposed by
//       ldmatrix.trans; the next tile's B rows (cp.async, two buffers) and
//       raw x rows (registers) are requested before this tile's products.
//    2. ssd_pass_kernel, one thread per 4 state entries: S_c = exp(
//       cs_last,c) S_{c-1} + local_c in chunk order from the initial state
//       (or zeros), each chunk's start overwriting its local state in
//       place (but the zero start of the first chunk, which launch 3 skips);
//       the final state rounded to x's type once.
//    3. ssd_out_tc_kernel, one block of 4 warps (16 query rows each) per
//       (group of HG heads, chunk and batch, 64-row query tile): the carried
//       state's term C (S_hi + S_lo)^T times exp(cs_r) first, then for each
//       key tile up to the diagonal the 64 x 64 C B^T tile, formed once on
//       the tensor cores and kept in the warps' accumulators, is masked
//       with each head's decay exp(cs_r - cs_s) (s <= r) in registers, split
//       in two bf16 halves as the A operand and multiplied by that head's
//       xbar tile (ldmatrix.trans).  HG = 128 / P heads share each C B^T tile
//       (2 at P=64, which keeps the HG x 16 x 64 float32 accumulators, the
//       scores and the fragments at 168 registers, no spills), giving
//       4 x 4 x 40 = 640 blocks at the serve shape: about 1.6 waves of the
//       132 SMs at 3 blocks an SM, and the query tiles with the most key
//       tiles are issued first.  Its tiles load in one buffer: a variant
//       with two (the next tile copied during this one's products) needed
//       91 KB and two blocks an SM, and was slower.
//    C, B and xbar are bf16 already, so their products are exact; every
//    float32 operand of a product (x_w, the masked scores, the carried
//    state) enters as hi = bf16(v) and lo = bf16(v - hi), two products into
//    one float32 accumulator, keeping ~16 significant bits where one bf16
//    would keep 8 (ref.py::ssd_chunk_parallel_model is this algebra).  The
//    wrapper allocates the scratch (cs and the chunk states, 10.5 MB at the
//    serve shape).
//  * float32, and bfloat16 outside those shapes: ssd_scan_kernel, the
//    first design, on the CUDA cores in float32 (TF32 would miss the 1e-4
//    bar): one block per (slice of 32 columns of P, head, batch) walks the
//    chunks with the state^T in shared memory; each chunk's rows go in
//    tiles of 64, and for query tile i the key tiles j <= i are walked,
//    their decay-masked 64 x 64 score tile formed in shared memory and
//    applied to xbar_j; the state update walks the key tiles once more.
//    Tiles are staged as float32 with 16-byte loads (so x, b and c must
//    start 16-byte aligned, which the wrapper checks).
//
// No atomics: every sum has a fixed order, so two launches give the same
// bits.  Each launcher returns cudaGetLastError() after its launches, and
// each kernel's shared-memory opt-in is raised, once, under its own record.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <unordered_map>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // rows of a query tile and of a key tile
constexpr int kQMax = 1024;   // longest chunk the float32 route's arrays take

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T's precision (round to nearest even), as float32.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

// Copy rows [0, valid) of a (kTile, W) tile whose rows lie `stride`
// elements apart into shared memory as float32 (row pitch ld), rows
// [valid, kTile) as zeros.  With `scale`, element (r, k) becomes
// round_to<T>(v * scale[r]): the dt-scaled input xbar.
template <typename T, int W>
__device__ __forceinline__ void stage(float* __restrict__ dst, int ld,
                                      const T* __restrict__ src,
                                      size_t stride, int valid,
                                      const float* __restrict__ scale) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kPerRow = W / V;
  for (int u = threadIdx.x; u < kTile * kPerRow; u += kThreads) {
    const int r = u / kPerRow, k = (u % kPerRow) * V;
    float f[V];
    if (r < valid) {
      widen16(*reinterpret_cast<const uint4*>(src + r * stride + k), f);
      if (scale) {
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = round_to<T>(f[i] * scale[r]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * ld + k);
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      d[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  }
}

template <int PS, int N>
struct Layout {
  static constexpr int kLdN = N + 4;           // B and C tile pitch
  static constexpr int kLdS = kTile + 4;       // score tile pitch
  // Output mapping: kPV threads cover the PS columns of a row, 4 each.
  static constexpr int kPV = PS / 4;
  static constexpr int kRowsPerPass = kThreads / kPV;
  static constexpr int kRT = kTile / kRowsPerPass;    // y rows a thread owns
  static constexpr int kNE = (N + kRowsPerPass - 1) / kRowsPerPass;
  static_assert(kTile % kRowsPerPass == 0, "PS must be 16 or 32");
  static_assert(N % 8 == 0, "N must be a multiple of 8");
  // floats of shared memory: C tile, B tile, score tile, xbar tile,
  // state^T, then four per-row arrays of the chunk (cs, dt, exp(cs),
  // exp(cs_last - cs))
  static constexpr size_t fixed_floats() {
    return 2 * kTile * kLdN + kTile * kLdS + kTile * PS + N * PS;
  }
  static constexpr size_t smem_bytes(int q) {
    return (fixed_floats() + 4 * (size_t)q) * sizeof(float);
  }
};

// ------------------------------------------------ float32 route (first design)
template <typename T, int PS, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ c, const float* __restrict__ init,
                    T* __restrict__ y, T* __restrict__ st, int S, int H,
                    int P, int G, int q) {
  using L = Layout<PS, N>;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                         // [kTile][kLdN]  C rows
  float* Bs = Cs + kTile * L::kLdN;         // [kTile][kLdN]  B rows
  float* Ss = Bs + kTile * L::kLdN;         // [kTile][kLdS]  masked scores
  float* Xs = Ss + kTile * L::kLdS;         // [kTile][PS]    xbar rows
  float* St = Xs + kTile * PS;              // [N][PS]        state^T
  float* cs = St + N * PS;                  // [q] cumsum of dt * a
  float* dq = cs + q;                       // [q] dt, then dt in T
  float* ecs = dq + q;                      // [q] exp(cs)
  float* wl = ecs + q;                      // [q] exp(cs_last - cs)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G);
  const float ah = a[h];
  const size_t xrow = (size_t)H * P, brow = (size_t)G * N;
  const T* xb = x + (size_t)bi * S * xrow + (size_t)h * P + p0;
  T* yb = y + (size_t)bi * S * xrow + (size_t)h * P + p0;
  const float* dtb = dt + (size_t)bi * S * H + h;
  const T* bb = b + (size_t)bi * S * brow + (size_t)g * N;
  const T* cb = c + (size_t)bi * S * brow + (size_t)g * N;
  const size_t st_base = ((size_t)bi * H + h) * P + p0;   // row (p0) of st

  // score tile: 4 x 4 entries a thread, rows ty + 16 i, columns tx + 16 j
  const int ty = tid / 16, tx = tid % 16;
  // y tile and state: columns p4 .. p4 + 3, rows (or n) pr + kRowsPerPass k
  const int p4 = (tid % L::kPV) * 4, pr = tid / L::kPV;

  for (int e = tid; e < N * PS; e += kThreads) {
    const int n = e / PS, p = e % PS;
    St[e] = init ? init[(st_base + p) * N + n] : 0.f;
  }

  const int n_chunks = (S + q - 1) / q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = ci * q;
    const int vc = min(q, S - s0);          // rows of this chunk inside S
    const int n_tiles = (vc + kTile - 1) / kTile;
    __syncthreads();                        // last chunk's readers are done
    for (int r = tid; r < vc; r += kThreads) dq[r] = dtb[(size_t)(s0 + r) * H];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int r = 0; r < vc; ++r) {
        acc += __fmul_rn(dq[r], ah);
        cs[r] = acc;
      }
    }
    __syncthreads();
    const float cl = cs[vc - 1];
    for (int r = tid; r < vc; r += kThreads) {
      ecs[r] = expf(cs[r]);
      wl[r] = expf(cl - cs[r]);
      dq[r] = round_to<T>(dq[r]);
    }
    // ---- y: intra-chunk tiles, then the carried state -------------------
    for (int it = 0; it < n_tiles; ++it) {
      const int r0 = it * kTile;
      __syncthreads();                      // readers of Cs are done
      stage<T, N>(Cs, L::kLdN, cb + (size_t)(s0 + r0) * brow, brow,
                  min(kTile, vc - r0), nullptr);
      float acc[L::kRT][4] = {};
      for (int jt = 0; jt <= it; ++jt) {
        const int c0 = jt * kTile;
        __syncthreads();                    // readers of Bs, Xs, Ss are done
        stage<T, N>(Bs, L::kLdN, bb + (size_t)(s0 + c0) * brow, brow,
                    min(kTile, vc - c0), nullptr);
        stage<T, PS>(Xs, PS, xb + (size_t)(s0 + c0) * xrow, xrow,
                     min(kTile, vc - c0), dq + c0);
        __syncthreads();
        float sacc[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            cv[i] = *reinterpret_cast<const float4*>(
                Cs + (ty + 16 * i) * L::kLdN + n);
            bv[i] = *reinterpret_cast<const float4*>(
                Bs + (tx + 16 * i) * L::kLdN + n);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sacc[i][j] += cv[i].x * bv[j].x;
              sacc[i][j] += cv[i].y * bv[j].y;
              sacc[i][j] += cv[i].z * bv[j].z;
              sacc[i][j] += cv[i].w * bv[j].w;
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rr = r0 + ty + 16 * i, sc = c0 + tx + 16 * j;
            Ss[(ty + 16 * i) * L::kLdS + tx + 16 * j] =
                (rr >= sc && rr < vc) ? sacc[i][j] * expf(cs[rr] - cs[sc])
                                      : 0.f;
          }
        __syncthreads();
        for (int s = 0; s < kTile; s += 4) {
          float4 xv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            xv[u] = *reinterpret_cast<const float4*>(Xs + (s + u) * PS + p4);
#pragma unroll
          for (int k = 0; k < L::kRT; ++k) {
            const float4 sv = *reinterpret_cast<const float4*>(
                Ss + (pr + L::kRowsPerPass * k) * L::kLdS + s);
            const float sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[k][0] += sw[u] * xv[u].x;
              acc[k][1] += sw[u] * xv[u].y;
              acc[k][2] += sw[u] * xv[u].z;
              acc[k][3] += sw[u] * xv[u].w;
            }
          }
        }
      }
      // the state carried into this chunk: exp(cs_r) (C_r . state^T)
#pragma unroll
      for (int k = 0; k < L::kRT; ++k) {
        const int r = pr + L::kRowsPerPass * k;
        if (r0 + r >= vc) continue;
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        for (int n = 0; n < N; n += 4) {
          const float4 cv =
              *reinterpret_cast<const float4*>(Cs + r * L::kLdN + n);
          const float cw[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 sv =
                *reinterpret_cast<const float4*>(St + (n + u) * PS + p4);
            t[0] += cw[u] * sv.x;
            t[1] += cw[u] * sv.y;
            t[2] += cw[u] * sv.z;
            t[3] += cw[u] * sv.w;
          }
        }
        const float e = ecs[r0 + r];
        T* yr = yb + (size_t)(s0 + r0 + r) * xrow + p4;
#pragma unroll
        for (int m = 0; m < 4; ++m) store(yr + m, acc[k][m] + e * t[m]);
      }
    }
    // ---- state: exp(cs_last) state + sum_s exp(cs_last - cs_s) xbar_s B_s
    float upd[L::kNE][4] = {};
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int c0 = jt * kTile, valid = min(kTile, vc - c0);
      __syncthreads();                      // readers of Bs, Xs are done
      stage<T, N>(Bs, L::kLdN, bb + (size_t)(s0 + c0) * brow, brow, valid,
                  nullptr);
      stage<T, PS>(Xs, PS, xb + (size_t)(s0 + c0) * xrow, xrow, valid,
                   dq + c0);
      __syncthreads();
      for (int s = 0; s < valid; ++s) {
        const float w = wl[c0 + s];
        const float4 xv = *reinterpret_cast<const float4*>(Xs + s * PS + p4);
#pragma unroll
        for (int k = 0; k < L::kNE; ++k) {
          const int n = pr + L::kRowsPerPass * k;
          if (n < N) {
            const float bw = Bs[s * L::kLdN + n] * w;
            upd[k][0] += bw * xv.x;
            upd[k][1] += bw * xv.y;
            upd[k][2] += bw * xv.z;
            upd[k][3] += bw * xv.w;
          }
        }
      }
    }
    // Each thread rewrites only its own entries of state^T; every other
    // reader of St this chunk finished before the last staging barrier.
    const float dl = expf(cl);
#pragma unroll
    for (int k = 0; k < L::kNE; ++k) {
      const int n = pr + L::kRowsPerPass * k;
      if (n < N) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          St[n * PS + p4 + m] = St[n * PS + p4 + m] * dl + upd[k][m];
      }
    }
  }
  // each thread writes the entries it owns
#pragma unroll
  for (int k = 0; k < L::kNE; ++k) {
    const int n = pr + L::kRowsPerPass * k;
    if (n < N) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        store(st + (st_base + p4 + m) * N + n, St[n * PS + p4 + m]);
    }
  }
}

// ------------------------------------------------ bfloat16 tensor-core route
// ------------------------------------------------------------------ PTX
// Every asynchronous copy, ldmatrix and mma of the tensor-core kernels goes
// through these functions (as in flash_attn.cu).
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

// Wait until every committed group of this thread has landed (or all but
// the newest one).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

using bf16 = __nv_bfloat16;

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

constexpr int kTcThreads = 128;   // 4 warps
constexpr int kTcQMax = 256;      // longest chunk of the tensor-core route

// Rows [0, valid) of a (kTile, W) bf16 tile whose rows lie `stride`
// elements apart, into shared memory of row pitch ld by 16-byte cp.async;
// rows [valid, kTile) become zeros.  Every thread of the block takes part.
__device__ __forceinline__ void load_rows_async(bf16* __restrict__ dst, int ld,
                                                const bf16* __restrict__ src,
                                                size_t stride, int W,
                                                int valid) {
  const int per_row = W / 8;
  for (int u = threadIdx.x; u < kTile * per_row; u += kTcThreads) {
    const int r = u / per_row, k = (u % per_row) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + k, src + (ok ? (size_t)r * stride + k : 0),
               ok ? 16 : 0);
  }
}

// Inclusive prefix sums of v[0..n), n <= 2 * kTcThreads, in place: each
// thread sums its two rows, warps scan their threads' totals by shuffles,
// and each warp adds the totals of the warps before it in warp order.  A
// fixed order: two launches give the same bits.
__device__ __forceinline__ void block_cumsum(float* v, int n, float* wtot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float v0 = 2 * tid < n ? v[2 * tid] : 0.f;
  const float v1 = 2 * tid + 1 < n ? v[2 * tid + 1] : 0.f;
  float incl = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += wtot[w];
  base += excl;
  if (2 * tid < n) v[2 * tid] = base + v0;
  if (2 * tid + 1 < n) v[2 * tid + 1] = (base + v0) + v1;
  __syncthreads();
}

// Launch 1: cs and each chunk's local state, one block per (head, chunk,
// batch x slice of N): a slice is all of N up to 128 columns (64 at
// P=128, where a warp holds two m-tiles).
template <int P>
struct StateTC {
  static constexpr int kMT = (P / 16 + 3) / 4;     // m-tiles (16 p) a warp
  static constexpr int kNW = kMT == 1 ? 128 : 64;  // widest slice of N
  static constexpr int kLdX = P + 8;               // x_w tile pitch
  static constexpr int kLdB = kNW + 8;             // B tile pitch
  static constexpr int kXU = kTile * P / 8 / kTcThreads;  // x loads a thread
  static constexpr size_t smem_bytes() {
    return sizeof(bf16) * (2 * (size_t)kTile * kLdX + 2 * (size_t)kTile * kLdB) +
           sizeof(float) * (3 * kTcQMax + 4);
  }
};

template <int P>
__global__ void __launch_bounds__(kTcThreads)
    ssd_state_tc_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const bf16* __restrict__ b, float* __restrict__ cs_out,
                        float* __restrict__ st_out, int S, int H, int G, int N,
                        int q, int nc) {
  using L = StateTC<P>;
  static_assert(L::kXU * kTcThreads * 8 == kTile * P, "x tile per thread");
  extern __shared__ __align__(16) float smem[];
  bf16* xh = reinterpret_cast<bf16*>(smem);        // [kTile][kLdX] x_w, hi
  bf16* xl = xh + kTile * L::kLdX;                 // [kTile][kLdX] x_w, lo
  bf16* bs = xl + kTile * L::kLdX;                 // [2][kTile][kLdB] B slice
  float* cs = reinterpret_cast<float*>(bs + 2 * kTile * L::kLdB);  // [kTcQMax]
  float* wl = cs + kTcQMax;                        // exp(cs_last - cs)
  float* dq = wl + kTcQMax;                        // dt in bf16
  float* wtot = dq + kTcQMax;                      // [4] warp totals

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = min(N, L::kNW), n_slices = N / nw;
  const int h = blockIdx.x, ci = blockIdx.y;
  const int bi = blockIdx.z / n_slices, n0 = (blockIdx.z % n_slices) * nw;
  const int g = h / (H / G);
  const int s0 = ci * q, vc = min(q, S - s0);
  const size_t xrow = (size_t)H * P, brow = (size_t)G * N;
  const float ah = a[h];
  const bf16* xb = x + ((size_t)bi * S + s0) * xrow + (size_t)h * P;
  const bf16* bb = b + ((size_t)bi * S + s0) * brow + (size_t)g * N + n0;
  const int n_tiles = (vc + kTile - 1) / kTile;

  // Tile t's raw x rows (this thread's 16-byte pieces) and B rows (by
  // cp.async into buffer t % 2) are requested a tile ahead.
  uint4 xr[L::kXU];
  auto fetch = [&](int t) {
    const int k0 = t * kTile, kv = min(kTile, vc - k0);
    load_rows_async(bs + (t & 1) * kTile * L::kLdB, L::kLdB,
                    bb + (size_t)k0 * brow, brow, nw, kv);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < L::kXU; ++i) {
      const int u = tid + i * kTcThreads;
      const int s = u / (P / 8), p = (u % (P / 8)) * 8;
      xr[i] = s < kv ? *reinterpret_cast<const uint4*>(
                           xb + (size_t)(k0 + s) * xrow + p)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  fetch(0);

  for (int r = tid; r < q; r += kTcThreads) {
    const float d = r < vc ? dt[((size_t)bi * S + s0 + r) * H + h] : 0.f;
    cs[r] = __fmul_rn(d, ah);
    dq[r] = __bfloat162float(__float2bfloat16(d));
  }
  __syncthreads();
  block_cumsum(cs, q, wtot);
  const float cl = cs[q - 1];
  for (int r = tid; r < q; r += kTcThreads) {
    wl[r] = expf(cl - cs[r]);
    if (n0 == 0) cs_out[(((size_t)bi * nc + ci) * q + r) * H + h] = cs[r];
  }

  float acc[L::kMT][L::kNW / 8][4];
#pragma unroll
  for (int i = 0; i < L::kMT; ++i)
#pragma unroll
    for (int f = 0; f < L::kNW / 8; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;

  // ldmatrix.trans row addresses: B (rows s, columns n) as the B operand,
  // x_w (rows s, columns p) as the A operand x_w^T
  const int v_frag =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * L::kLdB + (lane >> 4) * 8;
  const int a_frag =
      ((lane & 7) + (lane >> 4) * 8) * L::kLdX + ((lane >> 3) & 1) * 8;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();              // wl is set; tile t-1's readers are done
    // x_w = round(x * dt) * exp(cs_last - cs) as hi/lo halves
#pragma unroll
    for (int i = 0; i < L::kXU; ++i) {
      const int u = tid + i * kTcThreads;
      const int s = u / (P / 8), p = (u % (P / 8)) * 8;
      float f[8];
      widen16(xr[i], f);
      const bool in = k0 + s < vc;
      const float w = in ? wl[k0 + s] : 0.f, d = in ? dq[k0 + s] : 0.f;
      unsigned hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_bf16x2(round_to<bf16>(f[2 * j] * d) * w,
                     round_to<bf16>(f[2 * j + 1] * d) * w, hi[j], lo[j]);
      *reinterpret_cast<uint4*>(xh + s * L::kLdX + p) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(xl + s * L::kLdX + p) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if (t + 1 < n_tiles) {
      fetch(t + 1);
      cp_async_wait_one();        // tile t's B has landed
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const bf16* bt = bs + (t & 1) * kTile * L::kLdB;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < L::kMT; ++i) {
        const int mt = warp + 4 * i;
        if (mt >= P / 16) continue;
        unsigned ahi[4], alo[4];
        const int off = a_frag + kk * 16 * L::kLdX + mt * 16;
        ldmatrix_x4_trans(ahi, xh + off);
        ldmatrix_x4_trans(alo, xl + off);
#pragma unroll
        for (int nb = 0; nb < L::kNW / 16; ++nb) {
          if (nb * 16 >= nw) break;
          unsigned bv[4];
          ldmatrix_x4_trans(bv, bt + v_frag + kk * 16 * L::kLdB + nb * 16);
          mma_16816(acc[i][2 * nb], ahi, bv[0], bv[1]);
          mma_16816(acc[i][2 * nb + 1], ahi, bv[2], bv[3]);
          mma_16816(acc[i][2 * nb], alo, bv[0], bv[1]);
          mma_16816(acc[i][2 * nb + 1], alo, bv[2], bv[3]);
        }
      }
    }
  }
  // local state rows p = mt*16 + lane/4 (+8), columns n0 + 8f + 2(lane%4)
  float* out = st_out + ((((size_t)bi * nc + ci) * H + h) * P) * N + n0;
  const int gr = lane >> 2, tc = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < L::kMT; ++i) {
    const int mt = warp + 4 * i;
    if (mt >= P / 16) continue;
#pragma unroll
    for (int f = 0; f < L::kNW / 8; ++f) {
      if (f * 8 >= nw) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* o = out + (size_t)(mt * 16 + gr + 8 * hf) * N + f * 8 + tc;
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[i][f][2 * hf], acc[i][f][2 * hf + 1]);
      }
    }
  }
}

// Launch 2: the state passed over the chunks, 4 entries a thread.
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_pass_kernel(const float* __restrict__ cs,
                    const float* __restrict__ init, float* __restrict__ st,
                    T* __restrict__ st_final, int B, int H, int PN, int q,
                    int nc) {
  const size_t i4 = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i4 >= (size_t)B * H * PN) return;
  const size_t bh = i4 / PN;
  const int bi = (int)(bh / H), h = (int)(bh % H);
  const size_t within = i4 % PN;
  float4 s = init ? *reinterpret_cast<const float4*>(init + i4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int ci = 0; ci < nc; ++ci) {
    const float d = expf(cs[(((size_t)bi * nc + ci) * q + q - 1) * H + h]);
    float4* p = reinterpret_cast<float4*>(
        st + (((size_t)bi * nc + ci) * H + h) * PN + within);
    const float4 l = *p;
    if (init || ci > 0) *p = s;   // launch 3 reads no zero start
    s.x = __fadd_rn(__fmul_rn(s.x, d), l.x);
    s.y = __fadd_rn(__fmul_rn(s.y, d), l.y);
    s.z = __fadd_rn(__fmul_rn(s.z, d), l.z);
    s.w = __fadd_rn(__fmul_rn(s.w, d), l.w);
  }
  store(st_final + i4, s.x);
  store(st_final + i4 + 1, s.y);
  store(st_final + i4 + 2, s.z);
  store(st_final + i4 + 3, s.w);
}

// Launch 3: y, one block per (head group, chunk x batch, query tile).
template <int P>
struct OutTC {
  static constexpr int kHG = 128 / P;      // most heads sharing a C B^T tile
  static constexpr int kLdX = P + 8;       // xbar tile pitch
  static size_t smem_bytes(int N, int hg) {
    const size_t ldn = (size_t)N + 8;
    const size_t tiles = kTile * ldn + (size_t)hg * kTile * kLdX;
    const size_t halves = 2 * (size_t)P * ldn;
    return sizeof(bf16) * (kTile * ldn + (tiles > halves ? tiles : halves)) +
           sizeof(float) * (size_t)hg * kTcQMax;
  }
};

template <int P>
__global__ void __launch_bounds__(kTcThreads)
    ssd_out_tc_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ dt,
                      const bf16* __restrict__ b, const bf16* __restrict__ c,
                      const float* __restrict__ cs,
                      const float* __restrict__ st, bf16* __restrict__ y,
                      int S, int H, int G, int N, int q, int nc, int hg,
                      int has_init) {
  using L = OutTC<P>;
  constexpr int kHG = L::kHG, kLdX = L::kLdX;
  extern __shared__ __align__(16) float smem[];
  const int ldn = N + 8;
  bf16* cq = reinterpret_cast<bf16*>(smem);        // [kTile][ldn] C rows
  bf16* un = cq + kTile * ldn;                     // union:
  bf16* bk = un;                                   //   [kTile][ldn] B rows
  bf16* xs = bk + kTile * ldn;                     //   [hg][kTile][kLdX] xbar
  bf16* sh = un;                                   //   [P][ldn] state, hi
  bf16* sl = un + P * ldn;                         //   [P][ldn] state, lo
  const size_t tiles = (size_t)kTile * ldn + (size_t)hg * kTile * kLdX;
  float* css = reinterpret_cast<float*>(
      un + (tiles > 2 * (size_t)P * ldn ? tiles : 2 * (size_t)P * ldn));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h0 = blockIdx.x * hg, g = h0 / (H / G);
  const int bi = blockIdx.y / nc, ci = blockIdx.y % nc;
  const int it = gridDim.z - 1 - blockIdx.z;       // heaviest tiles first
  const int r0 = it * kTile, s0 = ci * q, vc = min(q, S - s0);
  if (r0 >= vc) return;
  const size_t xrow = (size_t)H * P, brow = (size_t)G * N;

  load_rows_async(cq, ldn, c + ((size_t)bi * S + s0 + r0) * brow +
                               (size_t)g * N,
                  brow, N, vc - r0);
  cp_async_commit();
  for (int u = tid; u < hg * kTcQMax; u += kTcThreads) {
    const int hh = u / kTcQMax, r = u % kTcQMax;
    css[u] = r < q ? cs[(((size_t)bi * nc + ci) * q + r) * H + h0 + hh] : 0.f;
  }

  // this lane's fragment rows (see mma_16816) and ldmatrix addresses
  const int gr = lane >> 2, tc = 2 * (lane & 3);
  const int rw = r0 + warp * 16 + gr;              // rows rw and rw + 8
  const int a_frag = (warp * 16 + (lane & 15)) * ldn + (lane >> 4) * 8;
  const int k_frag = ((lane & 7) + (lane >> 4) * 8) * ldn +
                     ((lane >> 3) & 1) * 8;
  const int v_frag =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdX + (lane >> 4) * 8;

  float acc[kHG][P / 8][4];
#pragma unroll
  for (int hh = 0; hh < kHG; ++hh)
#pragma unroll
    for (int f = 0; f < P / 8; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][f][e] = 0.f;

  // ---- the carried state: exp(cs_r) C_r . (S_hi + S_lo)^T
  if (has_init || ci > 0) {
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      if (hh >= hg) break;
      __syncthreads();                  // the previous head's readers are done
      const float* sp =
          st + ((((size_t)bi * nc + ci) * H + h0 + hh) * P) * N;
      for (int u = tid; u < P * N / 2; u += kTcThreads) {
        const int p = u / (N / 2), n = (u % (N / 2)) * 2;
        const float2 v = *reinterpret_cast<const float2*>(sp + (size_t)p * N + n);
        unsigned hi, lo;
        split_bf16x2(v.x, v.y, hi, lo);
        *reinterpret_cast<unsigned*>(sh + p * ldn + n) = hi;
        *reinterpret_cast<unsigned*>(sl + p * ldn + n) = lo;
      }
      cp_async_wait_all();
      __syncthreads();
      for (int kk = 0; kk < N / 16; ++kk) {
        unsigned af[4];
        ldmatrix_x4(af, cq + a_frag + kk * 16);
#pragma unroll
        for (int dn = 0; dn < P / 16; ++dn) {
          unsigned bh4[4], bl4[4];
          ldmatrix_x4(bh4, sh + k_frag + dn * 16 * ldn + kk * 16);
          ldmatrix_x4(bl4, sl + k_frag + dn * 16 * ldn + kk * 16);
          mma_16816(acc[hh][2 * dn], af, bh4[0], bh4[1]);
          mma_16816(acc[hh][2 * dn], af, bl4[0], bl4[1]);
          mma_16816(acc[hh][2 * dn + 1], af, bh4[2], bh4[3]);
          mma_16816(acc[hh][2 * dn + 1], af, bl4[2], bl4[3]);
        }
      }
      const float* ch = css + hh * kTcQMax;
      const float e0 = expf(ch[rw]), e1 = expf(ch[rw + 8]);
#pragma unroll
      for (int f = 0; f < P / 8; ++f) {
        acc[hh][f][0] *= e0;
        acc[hh][f][1] *= e0;
        acc[hh][f][2] *= e1;
        acc[hh][f][3] *= e1;
      }
    }
  }

  // ---- the intra-chunk terms, one 64-key tile at a time
  const bf16* bb = b + ((size_t)bi * S + s0) * brow + (size_t)g * N;
  const bf16* xb = x + ((size_t)bi * S + s0) * xrow + (size_t)h0 * P;
  const float* dtb = dt + ((size_t)bi * S + s0) * H + h0;
  for (int jt = 0; jt <= it; ++jt) {
    const int k0 = jt * kTile, kv = min(kTile, vc - k0);
    __syncthreads();                    // the union's readers are done
    load_rows_async(bk, ldn, bb + (size_t)k0 * brow, brow, N, kv);
    cp_async_commit();
    for (int u = tid; u < kTile * hg * (P / 8); u += kTcThreads) {
      const int s = u / (hg * (P / 8)), k = (u % (hg * (P / 8))) * 8;
      const int hh = k / P, p = k % P;
      float f[8];
      if (s < kv) {
        widen16(*reinterpret_cast<const uint4*>(xb + (size_t)(k0 + s) * xrow +
                                                k),
                f);
        const float d =
            round_to<bf16>(dtb[(size_t)(k0 + s) * H + hh]);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = f[i] * d;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = 0.f;
      }
      uint4 v;
      v.x = bf16x2_bits(__floats2bfloat162_rn(f[0], f[1]));
      v.y = bf16x2_bits(__floats2bfloat162_rn(f[2], f[3]));
      v.z = bf16x2_bits(__floats2bfloat162_rn(f[4], f[5]));
      v.w = bf16x2_bits(__floats2bfloat162_rn(f[6], f[7]));
      *reinterpret_cast<uint4*>(xs + (hh * kTile + s) * kLdX + p) = v;
    }
    cp_async_wait_all();
    __syncthreads();

    // the 16 x 64 C B^T tile of this warp, once for all heads of the group
    float sc[kTile / 8][4];
#pragma unroll
    for (int f = 0; f < kTile / 8; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[f][e] = 0.f;
    for (int kk = 0; kk < N / 16; ++kk) {
      unsigned af[4];
      ldmatrix_x4(af, cq + a_frag + kk * 16);
#pragma unroll
      for (int n4 = 0; n4 < kTile / 16; ++n4) {
        unsigned bf[4];
        ldmatrix_x4(bf, bk + k_frag + n4 * 16 * ldn + kk * 16);
        mma_16816(sc[2 * n4], af, bf[0], bf[1]);
        mma_16816(sc[2 * n4 + 1], af, bf[2], bf[3]);
      }
    }
    // Element e of fragment f is row rw + 8 (e / 2), key k0 + 8 f + tc +
    // e % 2; a key past the row (or a row past the chunk) contributes 0.
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      if (hh >= hg) break;
      const float* ch = css + hh * kTcQMax;
      const float c0 = ch[rw], c1 = ch[rw + 8];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        float m[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 16 * kk + 8 * j + tc + (e & 1);
            const int row = rw + 8 * (e >> 1);
            m[j][e] = key <= row && row < vc
                          ? sc[2 * kk + j][e] *
                                expf((e >> 1 ? c1 : c0) - ch[key])
                          : 0.f;
          }
        unsigned ph[4], pl[4];
        split_bf16x2(m[0][0], m[0][1], ph[0], pl[0]);
        split_bf16x2(m[0][2], m[0][3], ph[1], pl[1]);
        split_bf16x2(m[1][0], m[1][1], ph[2], pl[2]);
        split_bf16x2(m[1][2], m[1][3], ph[3], pl[3]);
        const bf16* xh = xs + hh * kTile * kLdX + kk * 16 * kLdX;
#pragma unroll
        for (int dn = 0; dn < P / 16; ++dn) {
          unsigned bv[4];
          ldmatrix_x4_trans(bv, xh + v_frag + dn * 16);
          mma_16816(acc[hh][2 * dn], ph, bv[0], bv[1]);
          mma_16816(acc[hh][2 * dn], pl, bv[0], bv[1]);
          mma_16816(acc[hh][2 * dn + 1], ph, bv[2], bv[3]);
          mma_16816(acc[hh][2 * dn + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }

  // ---- y in x's type, rows inside the chunk only
#pragma unroll
  for (int hh = 0; hh < kHG; ++hh) {
    if (hh >= hg) break;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = rw + 8 * hf;
      if (row >= vc) continue;
      bf16* yr = y + ((size_t)bi * S + s0 + row) * xrow + (size_t)(h0 + hh) * P +
                 tc;
#pragma unroll
      for (int f = 0; f < P / 8; ++f)
        *reinterpret_cast<__nv_bfloat162*>(yr + 8 * f) = __floats2bfloat162_rn(
            acc[hh][f][2 * hf], acc[hh][f][2 * hf + 1]);
    }
  }
}

// ------------------------------------------------------------ launchers
// A kernel's dynamic shared-memory opt-in, raised when a launch needs more
// than that kernel was allowed before: one record per kernel.
int allow_smem(const void* kern, size_t bytes) {
  static std::mutex mu;
  static std::unordered_map<const void*, size_t> allowed;
  std::lock_guard<std::mutex> lock(mu);
  size_t& now = allowed.try_emplace(kern, (size_t)48 * 1024).first->second;
  if (bytes <= now) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  now = bytes;
  return 0;
}

template <typename T, int PS, int N>
int launch_t(const void* x, const float* dt, const float* a, const void* b,
             const void* c, const float* init, void* y, void* st, int B,
             int S, int H, int P, int G, int q, void* stream) {
  auto kern = ssd_scan_kernel<T, PS, N>;
  const size_t smem = Layout<PS, N>::smem_bytes(q);
  const int e = allow_smem((const void*)kern, smem);
  if (e) return e;
  const dim3 grid(P / PS, H, B);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, dt, a, (const T*)b, (const T*)c, init, (T*)y, (T*)st, S, H,
      P, G, q);
  return (int)cudaGetLastError();
}

template <typename T, int PS>
int launch_n(int N, const void* x, const float* dt, const float* a,
             const void* b, const void* c, const float* init, void* y,
             void* st, int B, int S, int H, int P, int G, int q,
             void* stream) {
  switch (N) {
    case 16: return launch_t<T, PS, 16>(x, dt, a, b, c, init, y, st, B, S, H, P, G, q, stream);
    case 32: return launch_t<T, PS, 32>(x, dt, a, b, c, init, y, st, B, S, H, P, G, q, stream);
    case 64: return launch_t<T, PS, 64>(x, dt, a, b, c, init, y, st, B, S, H, P, G, q, stream);
    case 128: return launch_t<T, PS, 128>(x, dt, a, b, c, init, y, st, B, S, H, P, G, q, stream);
    case 256: return launch_t<T, PS, 256>(x, dt, a, b, c, init, y, st, B, S, H, P, G, q, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_p(const void* x, const float* dt, const float* a, const void* b,
             const void* c, const float* init, void* y, void* st, int B,
             int S, int H, int P, int G, int N, int q, void* stream) {
  if (P % 32 == 0)
    return launch_n<T, 32>(N, x, dt, a, b, c, init, y, st, B, S, H, P, G, q,
                           stream);
  return launch_n<T, 16>(N, x, dt, a, b, c, init, y, st, B, S, H, P, G, q,
                         stream);
}

int slice_of(int P) { return P % 32 == 0 ? 32 : 16; }

template <int PS>
int smem_n(int N, int q) {
  switch (N) {
    case 16: return (int)Layout<PS, 16>::smem_bytes(q);
    case 32: return (int)Layout<PS, 32>::smem_bytes(q);
    case 64: return (int)Layout<PS, 64>::smem_bytes(q);
    case 128: return (int)Layout<PS, 128>::smem_bytes(q);
    case 256: return (int)Layout<PS, 256>::smem_bytes(q);
    default: return 0;
  }
}

bool tensor_core_route(int dtype, int P, int q) {
  return dtype == 1 && q <= kTcQMax &&
         (P == 16 || P == 32 || P == 64 || P == 128);
}

// Heads sharing one C B^T tile: the most, up to 128 / P, that divide the
// H / G heads of a group.
int head_group(int P, int H, int G) {
  int hg = 1;
  for (int d = 1; d <= 128 / P; ++d)
    if ((H / G) % d == 0) hg = d;
  return hg;
}

template <int P>
int launch_tc(const bf16* x, const float* dt, const float* a, const bf16* b,
              const bf16* c, const float* init, bf16* y, bf16* st,
              float* cs_scratch, float* st_scratch, int B, int S, int H,
              int G, int N, int q, cudaStream_t stream) {
  const int nc = (S + q - 1) / q, nqt = (q + kTile - 1) / kTile;
  const int n_slices = N / (N < StateTC<P>::kNW ? N : StateTC<P>::kNW);
  const int hg = head_group(P, H, G);
  auto k1 = ssd_state_tc_kernel<P>;
  auto k3 = ssd_out_tc_kernel<P>;
  const size_t smem1 = StateTC<P>::smem_bytes();
  const size_t smem3 = OutTC<P>::smem_bytes(N, hg);
  int e = allow_smem((const void*)k1, smem1);
  if (!e) e = allow_smem((const void*)k3, smem3);
  if (e) return e;
  k1<<<dim3(H, nc, B * n_slices), kTcThreads, smem1, stream>>>(
      x, dt, a, b, cs_scratch, st_scratch, S, H, G, N, q, nc);
  if ((e = (int)cudaGetLastError())) return e;
  const size_t quads = (size_t)B * H * P * N / 4;
  ssd_pass_kernel<bf16><<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
      cs_scratch, init, st_scratch, st, B, H, P * N, q, nc);
  if ((e = (int)cudaGetLastError())) return e;
  k3<<<dim3(H / hg, nc * B, nqt), kTcThreads, smem3, stream>>>(
      x, dt, b, c, cs_scratch, st_scratch, y, S, H, G, N, q, nc, hg,
      init != nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Whether a call takes the chunk-parallel tensor-core route (and then needs
// the scratch of ssd_scan_launch): dtype 0 = float32, 1 = bfloat16.
int ssd_scan_route(int dtype, int P, int q) {
  return tensor_core_route(dtype, P, q) ? 1 : 0;
}

// B6.  x (B, S, H, P), b/c (B, S, G, N), y like x, st (B, H, P, N), all of
// one type (dtype 0 = float32, 1 = bfloat16); dt (B, S, H), a (H,) and init
// (B, H, P, N, or null for zeros) float32; all on the device, contiguous,
// x/b/c/y 16-byte aligned.  q = min(chunk, S) is the chunk length, at most
// 1024; P a multiple of 16; N one of 16, 32, 64, 128, 256; G divides H.  On
// the tensor-core route (ssd_scan_route) cs_scratch holds B * nc * q and
// st_scratch B * nc * H * P * N float32 (nc = ceil(S / q)); else both may
// be null.
int ssd_scan_launch(const void* x, const float* dt, const float* a,
                    const void* b, const void* c, const float* init, void* y,
                    void* st, float* cs_scratch, float* st_scratch, int dtype,
                    int B, int S, int H, int P, int G, int N, int q,
                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P % 16 != 0 || q <= 0 || q > kQMax)
    return (int)cudaErrorInvalidValue;
  if (tensor_core_route(dtype, P, q)) {
    if (!cs_scratch || !st_scratch ||
        !(N == 16 || N == 32 || N == 64 || N == 128 || N == 256))
      return (int)cudaErrorInvalidValue;
    const auto s = (cudaStream_t)stream;
    const bf16 *xb = (const bf16*)x, *bb = (const bf16*)b,
               *cb = (const bf16*)c;
    bf16 *yb = (bf16*)y, *sb = (bf16*)st;
    switch (P) {
      case 16: return launch_tc<16>(xb, dt, a, bb, cb, init, yb, sb, cs_scratch, st_scratch, B, S, H, G, N, q, s);
      case 32: return launch_tc<32>(xb, dt, a, bb, cb, init, yb, sb, cs_scratch, st_scratch, B, S, H, G, N, q, s);
      case 64: return launch_tc<64>(xb, dt, a, bb, cb, init, yb, sb, cs_scratch, st_scratch, B, S, H, G, N, q, s);
      default: return launch_tc<128>(xb, dt, a, bb, cb, init, yb, sb, cs_scratch, st_scratch, B, S, H, G, N, q, s);
    }
  }
  if (dtype == 0)
    return launch_p<float>(x, dt, a, b, c, init, y, st, B, S, H, P, G, N, q,
                           stream);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, a, b, c, init, y, st, B, S, H, P, G,
                                   N, q, stream);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory in bytes of one block of each kernel of a call's
// route: which = 0 the first kernel (ssd_state_tc_kernel on the tensor-core
// route, else ssd_scan_kernel), 2 ssd_out_tc_kernel (0 off that route; the
// pass kernel takes none); 0 for a shape the kernels do not take.
int ssd_scan_smem_bytes(int dtype, int P, int N, int q, int H, int G,
                        int which) {
  if (P <= 0 || P % 16 != 0 || q <= 0 || q > kQMax || G <= 0 || H % G)
    return 0;
  if (!tensor_core_route(dtype, P, q))
    return which != 0 ? 0
           : slice_of(P) == 32 ? smem_n<32>(N, q) : smem_n<16>(N, q);
  const int hg = head_group(P, H, G);
  switch (which) {
    case 0:
      return (int)(P == 16 ? StateTC<16>::smem_bytes()
                   : P == 32 ? StateTC<32>::smem_bytes()
                   : P == 64 ? StateTC<64>::smem_bytes()
                             : StateTC<128>::smem_bytes());
    case 2:
      return (int)(P == 16 ? OutTC<16>::smem_bytes(N, hg)
                   : P == 32 ? OutTC<32>::smem_bytes(N, hg)
                   : P == 64 ? OutTC<64>::smem_bytes(N, hg)
                             : OutTC<128>::smem_bytes(N, hg));
    default:
      return 0;
  }
}

}  // extern "C"
