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
// product and sum is float32 and y and the state are rounded to x's type
// once, at the end.  Rows past S load x = 0, dt = 0 (the oracle's dt=0
// padding: exact identities on the state) and are never written, so any S
// works, including a single chunk shorter than Q.  Head h reads group
// h / (H / G) of b and c: no repeated copy is made.
//
// What bounds it on the card, at mamba2-2.7b's serve shape (b=1, S=1024,
// H=80, P=64, G=1, N=128, Q=256, bfloat16): 23.1 MB of x, y, the state,
// dt, B and C, 6.9 us at 3.35 TB/s, against 4.1 GFLOP of least work (C B^T
// once per group over each chunk's causal pairs, then per head the
// intra-chunk product, the carried state's term and the state update),
// 4.1 us at the data sheet's dense bf16 rate: bytes bound it.  (Counted
// the TPU kernel's way, full Q x Q planes per head, it is 10.7 GFLOP.)
// This first kernel runs its products on the CUDA cores in float32
// (67 TFLOP/s at best) and recomputes C B^T for every head and every half
// of P, so it sits far above that bound; C B^T is one plane per (batch,
// group, chunk) shared by all H / G heads, and computing it once on the
// tensor cores is the next step.
//
// Design.  The Pallas kernel carries the (P, N) state in VMEM scratch
// across a sequential chunk axis of its grid; Hopper blocks run in no
// order, so here the chunk axis is a loop inside one block.  One block per
// (slice of PS columns of P, head, batch): the P columns of x, y and the
// state never mix, so P splits into slices of 32 (16 when P = 16) with no
// merge pass (160 blocks at the serve shape, 80 without the split).  The
// state lives in shared memory as float32 state^T (N x PS) across chunks.
// A (Q, Q) plane never exists (256^2 float32 would be 256 KB, more than a
// block's 227 KB): each chunk's rows go in tiles of 64, and for query tile
// i the key tiles j <= i are walked, their decay-masked 64 x 64 score tile
// is formed in shared memory and applied to xbar_j.  The state update walks
// the key tiles once more at the chunk's end.  Tiles are staged as float32
// with 16-byte loads (so x, b and c must start 16-byte aligned, which the
// wrapper checks); B and C rows are padded by 4 words so the 16-byte reads
// of neighbouring rows hit distinct banks.  The cumulative sum runs in one
// thread in row order; every other sum has a fixed order too, with no
// atomics, so two runs give the same bits.  The launcher returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // rows of a query tile and of a key tile
constexpr int kQMax = 1024;   // longest chunk the per-row arrays take

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

// ------------------------------------------------------------ launchers
template <typename T, int PS, int N>
int launch_t(const void* x, const float* dt, const float* a, const void* b,
             const void* c, const float* init, void* y, void* st, int B,
             int S, int H, int P, int G, int q, void* stream) {
  auto kern = ssd_scan_kernel<T, PS, N>;
  // The shared memory grows with the chunk length: raise the opt-in when a
  // longer chunk than before arrives.
  static size_t allowed = 48 * 1024;
  const size_t smem = Layout<PS, N>::smem_bytes(q);
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
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

}  // namespace

extern "C" {

// B6.  x (B, S, H, P), b/c (B, S, G, N), y like x, st (B, H, P, N), all of
// one type (dtype 0 = float32, 1 = bfloat16); dt (B, S, H), a (H,) and init
// (B, H, P, N, or null for zeros) float32; all on the device, contiguous,
// x/b/c/y 16-byte aligned.  q = min(chunk, S) is the chunk length, at most
// 1024; P a multiple of 16; N one of 16, 32, 64, 128, 256; G divides H.
int ssd_scan_launch(const void* x, const float* dt, const float* a,
                    const void* b, const void* c, const float* init, void* y,
                    void* st, int dtype, int B, int S, int H, int P, int G,
                    int N, int q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P % 16 != 0 || q <= 0 || q > kQMax)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_p<float>(x, dt, a, b, c, init, y, st, B, S, H, P, G, N, q,
                           stream);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, a, b, c, init, y, st, B, S, H, P, G,
                                   N, q, stream);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block in bytes for head dim P, state width N
// and chunk length q; 0 for a shape the kernel does not take.
int ssd_scan_smem_bytes(int P, int N, int q) {
  if (P <= 0 || P % 16 != 0 || q <= 0 || q > kQMax) return 0;
  return slice_of(P) == 32 ? smem_n<32>(N, q) : smem_n<16>(N, q);
}

}  // extern "C"
