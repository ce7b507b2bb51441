// Mamba2 SSD within a chunk, for Hopper: f32 arithmetic on the FMA pipes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (_ssd_chunk_kernel /
// ssd_chunk_kernel).  For each cell (one batch-chunk bc and one head h),
// with a_cum = cumsum(a) over the Q steps of the chunk:
//
//   y[q, p]     = sum_{k<=q} (C_q . B_k) exp(a_cum[q] - a_cum[k]) dt_k x[k, p]
//   state[p, n] = sum_k exp(a_cum[Q-1] - a_cum[k]) dt_k x[k, p] B[k, n]
//
// Bound by operations: at the main path's shape (Q 256, P 64, N 128) a cell
// needs about 8 MFLOP against 0.2 MB of operands.  The TPU kernel holds the
// whole decay matrix L [Q, Q] in VMEM (256 KB at Q 256); an H100 block has at
// most 227 KB of shared memory, so this kernel never forms L.
//
// Design:
// - Layout.  x, dt, a are read in the model's layout [BC, Q, H, ...] and B, C
//   as [BC, Q, N], shared by the H heads of a cell, so the wrapper copies and
//   broadcasts nothing.  The JAX kernel's [G, Q, ...] layout is the case H = 1.
// - Blocks.  One block per (cell, task).  A y task owns a 64-row q-tile and a
//   64-column p-tile; it walks the k-tiles up to the diagonal, forms the
//   masked scores S = (C Bt) * exp(a_cum[q] - a_cum[k]) * dt_k for one
//   64 x 64 tile in registers (C and B transposed in shared memory, 16-byte
//   reads), stores S transposed in shared memory and accumulates y += S x in
//   registers.  A state task owns a 64 x 128 tile of state and walks all k.
//   Tasks run heaviest first (last q-tile first, state last).
// - a_cum is summed in f64 by one warp and rounded once to f32, as
//   ref.chunk_cumsum does: near a_cum = -180 one f32 ulp is 1.5e-5, and two
//   f32 scans in different orders would disagree by more than the tolerance.
// - Any Q from 1 to kMaxQ; P and N of any size (tiles are masked at the
//   edges, N is walked in chunks of 128).  No TF32 and no tensor cores: the
//   f32 check against the plain version is 2e-5.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 (or 4 x 8) tile
constexpr int TQ = 64;         // rows of a q-tile and of a k-tile
constexpr int TP = 64;         // head-dim columns of a tile
constexpr int TN = 128;        // state columns of a tile / chunk of the N loop
constexpr int LD = TQ + 4;     // row pitch of transposed tiles (16-byte rows)
constexpr int kMaxQ = 1024;    // keeps two blocks on an SM

struct Cell {
  const float* x;   // row q at x + q * xs
  const float* dt;  // step q at dt[q * H]
  const float* a;
  const float* B;   // row q at B + q * N
  const float* C;
  size_t xs;
  int Q, H, P, N;
};

// a_cum (inclusive, f64 sum rounded to f32) and dt of the cell into shared.
__device__ void load_steps(const Cell& c, float* cs, float* dts) {
  const int tid = threadIdx.x;
  for (int q = tid; q < c.Q; q += kThreads) dts[q] = c.dt[(size_t)q * c.H];
  if (tid < 32) {
    const int per = (c.Q + 31) / 32;
    const int lo = min(c.Q, tid * per), hi = min(c.Q, lo + per);
    double run = 0.0;
    for (int q = lo; q < hi; ++q) run += (double)c.a[(size_t)q * c.H];
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += v;
    }
    double acc = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) acc = 0.0;
    for (int q = lo; q < hi; ++q) {
      acc += (double)c.a[(size_t)q * c.H];
      cs[q] = (float)acc;
    }
  }
  __syncthreads();
}

// y[q0:q0+64, p0:p0+64] of one cell.
__device__ void y_tile(const Cell& c, const float* cs, const float* dts,
                       float* tiles, float* y, size_t ys, int qt, int p0) {
  float* CsT = tiles;              // [TN][LD]  C chunk of the q-tile, transposed
  float* BsT = CsT + TN * LD;      // [TN][LD]  B chunk of the k-tile, transposed
  float* xs = BsT + TN * LD;       // [TQ][TP]  x of the k-tile
  float* SsT = xs + TQ * TP;       // [TQ][LD]  masked scores, transposed (k, q)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = qt * TQ;
  float yacc[4][4] = {};

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * TQ;
    float sacc[4][4] = {};
    for (int n0 = 0; n0 < c.N; n0 += TN) {
      const int nn = min(TN, c.N - n0);
      __syncthreads();             // earlier readers of the tiles are done
      if (kt == 0 || c.N > TN) {
        for (int idx = tid; idx < TQ * nn; idx += kThreads) {
          const int i = idx / nn, n = idx % nn;
          CsT[n * LD + i] =
              q0 + i < c.Q ? c.C[(size_t)(q0 + i) * c.N + n0 + n] : 0.f;
        }
      }
      for (int idx = tid; idx < TQ * nn; idx += kThreads) {
        const int j = idx / nn, n = idx % nn;
        BsT[n * LD + j] =
            k0 + j < c.Q ? c.B[(size_t)(k0 + j) * c.N + n0 + n] : 0.f;
      }
      if (n0 == 0) {
        for (int idx = tid; idx < TQ * TP; idx += kThreads) {
          const int j = idx / TP, p = idx % TP;
          xs[idx] = (k0 + j < c.Q && p0 + p < c.P)
                        ? c.x[(size_t)(k0 + j) * c.xs + p0 + p] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int n = 0; n < nn; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&CsT[n * LD + 4 * tx]);
        const float4 bv = *reinterpret_cast<const float4*>(&BsT[n * LD + 4 * ty]);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) sacc[r][s] = fmaf(cr[r], bc[s], sacc[r][s]);
      }
    }
    // S[i][j] = (C_i . B_j) * exp(a_cum[i] - a_cum[j]) * dt_j for j <= i
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = k0 + 4 * ty + s;
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + 4 * tx + r;
        v[r] = (j <= i && i < c.Q) ? sacc[r][s] * expf(cs[i] - cs[j]) * dts[j]
                                   : 0.f;
      }
      *reinterpret_cast<float4*>(&SsT[(4 * ty + s) * LD + 4 * tx]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    const int jmax = min(TQ, c.Q - k0);
    for (int j = 0; j < jmax; ++j) {
      const float4 sv = *reinterpret_cast<const float4*>(&SsT[j * LD + 4 * tx]);
      const float4 xv = *reinterpret_cast<const float4*>(&xs[j * TP + 4 * ty]);
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
      const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) yacc[r][s] = fmaf(sr[r], xc[s], yacc[r][s]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * tx + r;
    if (i >= c.Q) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int p = p0 + 4 * ty + s;
      if (p < c.P) y[(size_t)i * ys + p] = yacc[r][s];
    }
  }
}

// state[p0:p0+64, n0:n0+128] of one cell.
__device__ void state_tile(const Cell& c, const float* cs, const float* dts,
                           float* tiles, float* st, int p0, int n0) {
  float* xw = tiles;               // [TQ][TP]  exp(a_cum[-1]-a_cum[k]) dt_k x[k]
  float* Bs = xw + TQ * TP;        // [TQ][TN]  B of the k-tile
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float last = cs[c.Q - 1];
  float acc[4][8] = {};
  for (int k0 = 0; k0 < c.Q; k0 += TQ) {
    __syncthreads();
    for (int idx = tid; idx < TQ * TP; idx += kThreads) {
      const int j = idx / TP, p = idx % TP, k = k0 + j;
      xw[idx] = (k < c.Q && p0 + p < c.P)
                    ? (expf(last - cs[k]) * dts[k]) * c.x[(size_t)k * c.xs + p0 + p]
                    : 0.f;
    }
    for (int idx = tid; idx < TQ * TN; idx += kThreads) {
      const int j = idx / TN, n = idx % TN;
      Bs[idx] = (k0 + j < c.Q && n0 + n < c.N)
                    ? c.B[(size_t)(k0 + j) * c.N + n0 + n] : 0.f;
    }
    __syncthreads();
    const int jmax = min(TQ, c.Q - k0);
    for (int j = 0; j < jmax; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(&xw[j * TP + 4 * tx]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[j * TN + 8 * ty]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[j * TN + 8 * ty + 4]);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float bn[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 8; ++s) acc[r][s] = fmaf(xr[r], bn[s], acc[r][s]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + 4 * tx + r;
    if (p >= c.P) continue;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int n = n0 + 8 * ty + s;
      if (n < c.N) st[(size_t)p * c.N + n] = acc[r][s];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ B,
                 const float* __restrict__ C, float* __restrict__ y,
                 float* __restrict__ state, int Q, int H, int P, int N,
                 int Qpad, int n_qt, int n_pt, int n_nt) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // [Qpad] a_cum
  float* dts = cs + Qpad;                       // [Qpad] dt
  float* tiles = dts + Qpad;

  const int g = blockIdx.x;                     // cell = bc * H + h
  const int bc = g / H, h = g % H;
  const size_t row0 = (size_t)bc * Q;           // first (bc, q) row
  Cell c;
  c.xs = (size_t)H * P;
  c.x = x + (row0 * H + h) * P;
  c.dt = dt + row0 * H + h;
  c.a = a + row0 * H + h;
  c.B = B + row0 * N;
  c.C = C + row0 * N;
  c.Q = Q; c.H = H; c.P = P; c.N = N;
  load_steps(c, cs, dts);

  const int n_y = n_qt * n_pt;
  const int task = blockIdx.y;
  if (task < n_y) {
    const int qt = n_qt - 1 - task / n_pt;      // heaviest q-tile first
    const int p0 = (task % n_pt) * TP;
    y_tile(c, cs, dts, tiles, y + (row0 * H + h) * P, c.xs, qt, p0);
  } else {
    const int t = task - n_y;
    state_tile(c, cs, dts, tiles, state + (size_t)g * P * N,
               (t / n_nt) * TP, (t % n_nt) * TN);
  }
}

}  // namespace

// x, y: [BC, Q, H, P]; dt, a: [BC, Q, H]; B, C: [BC, Q, N]; state:
// [BC, H, P, N]; all f32, contiguous.  Returns the CUDA error code of the
// launch (0 = launched).
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* a,
                                const void* B, const void* C, void* y,
                                void* state, int BC, int Q, int H, int P,
                                int N, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0) return 0;
  if (Q > kMaxQ || (long long)BC * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n_qt = (Q + TQ - 1) / TQ, n_pt = (P + TP - 1) / TP,
            n_nt = (N + TN - 1) / TN;
  const int Qpad = (Q + 3) & ~3;
  const size_t smem =
      (size_t)(2 * Qpad + 2 * TN * LD + TQ * TP + TQ * LD) * sizeof(float);
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const dim3 grid((unsigned)(BC * H), (unsigned)(n_qt * n_pt + n_pt * n_nt));
  ssd_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(state), Q, H, P, N, Qpad, n_qt, n_pt, n_nt);
  return (int)cudaGetLastError();
}
