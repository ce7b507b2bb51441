// Mamba2 SSD within a chunk, for Hopper: f32 arithmetic on the FMA pipes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (_ssd_chunk_kernel /
// ssd_chunk_kernel); its gradient, ssd_chunk_bwd_launch, is at the end of
// this file.  For each cell (one batch-chunk bc and one head h),
// with a_cum = cumsum(a) over the Q steps of the chunk:
//
//   y[q, p]     = sum_{k<=q} (C_q . B_k) exp(a_cum[q] - a_cum[k]) dt_k x[k, p]
//   state[p, n] = sum_k exp(a_cum[Q-1] - a_cum[k]) dt_k x[k, p] B[k, n]
//
// Bound by operations: at the main path's shape (Q 256, P 64, N 128, 48
// heads) a batch-chunk needs about 0.4 GFLOP against 6 MB of operands.  B
// and C are [BC, Q, N], shared by the H heads of a batch-chunk, so C.B^T is
// the same for every head: this kernel forms it once for a group of heads.
//
// Design:
// - Layout.  x, dt, a are read in the model's layout [BC, Q, H, ...] and B, C
//   as [BC, Q, N], so the wrapper copies and broadcasts nothing.  The JAX
//   kernel's [G, Q, ...] layout is the case H = 1.
// - Blocks.  A block per (batch-chunk, group of heads, task), 8 warps.  A
//   group is 16 heads while Q <= 512 (8 past that, for shared memory).  A
//   y task owns a 64-row q-tile.  The block forms the C.B^T tiles of its
//   q-tile for the k-tiles up to the diagonal once, into a panel in shared
//   memory (up to kPanel k-tiles at a time; a q-tile past the panel walks
//   its k-tiles in panels and carries y through its own output rows).
//   Then warp w alone computes y of heads w and w + 8: it forms
//   S = (C.B^T) * exp(a_cum[q] - a_cum[k]) * dt_k, masked to k <= q, KS
//   k-rows at a time, and accumulates y += S x in registers.  A state task
//   owns a 64 x 128 tile of state for kStateHeads heads, a warp per head
//   and half of the columns.  Tasks run heaviest first: the last q-tile,
//   the state tasks, then the other q-tiles from the last.
// - Shared memory serves one 16-byte read per thread per 4 cycles (a warp's
//   float4 read takes 4 wavefronts, broadcast or not), so a thread needs 16
//   FMAs per float4 read to keep the FMA pipes busy.  y and state use 8 x 16
//   register tiles (6 float4 reads for 128 FMAs); C.B^T uses 8 x 8 tiles
//   read along n (16 reads for 256 FMAs), a quarter of the block per k-tile.
// - Copies.  Tiles of x and B come in with cp.async into a double-buffered
//   ring of each warp's own, and the warps of the y and state steps sync
//   only themselves, so one warp's copies and exps overlap another's FMAs.
//   The C and B copies of C.B^T go through a block-wide ring of kStages.
//   a and dt are read by the whole block, coalesced across the group's
//   heads, then scanned from shared memory.
// - Summation order: C.B over n ascending in one chain, y over k ascending,
//   state over k ascending, as the plain version's f32 checks expect.
// - a_cum is summed in f64 by one warp per head and rounded once to f32, as
//   ref.chunk_cumsum does: near a_cum = -180 one f32 ulp is 1.5e-5, and two
//   f32 scans in different orders would disagree by more than the tolerance.
// - Any Q from 1 to kMaxQ, any H, P and N (tiles are masked at the edges;
//   rows whose length is not a multiple of 4 floats are copied without
//   cp.async).  No TF32 and no tensor cores: the f32 check against the plain
//   version is 2e-5.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int TQ = 64;           // rows of a q-tile
constexpr int TK = 64;           // rows of a k-tile (of the C.B^T panel)
constexpr int KS = 16;           // k rows of a warp's y or state step
constexpr int TP = 64;           // head-dim columns of a tile
constexpr int TN = 128;          // state columns of a state task
constexpr int TNC = 16;          // n columns of a C / B copy while forming C.B^T
constexpr int LDQ = TQ + 4;      // pitch of [k][q] tiles (panel and S)
constexpr int LDC = TNC + 4;     // pitch of [row][n] tiles of C and B
constexpr int kStages = 3;       // ring of C / B copies
constexpr int kPanel = 4;        // k-tiles of C.B^T formed together
constexpr int kMaxG = 2 * kWarps;  // heads of a group: up to two a warp
constexpr int kStateHeads = kWarps / 2;  // heads of a state task
constexpr int kMaxQ = 1024;
constexpr int kSmemFloats = 232448 / 4;  // one block an SM
constexpr int kCBWork = kStages * (TQ + kPanel * TK) * LDC;
constexpr int kYWarpWork = KS * LDQ + 2 * KS * TP;    // S^T, x ring
constexpr int kYWork =
    kCBWork > kWarps * kYWarpWork ? kCBWork : kWarps * kYWarpWork;
constexpr int kStateWarpWork = 2 * KS * TP + 2 * KS * (TN / 2) + KS;

struct Args {
  const float *x, *dt, *a, *B, *C;
  float *y, *state;
  int Q, H, P, N;
  int Qp;        // Q rounded up to 4
  int G;         // heads of a group
  int n_groups, pk, n_qt, n_pt, n_nt, n_sparts;
  int vec_x, vec_bc;  // rows of x / of B and C may be copied with cp.async
  int vec_y, vec_st;  // rows of y / of state may be written as float4
};

// rows x cols (cols % 4 == 0) of a row-major source with row stride lds into
// shared memory at pitch ldd, by threads id = 0 .. n - 1 of the caller's
// choosing; entries past (rv, cv) are zero.  With vec the copy is cp.async
// (cv % 4 == 0 and 16-byte aligned rows), else plain loads.
__device__ __forceinline__ void load_tile(float* dst, int ldd,
                                          const float* __restrict__ src,
                                          size_t lds, int rows, int cols,
                                          int rv, int cv, int vec, int id,
                                          int n) {
  if (vec) {
    const int c4n = cols / 4;
    for (int idx = id; idx < rows * c4n; idx += n) {
      const int r = idx / c4n, c = (idx % c4n) * 4;
      const bool ok = r < rv && c < cv;
      hw::cp_async16(hw::smem_u32(dst + r * ldd + c),
                     ok ? src + r * lds + c : src, ok);
    }
  } else {
    for (int idx = id; idx < rows * cols; idx += n) {
      const int r = idx / cols, c = idx % cols;
      dst[r * ldd + c] = (r < rv && c < cv) ? src[r * lds + c] : 0.f;
    }
  }
}

// A warp's copy of a KS x 64 tile (row stride lds) into shared memory at
// pitch ldd: lane copies column 4 (lane % 16) of rows lane / 16 + 2 i, so
// its addresses are one multiply-add apart.  Entries past (rv, cv) are zero.
__device__ __forceinline__ void warp_tile(float* dst, int ldd,
                                          const float* __restrict__ src,
                                          size_t lds, int rv, int cv, int vec,
                                          int lane) {
  if (!vec) {
    load_tile(dst, ldd, src, lds, KS, 64, rv, cv, 0, lane, 32);
    return;
  }
  const int r0 = lane / 16, c = 4 * (lane % 16);
  const bool cok = c < cv;
  const float* sp = src + (size_t)r0 * lds + c;
  const uint32_t dp = hw::smem_u32(dst + r0 * ldd + c);
#pragma unroll
  for (int i = 0; i < KS / 2; ++i) {
    const bool ok = cok && r0 + 2 * i < rv;
    hw::cp_async16(dp + 4 * 2 * i * ldd, ok ? sp + 2 * i * lds : src, ok);
  }
}

// dt and a_cum (inclusive, f64 sum rounded to f32) of steps [0, len) of nh
// consecutive heads into cs[j * Qp + q], dts[j * Qp + q].  a and dt point at
// the first head's step 0; step q of head j is at [q * H + j].  The whole
// block reads, then warp w scans heads w, w + 8, ...  Ends with a barrier.
__device__ void load_steps(const float* __restrict__ a,
                           const float* __restrict__ dt, int H, int nh,
                           int len, int Qp, float* cs, float* dts) {
  for (int idx = threadIdx.x; idx < nh * len; idx += kThreads) {
    const int q = idx / nh, j = idx % nh;
    cs[j * Qp + q] = a[(size_t)q * H + j];
    dts[j * Qp + q] = dt[(size_t)q * H + j];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = warp; h < nh; h += kWarps) {
    float* c = cs + h * Qp;
    const int per = (len + 31) / 32;
    const int lo = min(len, lane * per), hi = min(len, lo + per);
    double run = 0.0;
    for (int q = lo; q < hi; ++q) run += (double)c[q];
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    double acc = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) acc = 0.0;
    for (int q = lo; q < hi; ++q) {
      acc += (double)c[q];
      c[q] = (float)acc;
    }
  }
  __syncthreads();
}

// Row i (0..7) of an 8-row register tile: 4l + i, then 32 + 4l + i - 4.
__device__ __forceinline__ int tile_row(int l, int i) {
  return i < 4 ? 4 * l + i : 28 + 4 * l + i;
}

// An 8 x 16 register tile to rows tile_row(l, .) and columns 16 m + c of
// dst (row stride ld), within rv rows and cv columns; as float4 when vec.
__device__ __forceinline__ void store_tile(float* dst, size_t ld,
                                           const float (&acc)[8][16], int l,
                                           int rv, int cv, int vec) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int q = tile_row(l, r);
    if (q >= rv) continue;
    float* row = dst + (size_t)q * ld;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (vec && 16 * m + 3 < cv) {
        *reinterpret_cast<float4*>(row + 16 * m) =
            make_float4(acc[r][4 * m], acc[r][4 * m + 1], acc[r][4 * m + 2],
                        acc[r][4 * m + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (16 * m + c < cv) row[16 * m + c] = acc[r][4 * m + c];
      }
    }
  }
}

// C.B^T of the q-tile at q0 against k-tiles kp0 .. kp0+np-1 (np <= kPanel),
// into the panel cbp[(kt - kp0) * TK + k][q].  A quarter of the block per
// k-tile; in it thread t owns q = t % 8 + 8 i and k = t / 8 + 8 i'.
__device__ void form_cb(const Args& g, const float* __restrict__ Cq,
                        const float* __restrict__ Bc, int q0, int kp0, int np,
                        float* cbp, float* work) {
  const int tid = threadIdx.x, kq = tid / 64, t = tid % 64;
  const int ql = t % 8, kl = t / 8;
  constexpr int kStage = (TQ + kPanel * TK) * LDC;
  const int n_nc = (g.N + TNC - 1) / TNC;
  auto issue = [&](int s) {
    float* Cs = work + (s % kStages) * kStage;   // [TQ][LDC]
    float* Bs = Cs + TQ * LDC;                   // [np * TK][LDC]
    const int n0 = s * TNC;
    load_tile(Cs, LDC, Cq + n0, g.N, TQ, TNC, g.Q - q0, g.N - n0, g.vec_bc,
              tid, kThreads);
    load_tile(Bs, LDC, Bc + (size_t)kp0 * TK * g.N + n0, g.N, np * TK, TNC,
              g.Q - kp0 * TK, g.N - n0, g.vec_bc, tid, kThreads);
  };
  __syncthreads();                        // earlier readers of work are done
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_nc) issue(s);
    hw::cp_async_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < n_nc; ++s) {
    if (s + kStages - 1 < n_nc) issue(s + kStages - 1);
    hw::cp_async_commit();
    hw::cp_async_wait<kStages - 1>();
    __syncthreads();
    if (kq < np) {
      const float* Cb = work + (s % kStages) * kStage;
      const float* Bb = Cb + (TQ + kq * TK) * LDC;
#pragma unroll 1
      for (int n = 0; n < TNC; n += 4) {
        float4 c[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          c[i] = *reinterpret_cast<const float4*>(&Cb[(ql + 8 * i) * LDC + n]);
          b[i] = *reinterpret_cast<const float4*>(&Bb[(kl + 8 * i) * LDC + n]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(c[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(c[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(c[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(c[i].w, b[j].w, acc[i][j]);
          }
      }
    }
    __syncthreads();                      // before the ring reuses this buffer
  }
  if (kq < np) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        cbp[(kq * TK + kl + 8 * j) * LDQ + ql + 8 * i] = acc[i][j];
  }
  __syncthreads();
}

// y of q-tile qt for the heads of group grp: warp w computes heads w, w + 8.
__device__ void y_task(const Args& g, int bc, int grp, int qt, float* sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = grp * g.G, gn = min(g.G, g.H - h0);
  const int q0 = qt * TQ, kend = min(g.Q, q0 + TQ), n_kt = qt + 1;
  const size_t row0 = (size_t)bc * g.Q;
  const size_t ld = (size_t)g.H * g.P;           // row stride of x and y
  float* cs = sm;                                // [G][Qp] a_cum
  float* dts = cs + g.G * g.Qp;                  // [G][Qp] dt
  float* cbp = dts + g.G * g.Qp;                 // [pk * TK][LDQ] C.B^T
  float* work = cbp + g.pk * TK * LDQ;
  load_steps(g.a + row0 * g.H + h0, g.dt + row0 * g.H + h0, g.H, gn, kend,
             g.Qp, cs, dts);
  const float* Cq = g.C + (row0 + q0) * g.N;
  const float* Bc = g.B + row0 * g.N;

  // warp w: heads h0 + w, h0 + w + 8, ...; lane owns q rows tile_row(qg, .)
  // and p columns 16 m + 4 pg + c
  const int qg = lane % 8, pg = lane / 8;
  float* ST = work + warp * kYWarpWork;          // [KS][LDQ] S^T
  float* xs = ST + KS * LDQ;                     // [2][KS][TP]
  for (int kp0 = 0; kp0 < n_kt; kp0 += g.pk) {
    const int np = min(g.pk, n_kt - kp0);
    form_cb(g, Cq, Bc, q0, kp0, np, cbp, work);  // ends with a barrier
    for (int j = warp; j < gn; j += kWarps) {
      const float* csj = cs + j * g.Qp;
      const float* dtj = dts + j * g.Qp;
      const float* xh = g.x + row0 * ld + (size_t)(h0 + j) * g.P;
      const int per_pt = np * TK / KS, steps = g.n_pt * per_pt;
      // step s: p-tile s / per_pt, panel rows KS * (s % per_pt) onwards
      auto issue = [&](int s) {
        const int pt = s / per_pt, k0 = kp0 * TK + (s % per_pt) * KS;
        warp_tile(xs + (s & 1) * KS * TP, TP, xh + (size_t)k0 * ld + pt * TP,
                  ld, g.Q - k0, g.P - pt * TP, g.vec_x, lane);
      };
      issue(0);
      hw::cp_async_commit();
      int s = 0;
      for (int pt = 0; pt < g.n_pt; ++pt) {
        const int p0 = pt * TP;
        float* yh = g.y + (row0 + q0) * ld + (size_t)(h0 + j) * g.P + p0 + 4 * pg;
        float acc[8][16];
        // a later panel continues the sums this lane stored in y
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int q = tile_row(qg, r);
          const bool rok = kp0 > 0 && q0 + q < g.Q;
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            const int pc = 16 * (c / 4) + c % 4;
            acc[r][c] = (rok && p0 + 4 * pg + pc < g.P) ? yh[(size_t)q * ld + pc] : 0.f;
          }
        }
        for (int kl = 0; kl < np * TK; kl += KS, ++s) {
          if (s + 1 < steps) issue(s + 1);
          hw::cp_async_commit();
          // S[q][k] = (C_q . B_k) * exp(a_cum[q] - a_cum[k]) * dt_k, k <= q < Q;
          // below the diagonal tile of a whole q-tile nothing is masked
          const int k0 = kp0 * TK + kl, q4 = 4 * (lane % 16);
          const bool whole = k0 + KS <= q0 && q0 + TQ <= g.Q;
          const float4 cq = *reinterpret_cast<const float4*>(&csj[q0 + q4]);
          const float csq[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll 2
          for (int i = 0; i < KS / 2; ++i) {
            const int k = lane / 16 + 2 * i, kg = k0 + k;
            const float4 cb = *reinterpret_cast<const float4*>(&cbp[(kl + k) * LDQ + q4]);
            const float cbv[4] = {cb.x, cb.y, cb.z, cb.w};
            const bool kok = kg < kend;
            const float csk = kok ? csj[kg] : 0.f, dtk = kok ? dtj[kg] : 0.f;
            float v[4];
            if (whole) {
#pragma unroll
              for (int r = 0; r < 4; ++r) v[r] = (cbv[r] * expf(csq[r] - csk)) * dtk;
            } else {
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int qr = q0 + q4 + r;
                v[r] = (kok && kg <= qr && qr < g.Q)
                           ? (cbv[r] * expf(csq[r] - csk)) * dtk : 0.f;
              }
            }
            *reinterpret_cast<float4*>(&ST[k * LDQ + q4]) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
          hw::cp_async_wait<1>();
          __syncwarp();
          const float* xb = xs + (s & 1) * KS * TP;
#pragma unroll 4
          for (int k = 0; k < KS; ++k) {
            const float4 s0 = *reinterpret_cast<const float4*>(&ST[k * LDQ + 4 * qg]);
            const float4 s1 = *reinterpret_cast<const float4*>(&ST[k * LDQ + 32 + 4 * qg]);
            const float sr[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
            float xc[16];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const float4 v = *reinterpret_cast<const float4*>(&xb[k * TP + 16 * m + 4 * pg]);
              xc[4 * m] = v.x; xc[4 * m + 1] = v.y; xc[4 * m + 2] = v.z; xc[4 * m + 3] = v.w;
            }
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int c = 0; c < 16; ++c) acc[r][c] = fmaf(sr[r], xc[c], acc[r][c]);
          }
          __syncwarp();               // before S and this x buffer are reused
        }
        store_tile(yh, ld, acc, qg, g.Q - q0, g.P - p0 - 4 * pg, g.vec_y);
      }
    }
  }
}

// state[:, n-tile] of kStateHeads heads of group grp: warp w computes head
// w / 2, columns 64 (w % 2) onwards of the tile.
__device__ void state_task(const Args& g, int bc, int grp, int task,
                           float* sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = task / g.n_sparts, part = task % g.n_sparts;
  const int hs = grp * g.G + part * kStateHeads;
  const int hn = min(kStateHeads, min(g.G - part * kStateHeads, g.H - hs));
  if (hn <= 0) return;
  const size_t row0 = (size_t)bc * g.Q;
  const size_t ld = (size_t)g.H * g.P;
  float* cs = sm;                                // [kStateHeads][Qp]
  float* dts = cs + kStateHeads * g.Qp;
  load_steps(g.a + row0 * g.H + hs, g.dt + row0 * g.H + hs, g.H, hn, g.Q,
             g.Qp, cs, dts);
  const int j = warp / 2, nh0 = nt * TN + (TN / 2) * (warp % 2);
  if (j >= hn || nh0 >= g.N) return;
  float* xs = dts + kStateHeads * g.Qp + warp * kStateWarpWork;  // [2][KS][TP]
  float* Bs = xs + 2 * KS * TP;                  // [2][KS][TN / 2]
  float* ws = Bs + 2 * KS * (TN / 2);            // [KS] exp(a_cum[-1]-a_cum[k]) dt_k
  const float* csj = cs + j * g.Qp;
  const float* dtj = dts + j * g.Qp;
  const float last = csj[g.Q - 1];
  const float* xh = g.x + row0 * ld + (size_t)(hs + j) * g.P;
  const float* Bh = g.B + row0 * g.N + nh0;

  // lane owns p rows tile_row(pg, .) and n columns 16 m + 4 ng + c
  const int pg = lane % 8, ng = lane / 8;
  const int n_ks = (g.Q + KS - 1) / KS, steps = g.n_pt * n_ks;
  auto issue = [&](int s) {
    const int pt = s / n_ks, k0 = (s % n_ks) * KS, buf = s & 1;
    warp_tile(xs + buf * KS * TP, TP, xh + (size_t)k0 * ld + pt * TP, ld,
              g.Q - k0, g.P - pt * TP, g.vec_x, lane);
    warp_tile(Bs + buf * KS * (TN / 2), TN / 2, Bh + (size_t)k0 * g.N, g.N,
              g.Q - k0, g.N - nh0, g.vec_bc, lane);
  };
  issue(0);
  hw::cp_async_commit();
  int s = 0;
  for (int pt = 0; pt < g.n_pt; ++pt) {
    float acc[8][16];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < g.Q; k0 += KS, ++s) {
      if (s + 1 < steps) issue(s + 1);
      hw::cp_async_commit();
      if (lane < KS) {
        const int kg = k0 + lane;
        ws[lane] = kg < g.Q ? expf(last - csj[kg]) * dtj[kg] : 0.f;
      }
      hw::cp_async_wait<1>();
      __syncwarp();
      const float* xb = xs + (s & 1) * KS * TP;
      const float* Bb = Bs + (s & 1) * KS * (TN / 2);
#pragma unroll 4
      for (int k = 0; k < KS; ++k) {
        const float w = ws[k];
        const float4 x0 = *reinterpret_cast<const float4*>(&xb[k * TP + 4 * pg]);
        const float4 x1 = *reinterpret_cast<const float4*>(&xb[k * TP + 32 + 4 * pg]);
        const float xr[8] = {w * x0.x, w * x0.y, w * x0.z, w * x0.w,
                             w * x1.x, w * x1.y, w * x1.z, w * x1.w};
        float bn[16];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float4 v = *reinterpret_cast<const float4*>(&Bb[k * (TN / 2) + 16 * m + 4 * ng]);
          bn[4 * m] = v.x; bn[4 * m + 1] = v.y; bn[4 * m + 2] = v.z; bn[4 * m + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 16; ++c) acc[r][c] = fmaf(xr[r], bn[c], acc[r][c]);
      }
      __syncwarp();                 // before ws and this buffer are reused
    }
    store_tile(g.state + ((size_t)bc * g.H + hs + j) * g.P * g.N +
                   (size_t)pt * TP * g.N + nh0 + 4 * ng,
               g.N, acc, pg, g.P - pt * TP, g.N - nh0 - 4 * ng, g.vec_st);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const Args g) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int bc = blockIdx.x / g.n_groups, grp = blockIdx.x % g.n_groups;
  const int n_st = g.n_nt * g.n_sparts;
  // heaviest first: the last q-tile, the state tasks, the other q-tiles
  const int task = blockIdx.y;
  if (task == 0) {
    y_task(g, bc, grp, g.n_qt - 1, sm);
  } else if (task <= n_st) {
    state_task(g, bc, grp, task - 1, sm);
  } else {
    y_task(g, bc, grp, g.n_qt - 1 - (task - n_st), sm);
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
  Args g;
  g.x = static_cast<const float*>(x);
  g.dt = static_cast<const float*>(dt);
  g.a = static_cast<const float*>(a);
  g.B = static_cast<const float*>(B);
  g.C = static_cast<const float*>(C);
  g.y = static_cast<float*>(y);
  g.state = static_cast<float*>(state);
  g.Q = Q; g.H = H; g.P = P; g.N = N;
  g.Qp = (Q + 3) & ~3;
  // groups of 16 heads while their a_cum and dt leave room for a k-tile
  // of the panel, else 8
  g.G = H < kMaxG ? H : kMaxG;
  if (g.G > kWarps && 2 * g.G * g.Qp + kYWork + TK * LDQ > kSmemFloats)
    g.G = kWarps;
  g.n_groups = (H + g.G - 1) / g.G;
  g.n_qt = (Q + TQ - 1) / TQ;
  g.n_pt = (P + TP - 1) / TP;
  g.n_nt = (N + TN - 1) / TN;
  g.n_sparts = (g.G + kStateHeads - 1) / kStateHeads;
  if (Q > kMaxQ || (long long)BC * g.n_groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  g.vec_x = (P % 4 == 0) && ((uintptr_t)x % 16 == 0);
  g.vec_bc = (N % 4 == 0) && (((uintptr_t)B | (uintptr_t)C) % 16 == 0);
  g.vec_y = (P % 4 == 0) && ((uintptr_t)y % 16 == 0);
  g.vec_st = (N % 4 == 0) && ((uintptr_t)state % 16 == 0);
  // the C.B^T panel takes what the rest leaves of the shared memory
  const int y_rest = 2 * g.G * g.Qp + kYWork;
  const int state_f = 2 * kStateHeads * g.Qp + kWarps * kStateWarpWork;
  int pk = (kSmemFloats - y_rest) / (TK * LDQ);
  pk = pk > kPanel ? kPanel : pk;
  pk = pk < 1 ? 1 : (pk > g.n_qt ? g.n_qt : pk);
  g.pk = pk;
  const int y_f = y_rest + pk * TK * LDQ;
  const size_t smem = (size_t)(y_f > state_f ? y_f : state_f) * sizeof(float);
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const dim3 grid((unsigned)(BC * g.n_groups),
                  (unsigned)(g.n_nt * g.n_sparts + g.n_qt));
  ssd_chunk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// The gradient of the function above (the TPU package has no backward
// kernel: its models train through plain jnp).  Per cell (bc, h), with
// CB = C.B^T, L[q,k] = exp(a_cum[q] - a_cum[k]) for k <= q, M = CB L dt_k,
// dM = dy x^T, e_k = exp(a_cum[Q-1] - a_cum[k]), w = e dt and
// dsB[k,p] = sum_n ds[p,n] B[k,n]:
//
//   dx[k,p]  = sum_{q>=k} M[q,k] dy[q,p] + w_k dsB[k,p]
//   ddt[k]   = sum_{q>=k} dM CB L + e_k dw_k,      dw_k = sum_p x[k,p] dsB[k,p]
//   dacum[i] = sum_{k<i} G[i,k] - sum_{q>i} G[q,i]   (G = dM M; the diagonal,
//              where L is 1 whatever a_cum is, drops out), + sum_{k<Q-1}
//              dw_k w_k at i = Q-1, - dw_i w_i below it
//   da[j]    = sum_{i>=j} dacum[i]                  (summed in f64)
//   dC[q,n]  = sum_{k<=q} dCB[q,k] B[k,n],   dB[k,n] = sum_{q>=k} dCB[q,k]
//              C[q,n] + sum_h w_h[k] sum_p x_h[k,p] ds_h[p,n],
//   with dCB = sum_h dM L dt (B and C are shared by the heads of a cell).
//
// Bound by operations (about 13 GFLOP against 188 MB at mamba2's training
// shape), computed in f32 on the FMA pipes; no TF32.  A simple design that
// is right first: five launches, each a grid of 64 x 64 output tiles of
// 256 threads, a thread owning 4 x 4 of the tile, its operands staged 16
// deep through shared memory (tile_mma); the scratch (the wrapper's) keeps
// what one launch hands the next:
//
//   1. steps: a warp a (bc, h): a_cum (f64 scan rounded once to f32, as the
//      forward) and w;
//   2. pairs (with dy): a block a (bc, q-tile, k-tile <= q-tile) forms its
//      CB tile once, then walks the heads in order: dM of the tile, then
//      dCB += dM L dt in registers, and G's row sums (a half-warp's shuffle)
//      and column sums of G and of dM CB L (in order through shared memory)
//      as partials a tile; it writes the CB and dCB tiles;
//   3. dx: a block a (bc, h, k-tile) walks the p-tiles: M^T dy over
//      q >= k (M formed from the CB tiles), dsB over n, dx, and dw's sum;
//   4. dB and dC: a block a (bc, row tile, n-tile) of either: dC from the
//      dCB rows, dB from its columns and then the state's H P terms, the
//      heads in order;
//   5. steps: a warp a (bc, h) sums the partials in order into ddt and
//      dacum, and da by a reverse f64 scan.
//
// Each output has one owner and every sum a fixed order (no atomics), so
// the kernel is deterministic.  Any Q from 1 to kMaxQ, any H, P, N.

namespace {

constexpr int kBT = 64;               // rows and columns of a tile
constexpr int kBK = 16;               // depth of a staged slice
constexpr int kBPitch = kBT + 4;      // shared-memory pitch of a slice row
constexpr int kBThreads = 256;
constexpr int kBWarps = kBThreads / 32;

struct BwdArgs {
  const float *x, *dt, *a, *B, *C, *dy, *ds;   // dy or ds may be null
  float *dx, *ddt, *da, *dB, *dC;
  // scratch: cs, w, dw [BC][H][Q]; cb, dcb [BC][Q][Q]; rowg (by k-tile),
  // colg, cole (by q-tile) [BC][nt][H][Q]
  float *cs, *w, *dw, *cb, *dcb, *rowg, *colg, *cole;
  int BC, Q, H, P, N, nt, n_pairs, n_pt, n_nt;
};

// acc[i][j] += sum over k in [k_lo, k_hi) of A(k, 4 ty + i) B(k, 4 tx + j),
// with ty = thread / 16, tx = thread % 16, k ascending; fa(k, r) and fb(k, c)
// give the operands (0 past their edges).  A slice of kBK k goes through
// shared memory (As, Bs: [kBK][kBPitch]); kA / kB: the operand runs along k
// in device memory, so neighbouring threads load neighbouring k, else
// neighbouring rows.  Starts with a barrier; writes no shared memory after
// its last barrier.
template <bool kA, bool kB, class FA, class FB>
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], int k_lo,
                                         int k_hi, FA fa, FB fb, float* As,
                                         float* Bs) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();                   // earlier readers of As, Bs are done
    for (int idx = tid; idx < kBK * kBT; idx += kBThreads) {
      const int kk = kA ? idx % kBK : idx / kBT;
      const int r = kA ? idx / kBK : idx % kBT;
      As[kk * kBPitch + r] = k0 + kk < k_hi ? fa(k0 + kk, r) : 0.f;
    }
    for (int idx = tid; idx < kBK * kBT; idx += kBThreads) {
      const int kk = kB ? idx % kBK : idx / kBT;
      const int c = kB ? idx / kBK : idx % kBT;
      Bs[kk * kBPitch + c] = k0 + kk < k_hi ? fb(k0 + kk, c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk * kBPitch + 4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk * kBPitch + 4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

// The sum of v over the 16 lanes of a half-warp (the threads of one ty), the
// same butterfly every call.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A warp's segment of [0, Q): lane l owns [lo, hi).
__device__ __forceinline__ void lane_segment(int Q, int lane, int& lo,
                                             int& hi) {
  const int per = (Q + 31) / 32;
  lo = min(Q, lane * per);
  hi = min(Q, lo + per);
}

// 1. a_cum (inclusive, f64 sum rounded once) and w = exp(a_cum[Q-1] -
// a_cum) dt of each (bc, h), a warp each, into cs and w [BC][H][Q].
__global__ void __launch_bounds__(kBThreads)
ssd_bwd_steps_kernel(const BwdArgs g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kBWarps + warp;          // bc * H + h
  if (cell >= g.BC * g.H) return;
  const int bc = cell / g.H, h = cell % g.H;
  const float* a = g.a + (size_t)bc * g.Q * g.H + h;     // step q at [q H]
  const float* dt = g.dt + (size_t)bc * g.Q * g.H + h;
  float* cs = g.cs + (size_t)cell * g.Q;
  int lo, hi;
  lane_segment(g.Q, lane, lo, hi);
  double run = 0.0;
  for (int q = lo; q < hi; ++q) run += (double)a[(size_t)q * g.H];
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  double acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.0;
  for (int q = lo; q < hi; ++q) {
    acc += (double)a[(size_t)q * g.H];
    cs[q] = (float)acc;
  }
  __syncwarp();
  const float last = cs[g.Q - 1];
  for (int q = lane; q < g.Q; q += 32)
    g.w[(size_t)cell * g.Q + q] = expf(last - cs[q]) * dt[(size_t)q * g.H];
}

// 2. a block a (bc, q-tile qt, k-tile kt <= qt).
__global__ void __launch_bounds__(kBThreads)
ssd_bwd_pairs_kernel(const BwdArgs g) {
  __shared__ __align__(16) float As[kBK * kBPitch];
  __shared__ __align__(16) float Bs[kBK * kBPitch];
  __shared__ float csq[kBT], csk[kBT], dtk[kBT];
  __shared__ float colG[16][kBT], colE[16][kBT];
  const int Q = g.Q, H = g.H, P = g.P, N = g.N;
  const int bc = blockIdx.x / g.n_pairs, pr = blockIdx.x % g.n_pairs;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= pr) ++qt;
  const int kt = pr - qt * (qt + 1) / 2;
  const int q0 = qt * kBT, k0 = kt * kBT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)bc * Q;
  const size_t ld = (size_t)H * P;                 // row stride of x, dy
  const float* Cc = g.C + row0 * N;
  const float* Bc = g.B + row0 * N;
  float cb[4][4] = {};
  tile_mma<true, true>(
      cb, 0, N,
      [&](int n, int r) { return q0 + r < Q ? Cc[(size_t)(q0 + r) * N + n] : 0.f; },
      [&](int n, int c) { return k0 + c < Q ? Bc[(size_t)(k0 + c) * N + n] : 0.f; },
      As, Bs);
  float dcb[4][4] = {};
  for (int h = 0; h < H; ++h) {
    const float* csh = g.cs + ((size_t)bc * H + h) * Q;
    if (tid < kBT) {
      csq[tid] = q0 + tid < Q ? csh[q0 + tid] : 0.f;
    } else if (tid < 2 * kBT) {
      const int c = tid - kBT, k = k0 + c;
      csk[c] = k < Q ? csh[k] : 0.f;
      dtk[c] = k < Q ? g.dt[(row0 + k) * H + h] : 0.f;
    }
    const float* dyh = g.dy + row0 * ld + (size_t)h * P;
    const float* xh = g.x + row0 * ld + (size_t)h * P;
    float dm[4][4] = {};
    tile_mma<true, true>(
        dm, 0, P,
        [&](int p, int r) { return q0 + r < Q ? dyh[(size_t)(q0 + r) * ld + p] : 0.f; },
        [&](int p, int c) { return k0 + c < Q ? xh[(size_t)(k0 + c) * ld + p] : 0.f; },
        As, Bs);
    float rg[4] = {}, cg[4] = {}, ce[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = 4 * ty + i, q = q0 + ql;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j, k = k0 + c;
        const bool keep = q < Q && k <= q;
        const float L = keep ? expf(csq[ql] - csk[c]) : 0.f;
        dcb[i][j] = fmaf(dm[i][j], L * dtk[c], dcb[i][j]);
        const float E = dm[i][j] * cb[i][j] * L;
        const float G = k < q ? E * dtk[c] : 0.f;
        rg[i] += G;
        cg[j] += G;
        ce[j] += E;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = half_warp_sum(rg[i]);
      const int q = q0 + 4 * ty + i;
      if (tx == 0 && q < Q)
        g.rowg[(((size_t)bc * g.nt + kt) * H + h) * Q + q] = s;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      colG[ty][4 * tx + j] = cg[j];
      colE[ty][4 * tx + j] = ce[j];
    }
    __syncthreads();
    if (tid < kBT && k0 + tid < Q) {
      float sg = 0.f, se = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        sg += colG[t][tid];
        se += colE[t][tid];
      }
      const size_t o = (((size_t)bc * g.nt + qt) * H + h) * Q + k0 + tid;
      g.colg[o] = sg;
      g.cole[o] = se;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + 4 * ty + i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * tx + j;
      if (k >= Q) continue;
      g.cb[(row0 + q) * Q + k] = cb[i][j];
      g.dcb[(row0 + q) * Q + k] = dcb[i][j];
    }
  }
}

// 3. a block a (bc, h, k-tile): dx of its rows, p-tile by p-tile, and dw.
__global__ void __launch_bounds__(kBThreads)
ssd_bwd_dx_kernel(const BwdArgs g) {
  __shared__ __align__(16) float As[kBK * kBPitch];
  __shared__ __align__(16) float Bs[kBK * kBPitch];
  __shared__ float csS[kMaxQ], dtS[kMaxQ];
  const int Q = g.Q, H = g.H, P = g.P, N = g.N;
  const int cell = blockIdx.x / g.nt, kt = blockIdx.x % g.nt;
  const int bc = cell / H, h = cell % H, k0 = kt * kBT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)bc * Q;
  const size_t ld = (size_t)H * P;
  for (int q = tid; q < Q; q += kBThreads) {
    csS[q] = g.cs[(size_t)cell * Q + q];
    dtS[q] = g.dt[(row0 + q) * H + h];
  }
  __syncthreads();
  const float* cbc = g.cb + row0 * Q;
  const float* dyh = g.dy ? g.dy + row0 * ld + (size_t)h * P : nullptr;
  const float* xh = g.x + row0 * ld + (size_t)h * P;
  const float* dsh = g.ds ? g.ds + (size_t)cell * P * N : nullptr;
  const float* Bc = g.B + row0 * N;
  float dwacc[4] = {};
  for (int pt = 0; pt < g.n_pt; ++pt) {
    const int p0 = pt * kBT;
    float acc[4][4] = {}, acc2[4][4] = {};
    if (g.dy)                                    // M^T dy over q >= k
      tile_mma<false, false>(
          acc, k0, Q,
          [&](int q, int r) {
            const int k = k0 + r;
            return k < Q && k <= q
                       ? cbc[(size_t)q * Q + k] * expf(csS[q] - csS[k]) * dtS[k]
                       : 0.f;
          },
          [&](int q, int c) { return p0 + c < P ? dyh[(size_t)q * ld + p0 + c] : 0.f; },
          As, Bs);
    if (g.ds)                                    // dsB = B ds^T
      tile_mma<true, true>(
          acc2, 0, N,
          [&](int n, int r) { return k0 + r < Q ? Bc[(size_t)(k0 + r) * N + n] : 0.f; },
          [&](int n, int c) { return p0 + c < P ? dsh[(size_t)(p0 + c) * N + n] : 0.f; },
          As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 4 * ty + i;
      const float wk = k < Q ? g.w[(size_t)cell * Q + k] : 0.f;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + 4 * tx + j;
        if (k < Q && p < P) {
          g.dx[(row0 + k) * ld + (size_t)h * P + p] = fmaf(wk, acc2[i][j], acc[i][j]);
          part = fmaf(xh[(size_t)k * ld + p], acc2[i][j], part);
        }
      }
      dwacc[i] += half_warp_sum(part);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (tx == 0 && k < Q) g.dw[(size_t)cell * Q + k] = dwacc[i];
  }
}

// 4. a block a (bc, dC or dB, row tile, n-tile).
__global__ void __launch_bounds__(kBThreads)
ssd_bwd_bc_kernel(const BwdArgs g) {
  __shared__ __align__(16) float As[kBK * kBPitch];
  __shared__ __align__(16) float Bs[kBK * kBPitch];
  const int Q = g.Q, H = g.H, P = g.P, N = g.N;
  const int per = 2 * g.nt * g.n_nt;
  const int bc = blockIdx.x / per, rest = blockIdx.x % per;
  const bool is_db = rest >= g.nt * g.n_nt;
  const int rt = (rest % (g.nt * g.n_nt)) / g.n_nt, nt = rest % g.n_nt;
  const int r0 = rt * kBT, n0 = nt * kBT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t row0 = (size_t)bc * Q;
  const float* dcbc = g.dcb + row0 * Q;
  float acc[4][4] = {};
  if (!is_db) {
    if (g.dy) {                                  // dC = dCB B over k <= q
      const float* Bc = g.B + row0 * N;
      tile_mma<true, false>(
          acc, 0, min(Q, r0 + kBT),
          [&](int k, int r) { return r0 + r < Q ? dcbc[(size_t)(r0 + r) * Q + k] : 0.f; },
          [&](int k, int c) { return n0 + c < N ? Bc[(size_t)k * N + n0 + c] : 0.f; },
          As, Bs);
    }
  } else {
    if (g.dy) {                                  // dB = dCB^T C over q >= k
      const float* Cc = g.C + row0 * N;
      tile_mma<false, false>(
          acc, r0, Q,
          [&](int q, int r) { return r0 + r < Q ? dcbc[(size_t)q * Q + r0 + r] : 0.f; },
          [&](int q, int c) { return n0 + c < N ? Cc[(size_t)q * N + n0 + c] : 0.f; },
          As, Bs);
    }
    if (g.ds) {                 // + sum over (h, p) of w_h x_h[., p] ds_h[p]
      const size_t ld = (size_t)H * P;
      const float* xc = g.x + row0 * ld;
      const float* wc = g.w + (size_t)bc * H * Q;
      const float* dsc = g.ds + (size_t)bc * ld * N;
      tile_mma<true, false>(
          acc, 0, H * P,
          [&](int j, int r) {
            const int k = r0 + r;
            return k < Q ? wc[(size_t)(j / P) * Q + k] * xc[(size_t)k * ld + j] : 0.f;
          },
          [&](int j, int c) { return n0 + c < N ? dsc[(size_t)j * N + n0 + c] : 0.f; },
          As, Bs);
    }
  }
  float* out = (is_db ? g.dB : g.dC) + row0 * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N) out[(size_t)r * N + n] = acc[i][j];
    }
  }
}

// 5. ddt, and da by a reverse f64 scan of dacum, a warp a (bc, h).
__global__ void __launch_bounds__(kBThreads)
ssd_bwd_out_kernel(const BwdArgs g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cell = blockIdx.x * kBWarps + warp;
  if (cell >= g.BC * g.H) return;
  const int Q = g.Q, H = g.H, nt = g.nt;
  const int bc = cell / H, h = cell % H;
  const size_t row0 = (size_t)bc * Q;
  const float* cs = g.cs + (size_t)cell * Q;
  const float* w = g.w + (size_t)cell * Q;
  const float* dw = g.dw + (size_t)cell * Q;
  const size_t tile = (size_t)H * Q;            // stride of a partial's tile
  const float* rowg = g.rowg + (size_t)bc * nt * tile + (size_t)h * Q;
  const float* colg = g.colg + (size_t)bc * nt * tile + (size_t)h * Q;
  const float* cole = g.cole + (size_t)bc * nt * tile + (size_t)h * Q;
  int lo, hi;
  lane_segment(Q, lane, lo, hi);
  // the state's decay: T_k = dw_k w_k, k < Q - 1, and their sum
  double tsum = 0.0;
  for (int q = lo; q < hi; ++q)
    if (q < Q - 1) tsum += (double)(dw[q] * w[q]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
  const float last = cs[Q - 1];
  for (int q = lo; q < hi; ++q) {
    float v = 0.f;
    if (g.dy)
      for (int t = q / kBT; t < nt; ++t) v += cole[t * tile + q];
    g.ddt[(row0 + q) * H + h] = fmaf(dw[q], expf(last - cs[q]), v);
  }
  auto dacum = [&](int i) -> double {
    float v = 0.f;
    if (g.dy) {
      const int ti = i / kBT;
      for (int t = 0; t <= ti; ++t) v += rowg[t * tile + i];
      for (int t = ti; t < nt; ++t) v -= colg[t * tile + i];
    }
    return i == Q - 1 ? (double)v + tsum : (double)v - (double)(dw[i] * w[i]);
  };
  double seg = 0.0;
  for (int q = lo; q < hi; ++q) seg += dacum(q);
  double incl = seg;                            // sum over lanes >= lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += v;
  }
  double acc = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) acc = 0.0;
  for (int q = hi - 1; q >= lo; --q) {
    acc += dacum(q);
    g.da[(row0 + q) * H + h] = (float)acc;
  }
}

}  // namespace

// x, dy, dx: [BC, Q, H, P]; dt, a, ddt, da: [BC, Q, H]; B, C, dB, dC:
// [BC, Q, N]; ds: [BC, H, P, N]; dy or ds may be null (zero).  scratch:
// scratch_floats floats, at least BC (3 H Q + 2 Q^2 + 3 ceil(Q/64) H Q)
// (ops.ssd_bwd_scratch_floats).  All f32, contiguous.  Returns the CUDA
// error code of the launches (0 = launched).
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* dt, const void* a, const void* B,
    const void* C, const void* dy, const void* ds, void* dx, void* ddt,
    void* da, void* dB, void* dC, void* scratch, long long scratch_floats,
    int BC, int Q, int H, int P, int N, void* stream) {
  if (BC <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0) return 0;
  if (Q > kMaxQ) return (int)cudaErrorInvalidValue;
  BwdArgs g;
  g.x = static_cast<const float*>(x);
  g.dt = static_cast<const float*>(dt);
  g.a = static_cast<const float*>(a);
  g.B = static_cast<const float*>(B);
  g.C = static_cast<const float*>(C);
  g.dy = static_cast<const float*>(dy);
  g.ds = static_cast<const float*>(ds);
  g.dx = static_cast<float*>(dx);
  g.ddt = static_cast<float*>(ddt);
  g.da = static_cast<float*>(da);
  g.dB = static_cast<float*>(dB);
  g.dC = static_cast<float*>(dC);
  g.BC = BC; g.Q = Q; g.H = H; g.P = P; g.N = N;
  g.nt = (Q + kBT - 1) / kBT;
  g.n_pairs = g.nt * (g.nt + 1) / 2;
  g.n_pt = (P + kBT - 1) / kBT;
  g.n_nt = (N + kBT - 1) / kBT;
  const long long hq = (long long)BC * H * Q;
  const long long qq = (long long)BC * Q * Q;
  if (scratch_floats < 3 * hq + 2 * qq + 3 * g.nt * hq)
    return (int)cudaErrorInvalidValue;
  float* s = static_cast<float*>(scratch);
  g.cs = s;
  g.w = g.cs + hq;
  g.dw = g.w + hq;
  g.cb = g.dw + hq;
  g.dcb = g.cb + qq;
  g.rowg = g.dcb + qq;
  g.colg = g.rowg + g.nt * hq;
  g.cole = g.colg + g.nt * hq;
  const long long cells = (long long)BC * H;
  const long long blocks[5] = {(cells + kBWarps - 1) / kBWarps,
                               (long long)BC * g.n_pairs, cells * g.nt,
                               (long long)BC * 2 * g.nt * g.n_nt,
                               (cells + kBWarps - 1) / kBWarps};
  for (long long b : blocks)
    if (b > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  ssd_bwd_steps_kernel<<<(unsigned)blocks[0], kBThreads, 0, st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (dy) {
    ssd_bwd_pairs_kernel<<<(unsigned)blocks[1], kBThreads, 0, st>>>(g);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  ssd_bwd_dx_kernel<<<(unsigned)blocks[2], kBThreads, 0, st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_bc_kernel<<<(unsigned)blocks[3], kBThreads, 0, st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_out_kernel<<<(unsigned)blocks[4], kBThreads, 0, st>>>(g);
  return (int)cudaGetLastError();
}
