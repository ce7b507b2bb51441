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
// Bound by operations: about 13 GFLOP against 188 MB at mamba2's training
// shape, in four products of about the same size (dM = dy x^T, M^T dy,
// B ds^T and the state's sum over (h, p)), computed in f32 on the FMA
// pipes; no TF32.  The design is the forward's:
// - Register tiles.  A warp owns a 64 x 64 tile of a product, 8 x 16 a lane
//   (mma_tn, mma_nt), or 64 x 32, 8 x 8 a lane, where it also carries dCB
//   across heads (mma_nt in pairs).  An operand staged [depth][64] is read as
//   the forward reads it (rows tile_row(l, .): 16 FMAs a float4 read); one
//   staged [row][depth] is read a float4 along the depth a row (16 to 21
//   FMAs a float4), in 16-deep slices at a pitch of 20 floats (mma_nt's rows
//   l + 8 i) or in 32-deep slices whose 16-byte chunks are XOR-swizzled by
//   row (mma_tn's rows 4 l + i), so that a quarter warp reads 8 distinct
//   banks.
// - Copies.  cp.async into two-stage rings, so that slice s + 1 (and the
//   next head's first) is in flight while slice s computes; rows
//   that are not 16-byte multiples are copied with plain loads.
// - Factors.  L, dt and w are applied once to a staged slice (M from C.B^T,
//   (w x)^T from x), and dCB's head groups are summed once a staged slice.
// - Launches (the scratch, the wrapper's, keeps what one hands the next):
//   1. prep: a warp a (bc, h): a_cum (f64 scan rounded once to f32, as the
//      forward) and w; with dy, a block a (bc, q-tile, k-tile <= q-tile):
//      its C.B^T tile, the warps an eighth of n each, summed in order;
//   2. pairs (with dy): a block a (bc, q-tile, k-tile <= q-tile, group of up
//      to kPairHeads heads), two warps a head (sharing one ring) and four
//      heads at a time, the next head's slices in flight: dM (on a diagonal
//      tile only the lanes' register blocks that reach k <= q), dCB += dM L
//      dt (a warp's own tile in shared memory), and G's row sums and the
//      column sums of G and of dM CB L as partials a (head, tile); the block
//      sums its warps' dCB in order into the group's partial;
//   3. dx: a block a (bc, k-tile, group of 8 heads), a warp a head: dsB (B's
//      slices shared by the block), dw, then dx = w dsB + M^T dy (the warp's
//      own ring, M formed in place of its C.B^T slice);
//   4. state (with ds): a block a (bc, k-tile, n-tile, split of up to
//      kSplitHeads heads), a warp a head at a time: the split's sum over
//      (h, p) of (w x)^T ds, its warps summed in order into the partial;
//   5. dsum (with dy): a block a tile: dCB, the groups' partials summed in
//      order, and its transpose;
//   6. bc: a block a (bc, dC or dB, row tile, n-tile), eight warps an eighth
//      of the depth each: dC = dCB B, dB = dCB^T C, the warps summed in
//      order, then dB adds the state's partials in split order;
//   7. out: a block a (bc, h) sums the partials in order into ddt and
//      dacum, and da by a reverse f64 scan.
// Each output has one owner and every sum a fixed order, partials included
// (no atomics), so the kernel is deterministic, and splitting a sum into
// partials makes no chain of roundings longer than ref.ssd_chunk_bwd_f64's
// bound allows.  Any Q from 1 to kMaxQ, any H, P, N.

namespace {

constexpr int kBT = 64;                // rows and columns of a tile
constexpr int kBK = 16;                // depth of a [depth][64] or [row][16] slice
constexpr int kNP = kBK + 4;           // pitch of a [row][16] slice
constexpr int kSK = 32;                // depth of a swizzled [row][32] slice
constexpr int kRP = kBT + 4;           // pitch of a [64][64] tile of sums
constexpr int kBThreads = 256;
constexpr int kBWarps = kBThreads / 32;
constexpr int kPairHeads = 12;         // heads of a pairs block, at most
constexpr int kPairSlice = 2 * kBT * kNP;   // dy [64][kNP], x [2][32][kNP]
constexpr int kDP = kBT / 2 + 4;       // pitch of a pairs warp's [64][32] dCB
constexpr int kSplitHeads = 24;        // heads of a state split, at most
constexpr int kStateSlice = kBT * kNP + kBK * kBT;   // x [64][kNP], ds [16][64]
constexpr int kStateWarp = 2 * kStateSlice + kBK * kBT;  // its ring, (w x)^T
constexpr int kDxStage = (kBWarps + 1) * kBT * kSK;  // B's slice and a warp's
constexpr int kBcWarps = 8;
constexpr int kBcWarp = 2 * 2 * kBK * kBT;         // ring of dCB and B or C

struct BwdArgs {
  const float *x, *dt, *a, *B, *C, *dy, *ds;   // dy or ds may be null
  float *dx, *ddt, *da, *dB, *dC;
  // scratch: cs, w, dw [BC][H][Q]; cb (C.B^T, then dCB), dcbt (dCB^T)
  // [BC][Q][Q]; dcbp [BC][n_hg][Q][Q];
  // rowg [BC][2 nt][H][Q] (by k-tile and half); colg, cole [BC][nt][H][Q]
  // (by q-tile); sp [BC][n_sp][Q][N]
  float *cs, *w, *dw, *cb, *dcbt, *dcbp, *rowg, *colg, *cole, *sp;
  int BC, Q, H, P, N;
  int nt, n_pairs, n_pt, n_nt;  // 64-tiles of Q, their pairs k <= q, of P, N
  int n_hg, G;                  // pairs: head groups, heads of a group
  int n_dg;                     // dx: groups of kBWarps heads
  int n_sp, SG;                 // state: splits, heads of a split
  int n_steps;                  // blocks of prep's steps
  int vec_x, vec_bc, vec_ds, vec_q;  // rows of x, dy, dx / B, C / ds / the
                                     // scratch's [Q][Q] are 16-byte copies
};

// Float offset of element (r, d) of a [rows][kSK] slice whose 16-byte chunk
// c of row r sits at chunk c ^ ((r / 4) % 8).
__device__ __forceinline__ int swz(int r, int d) {
  return r * kSK + ((((d >> 2) ^ (r >> 2)) & 7) << 2) + (d & 3);
}

// rows x kSK of a row-major source (row stride lds) into a swizzled slice,
// by threads id = 0 .. n - 1; entries past (rv, cv) are zero.  With vec the
// copy is cp.async, else plain loads.
__device__ __forceinline__ void load_swz(float* dst,
                                         const float* __restrict__ src,
                                         size_t lds, int rows, int rv, int cv,
                                         int vec, int id, int n) {
  if (vec) {
    for (int idx = id; idx < rows * (kSK / 4); idx += n) {
      const int r = idx >> 3, c = (idx & 7) * 4;
      const bool ok = r < rv && c < cv;
      hw::cp_async16(hw::smem_u32(dst + swz(r, c)), ok ? src + r * lds + c : src,
                     ok);
    }
  } else {
    for (int idx = id; idx < rows * kSK; idx += n) {
      const int r = idx / kSK, c = idx % kSK;
      dst[swz(r, c)] = (r < rv && c < cv) ? src[r * lds + c] : 0.f;
    }
  }
}

// A two-stage ring over steps 0 .. n - 1: issue(s) starts the copies of
// step s (cp.async, or plain stores) into buffer s % 2, compute(s) reads
// them once landed, while step s + 1's copies are in flight.  sync() is the
// barrier of the threads that share the ring (a warp, two, the block); each
// step ends with it, so the ring's buffers are free after the ring.
template <class S, class I, class F>
__device__ __forceinline__ void ring(int n, S sync, I issue, F compute) {
  if (n > 0) issue(0);
  hw::cp_async_commit();
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) issue(s + 1);
    hw::cp_async_commit();
    hw::cp_async_wait<1>();
    sync();
    compute(s);
    sync();
  }
}

struct WarpSync {
  __device__ __forceinline__ void operator()() const { __syncwarp(); }
};
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// acc[i][j] += sum over a kBK slice of A[l + 8 i][d] Bt[m + 4 j][d] (l =
// lane % 8, m = lane / 8), both staged [row][depth] at pitch kNP, depth
// ascending; with kTri only j <= i (the rest lies above a diagonal).
template <int NJ, bool kTri>
__device__ __forceinline__ void mma_nt(float (&acc)[8][NJ], const float* A,
                                       const float* Bt, int lane) {
  const int l = lane & 7, m = lane >> 3;
#pragma unroll
  for (int d = 0; d < kBK; d += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(l + 8 * i) * kNP + d]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(&Bt[(m + 4 * j) * kNP + d]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (kTri && j > i) continue;
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// acc[r][4 m + c] += sum over a kBK slice of A[d][tile_row(l, r)]
// B[d][16 m + 4 g + c] (l = lane % 8, g = lane / 8), both staged
// [depth][64] at pitches lda and ldb, depth ascending.
__device__ __forceinline__ void mma_tn(float (&acc)[8][16], const float* A,
                                       int lda, const float* B, int ldb,
                                       int lane) {
  const int l = lane & 7, g = lane >> 3;
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    const float4 s0 = *reinterpret_cast<const float4*>(&A[k * lda + 4 * l]);
    const float4 s1 = *reinterpret_cast<const float4*>(&A[k * lda + 32 + 4 * l]);
    const float sr[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float bc[16];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 v =
          *reinterpret_cast<const float4*>(&B[k * ldb + 16 * m + 4 * g]);
      bc[4 * m] = v.x;
      bc[4 * m + 1] = v.y;
      bc[4 * m + 2] = v.z;
      bc[4 * m + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = fmaf(sr[r], bc[c], acc[r][c]);
  }
}

// The same tile from operands staged [row][depth]: acc[r][4 m + c] += sum
// over a kSK slice of A[tile_row(l, r)][d] B[16 m + 4 g + c][d], both
// swizzled (swz), depth ascending.  A lane's rows share (row / 4) % 8 = l.
__device__ __forceinline__ void mma_tn_swz(float (&acc)[8][16], const float* A,
                                           const float* B, int lane) {
  const int l = lane & 7, g = lane >> 3;
#pragma unroll 2
  for (int c4 = 0; c4 < kSK / 4; ++c4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(
          &A[tile_row(l, i) * kSK + ((c4 ^ l) << 2)]);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 16 * m + 4 * g + c;
        const float4 b = *reinterpret_cast<const float4*>(
            &B[col * kSK + ((c4 ^ ((col >> 2) & 7)) << 2)]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float& o = acc[i][4 * m + c];
          o = fmaf(a[i].x, b.x, o);
          o = fmaf(a[i].y, b.y, o);
          o = fmaf(a[i].z, b.z, o);
          o = fmaf(a[i].w, b.w, o);
        }
      }
  }
}

// The q-tile and k-tile (k <= q) of pair index pr: (0,0), (1,0), (1,1), ...
__device__ __forceinline__ void pair_of(int pr, int& qt, int& kt) {
  qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= pr) ++qt;
  kt = pr - qt * (qt + 1) / 2;
}

// A warp's segment of [0, Q): lane l owns [lo, hi).
__device__ __forceinline__ void lane_segment(int Q, int lane, int& lo,
                                             int& hi) {
  const int per = (Q + 31) / 32;
  lo = min(Q, lane * per);
  hi = min(Q, lo + per);
}

// a_cum (inclusive, f64 sum rounded once) and w = exp(a_cum[Q-1] - a_cum) dt
// of cell = bc H + h, by one warp, into cs and w; a and dt of the cell's
// steps are staged at as (overwritten with a_cum) and dts.
__device__ void cell_steps(const BwdArgs& g, int cell, int lane, float* as,
                           const float* dts) {
  float* cs = g.cs + (size_t)cell * g.Q;
  int lo, hi;
  lane_segment(g.Q, lane, lo, hi);
  double run = 0.0;
  for (int q = lo; q < hi; ++q) run += (double)as[q];
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  double acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.0;
  for (int q = lo; q < hi; ++q) {
    acc += (double)as[q];
    as[q] = cs[q] = (float)acc;
  }
  __syncwarp();
  const float last = as[g.Q - 1];
  for (int q = lane; q < g.Q; q += 32)
    g.w[(size_t)cell * g.Q + q] = expf(last - as[q]) * dts[q];
}

// 1. prep: blocks below n_steps scan the cells, a warp each (8 cells a
// block, their steps staged together); then, with dy,
// a block a (bc, pair) forms its C.B^T tile into cb: warp w sums its eighth
// of the 16-deep n slices (8 x 16 a lane, a two-stage ring), and the block
// sums the warps in order.
__global__ void __launch_bounds__(kBThreads, 1)
ssd_bwd_prep_kernel(const BwdArgs g) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if ((int)blockIdx.x < g.n_steps) {
    // the block's cells c0 + j: a and dt staged [j][q] (pitch Q + 1), read
    // across the cells' heads
    const int c0 = blockIdx.x * kBWarps;
    const int nc = min(kBWarps, g.BC * g.H - c0), ldq = g.Q + 1;
    for (int idx = tid; idx < nc * g.Q; idx += kBThreads) {
      const int q = idx / nc, j = idx % nc, cell = c0 + j;
      const size_t o = ((size_t)(cell / g.H) * g.Q + q) * g.H + cell % g.H;
      sm[j * ldq + q] = g.a[o];
      sm[(kBWarps + j) * ldq + q] = g.dt[o];
    }
    __syncthreads();
    if (warp < nc)
      cell_steps(g, c0 + warp, lane, sm + warp * ldq,
                 sm + (kBWarps + warp) * ldq);
    return;
  }
  const int tile = blockIdx.x - g.n_steps;
  const int Q = g.Q, N = g.N, bc = tile / g.n_pairs;
  int qt, kt;
  pair_of(tile % g.n_pairs, qt, kt);
  const int q0 = qt * kBT, k0 = kt * kBT;
  const size_t row0 = (size_t)bc * Q;
  const int n_sl = (N + kBK - 1) / kBK;
  const int s_lo = warp * n_sl / kBWarps, s_hi = (warp + 1) * n_sl / kBWarps;
  constexpr int kSlice = 2 * kBT * kNP;                // C rows, B rows
  float* wr = sm + warp * 2 * kSlice;
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
  ring(
      s_hi - s_lo, WarpSync(),
      [&](int s) {
        float* A = wr + (s & 1) * kSlice;
        const int n0 = (s_lo + s) * kBK;
        load_tile(A, kNP, g.C + (row0 + q0) * N + n0, N, kBT, kBK, Q - q0,
                  N - n0, g.vec_bc, lane, 32);
        load_tile(A + kBT * kNP, kNP, g.B + (row0 + k0) * N + n0, N, kBT, kBK,
                  Q - k0, N - n0, g.vec_bc, lane, 32);
      },
      [&](int s) {
        const float* A = wr + (s & 1) * kSlice;
        mma_nt<16, false>(acc, A, A + kBT * kNP, lane);
      });
  __syncthreads();                              // every ring is done
  float* red = sm;                              // [kBWarps][kBT][kRP]
  const int l = lane & 7, m = lane >> 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      red[(warp * kBT + l + 8 * i) * kRP + m + 4 * j] = acc[i][j];
  __syncthreads();
  for (int idx = tid; idx < kBT * kBT; idx += kBThreads) {
    const int r = idx / kBT, c = idx % kBT, q = q0 + r, k = k0 + c;
    if (q >= Q || k >= Q) continue;
    float v = red[r * kRP + c];
    for (int w = 1; w < kBWarps; ++w) v += red[(w * kBT + r) * kRP + c];
    g.cb[(row0 + q) * Q + k] = v;
  }
}

// 2. pairs: a block a (bc, q-tile qt, k-tile kt <= qt, head group grp).
// Warp w takes the heads h0 + w / 2 + 4 i of the group and the columns
// k = 8 j + 4 (w % 2) + m of the tile (m = lane / 8), so that both warps of
// a head do the same share of a diagonal tile.
__global__ void __launch_bounds__(kBThreads, 1)
ssd_bwd_pairs_kernel(const BwdArgs g) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Q = g.Q, H = g.H, P = g.P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = blockIdx.x % g.n_hg, rest = blockIdx.x / g.n_hg;
  const int bc = rest / g.n_pairs;
  int qt, kt;
  pair_of(rest % g.n_pairs, qt, kt);
  const int q0 = qt * kBT, k0 = kt * kBT;
  const int h0 = grp * g.G, gn = min(g.G, H - h0);
  const size_t row0 = (size_t)bc * Q, ld = (size_t)H * P;
  float* cbt = sm;                             // [kBT][kRP] C.B^T of the tile
  float* csq = cbt + kBT * kRP;                // [kPairHeads][kBT] a_cum, q rows
  float* csk = csq + kPairHeads * kBT;         // a_cum of the k rows
  float* dtk = csk + kPairHeads * kBT;         // dt of the k rows
  float* dcbw = dtk + kPairHeads * kBT;        // [kBWarps][kBT][kDP] dCB a warp
  float* rng = dcbw + kBWarps * kBT * kDP;     // two slices a slot
  load_tile(cbt, kRP, g.cb + (row0 + q0) * Q + k0, Q, kBT, kBT, Q - q0,
            Q - k0, g.vec_q, tid, kBThreads);
  hw::cp_async_commit();
  for (int idx = tid; idx < gn * kBT; idx += kBThreads) {
    const int j = idx / kBT, c = idx % kBT, h = h0 + j;
    const float* cs = g.cs + ((size_t)bc * H + h) * Q;
    csq[idx] = q0 + c < Q ? cs[q0 + c] : 0.f;
    csk[idx] = k0 + c < Q ? cs[k0 + c] : 0.f;
    dtk[idx] = k0 + c < Q ? g.dt[(row0 + k0 + c) * H + h] : 0.f;
  }
  hw::cp_async_wait<0>();
  __syncthreads();

  const int slot = warp >> 1, half = warp & 1;
  const int l = lane & 7, m = lane >> 3;
  const int nh = slot < gn ? (gn - slot + 3) / 4 : 0;   // heads of the warp
  const int n_ps = (P + kBK - 1) / kBK;
  // the two warps of a slot share its ring: dy's rows, then x's rows of
  // both halves; row r of half x is column k = 8 (r / 4) + 4 x + r % 4
  float* wr = rng + slot * 2 * kPairSlice;
  const int pt = half * 32 + lane;
  // the warp's dCB: lane element (i, j) at row l + 8 i, column 4 j + m
  float* dcl = dcbw + warp * kBT * kDP + l * kDP + m;
  float dm[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dm[i][j] = 0.f;
      dcl[8 * i * kDP + 4 * j] = 0.f;
    }
  ring(
      nh * n_ps, [&] { hw::named_sync(1 + slot, 64); },
      [&](int s) {
        const int h = h0 + slot + 4 * (s / n_ps), d0 = (s % n_ps) * kBK;
        float* A = wr + (s & 1) * kPairSlice;
        float* Bt = A + kBT * kNP;
        const size_t off = (size_t)h * P + d0;
        load_tile(A, kNP, g.dy + (row0 + q0) * ld + off, ld, kBT, kBK, Q - q0,
                  P - d0, g.vec_x, pt, 64);
        if (g.vec_x) {
          for (int idx = pt; idx < kBT * (kBK / 4); idx += 64) {
            const int r = idx >> 2, c = (idx & 3) * 4;
            const int k = k0 + 8 * ((r & 31) >> 2) + 4 * (r >> 5) + (r & 3);
            const bool ok = k < Q && d0 + c < P;
            hw::cp_async16(hw::smem_u32(Bt + r * kNP + c),
                           ok ? g.x + (row0 + k) * ld + off + c : g.x, ok);
          }
        } else {
          for (int idx = pt; idx < kBT * kBK; idx += 64) {
            const int r = idx / kBK, c = idx % kBK;
            const int k = k0 + 8 * ((r & 31) >> 2) + 4 * (r >> 5) + (r & 3);
            Bt[r * kNP + c] = (k < Q && d0 + c < P)
                                  ? g.x[(row0 + k) * ld + off + c] : 0.f;
          }
        }
      },
      [&](int s) {
        const float* A = wr + (s & 1) * kPairSlice;
        const float* Bt = A + (kBT + half * kBT / 2) * kNP;
        if (qt == kt) mma_nt<8, true>(dm, A, Bt, lane);
        else mma_nt<8, false>(dm, A, Bt, lane);
        if (s % n_ps != n_ps - 1) return;
        // the head's dM is whole: its terms, then dm is zeroed for the next
        const int j = slot + 4 * (s / n_ps), h = h0 + j;
        const float* cq = csq + j * kBT;
        const float* ck = csk + j * kBT;
        const float* dk = dtk + j * kBT;
        float rs[8], cg[8], ce[8], cqv[8], ckv[8], dkv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 8 * i + 4 * half + m;
          cqv[i] = cq[l + 8 * i];
          ckv[i] = ck[c];
          dkv[i] = dk[c];
          rs[i] = cg[i] = ce[i] = 0.f;
        }
        // u = dM L; dCB += u dt; E = u C.B^T; G = E dt where k < q
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int q = q0 + l + 8 * i;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = 8 * jj + 4 * half + m, k = k0 + c;
            const float u = dm[i][jj] *
                            expf(q < Q && k <= q ? cqv[i] - ckv[jj] : -INFINITY);
            float& d = dcl[8 * i * kDP + 4 * jj];
            d = fmaf(u, dkv[jj], d);
            const float E = u * cbt[(l + 8 * i) * kRP + c];
            const float dg = k < q ? dkv[jj] : 0.f;
            rs[i] = fmaf(E, dg, rs[i]);
            cg[jj] = fmaf(E, dg, cg[jj]);
            ce[jj] += E;
            dm[i][jj] = 0.f;
          }
        }
        // rows: the four lanes m of a row; columns: the eight lanes l
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 8);
          rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 16);
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) {
            cg[i] += __shfl_xor_sync(0xffffffffu, cg[i], o);
            ce[i] += __shfl_xor_sync(0xffffffffu, ce[i], o);
          }
        }
        if (m == 0) {
          float* rowg =
              g.rowg + (((size_t)bc * 2 * g.nt + 2 * kt + half) * H + h) * Q;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (q0 + l + 8 * i < Q) rowg[q0 + l + 8 * i] = rs[i];
        }
        if (l == 0) {
          const size_t o = (((size_t)bc * g.nt + qt) * H + h) * Q;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int k = k0 + 8 * jj + 4 * half + m;
            if (k < Q) {
              g.colg[o + k] = cg[jj];
              g.cole[o + k] = ce[jj];
            }
          }
        }
      });
  // the group's dCB: the four head slots' sums, in slot order
  __syncthreads();
  const int ns = min(4, gn);
  float* out = g.dcbp + ((size_t)bc * g.n_hg + grp) * Q * Q;
  for (int idx = tid; idx < kBT * kBT; idx += kBThreads) {
    const int r = idx / kBT, c = idx % kBT, q = q0 + r, k = k0 + c;
    if (q >= Q || k >= Q) continue;
    // column c is the warp half (c / 4) % 2's column 4 (c / 8) + c % 4
    const float* t = dcbw + ((c >> 2) & 1) * kBT * kDP + r * kDP +
                     4 * (c >> 3) + (c & 3);
    float v = t[0];
    for (int s = 1; s < ns; ++s) v += t[2 * s * kBT * kDP];
    out[(size_t)q * Q + k] = v;
  }
}

// 3. dx: a block a (bc, k-tile, group dg of kBWarps heads); warp w owns head
// 8 dg + w's 64 x 64 tiles of dx, p-tile by p-tile: dsB from a block ring
// (B's slices shared), dw, then M^T dy from the warp's own ring.
__global__ void __launch_bounds__(kBThreads, 1)
ssd_bwd_dx_kernel(const BwdArgs g) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Q = g.Q, H = g.H, P = g.P, N = g.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the heaviest k-tiles (the most q rows below them) first
  const int dg = blockIdx.x % g.n_dg, rest = blockIdx.x / g.n_dg;
  const int bc = rest % g.BC, kt = rest / g.BC, k0 = kt * kBT;
  const int h = dg * kBWarps + warp;
  const bool live = h < H;                      // warp-uniform
  const int Qt = g.nt * kBT;
  const size_t row0 = (size_t)bc * Q, ld = (size_t)H * P;
  float* rng = sm;                              // 2 stages of kDxStage
  float* csS = rng + 2 * kDxStage;              // [kBWarps][Qt] a_cum
  float* dtS = csS + kBWarps * Qt;              // [kBWarps][kBT] dt, k rows
  float* wS = dtS + kBWarps * kBT;              // [kBWarps][kBT] w, k rows
  float* dwS = wS + kBWarps * kBT;              // [kBWarps][kBT] dw, k rows
  for (int idx = tid; idx < kBWarps * Qt; idx += kBThreads) {
    const int j = idx / Qt, q = idx % Qt, hj = dg * kBWarps + j;
    csS[idx] = (hj < H && q < Q) ? g.cs[((size_t)bc * H + hj) * Q + q] : 0.f;
  }
  for (int idx = tid; idx < kBWarps * kBT; idx += kBThreads) {
    const int j = idx / kBT, c = idx % kBT, hj = dg * kBWarps + j;
    dtS[idx] = (hj < H && k0 + c < Q) ? g.dt[(row0 + k0 + c) * H + hj] : 0.f;
    wS[idx] = (hj < H && k0 + c < Q) ? g.w[((size_t)bc * H + hj) * Q + k0 + c]
                                     : 0.f;
    dwS[idx] = 0.f;
  }
  __syncthreads();
  const int l = lane & 7, pg = lane >> 3;
  for (int pt = 0; pt < g.n_pt; ++pt) {
    const int p0 = pt * kBT;
    float acc[8][16];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
    if (g.ds) {
      // dsB = B ds^T over n: B's rows of the tile are the block's, ds_h's
      // rows of the p-tile the warp's
      const float* Bk = g.B + (row0 + k0) * N;
      const float* dsh = g.ds + ((size_t)bc * H + (live ? h : 0)) * P * N +
                         (size_t)p0 * N;
      ring(
          (N + kSK - 1) / kSK, BlockSync(),
          [&](int s) {
            float* st = rng + (s & 1) * kDxStage;
            const int n0 = s * kSK;
            load_swz(st, Bk + n0, N, kBT, Q - k0, N - n0, g.vec_bc, tid,
                     kBThreads);
            if (live)
              load_swz(st + (warp + 1) * kBT * kSK, dsh + n0, N, kBT, P - p0,
                       N - n0, g.vec_ds, lane, 32);
          },
          [&](int s) {
            const float* st = rng + (s & 1) * kDxStage;
            if (live) mma_tn_swz(acc, st, st + (warp + 1) * kBT * kSK, lane);
          });
      // dw += x dsB over the tile's columns (the lanes g of a row), x's
      // tile staged in the ring (two swizzled halves of 32 columns); then
      // the tile is w dsB
      float* xs = rng + warp * 2 * kBT * kSK;
      if (live) {
        const float* xh = g.x + (row0 + k0) * ld + (size_t)h * P + p0;
        load_swz(xs, xh, ld, kBT, Q - k0, P - p0, g.vec_x, lane, 32);
        load_swz(xs + kBT * kSK, xh + kSK, ld, kBT, Q - k0, P - p0 - kSK,
                 g.vec_x, lane, 32);
        hw::cp_async_commit();
        hw::cp_async_wait<0>();
        __syncwarp();
        const float* wk = wS + warp * kBT;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int k = tile_row(l, r);
          float part = 0.f;
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
            const int p = 16 * mm + 4 * pg;
            const float4 v = *reinterpret_cast<const float4*>(
                &xs[(p / kSK) * kBT * kSK + swz(k, p % kSK)]);
            part = fmaf(v.x, acc[r][4 * mm], part);
            part = fmaf(v.y, acc[r][4 * mm + 1], part);
            part = fmaf(v.z, acc[r][4 * mm + 2], part);
            part = fmaf(v.w, acc[r][4 * mm + 3], part);
          }
          part += __shfl_xor_sync(0xffffffffu, part, 8);
          part += __shfl_xor_sync(0xffffffffu, part, 16);
          if (pg == 0) dwS[warp * kBT + k] += part;
#pragma unroll
          for (int c = 0; c < 16; ++c) acc[r][c] *= wk[k];
        }
      }
      __syncthreads();                          // before the ring is reused
    }
    if (g.dy && live) {
      // M^T dy over q >= k, from the warp's own ring of 16-row slices of
      // C.B^T (rows q, the tile's columns k) and of dy; M is formed in place
      // of the C.B^T slice
      const float* cbk = g.cb + row0 * Q + k0;
      const float* dyh = g.dy + row0 * ld + (size_t)h * P + p0;
      const float* csw = csS + warp * Qt;
      const float* dtw = dtS + warp * kBT;
      float* wr = rng + warp * 2 * 2 * kBK * kBT;
      ring(
          (Q - k0 + kBK - 1) / kBK, WarpSync(),
          [&](int s) {
            float* st = wr + (s & 1) * 2 * kBK * kBT;
            const int q = k0 + s * kBK;
            warp_tile(st, kBT, cbk + (size_t)q * Q, Q, Q - q, Q - k0, g.vec_q,
                      lane);
            warp_tile(st + kBK * kBT, kBT, dyh + (size_t)q * ld, ld, Q - q,
                      P - p0, g.vec_x, lane);
          },
          [&](int s) {
            float* st = wr + (s & 1) * 2 * kBK * kBT;
            const int qs = k0 + s * kBK, c4 = 4 * (lane % 16);
            // M[q][k] = C.B^T[q][k] exp(a_cum[q] - a_cum[k]) dt_k, k <= q < Q
            const float4 ck = *reinterpret_cast<const float4*>(&csw[k0 + c4]);
            const float4 dk = *reinterpret_cast<const float4*>(&dtw[c4]);
            const float ckv[4] = {ck.x, ck.y, ck.z, ck.w};
            const float dkv[4] = {dk.x, dk.y, dk.z, dk.w};
#pragma unroll 2
            for (int i = 0; i < kBK / 2; ++i) {
              const int r = lane / 16 + 2 * i, q = qs + r;
              float4* cb = reinterpret_cast<float4*>(&st[r * kBT + c4]);
              const float4 c = *cb;
              const float cbv[4] = {c.x, c.y, c.z, c.w};
              const float cq = csw[q];
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                v[e] = (cbv[e] * expf(k0 + c4 + e <= q && q < Q
                                          ? cq - ckv[e] : -INFINITY)) * dkv[e];
              *cb = make_float4(v[0], v[1], v[2], v[3]);
            }
            __syncwarp();
            mma_tn(acc, st, kBT, st + kBK * kBT, kBT, lane);
          });
    }
    if (live)
      store_tile(g.dx + (row0 + k0) * ld + (size_t)h * P + p0 + 4 * pg, ld, acc,
                 l, Q - k0, P - p0 - 4 * pg, g.vec_x);
    __syncthreads();                            // before the ring is reused
  }
  if (live) {
    __syncwarp();
    for (int c = lane; c < kBT && k0 + c < Q; c += 32)
      g.dw[((size_t)bc * H + h) * Q + k0 + c] = dwS[warp * kBT + c];
  }
}

// 4. state: a block a (bc, k-tile, n-tile, split sp of SG heads); warp w
// sums over p for the split's heads w, w + 8, ...: x's slice is transposed
// and scaled by w once into (w x)^T, then multiplied by ds's slice.
__global__ void __launch_bounds__(kBThreads, 1)
ssd_bwd_state_kernel(const BwdArgs g) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Q = g.Q, H = g.H, P = g.P, N = g.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int rest = blockIdx.x;
  const int sp = rest % g.n_sp;
  rest /= g.n_sp;
  const int nti = rest % g.n_nt;
  rest /= g.n_nt;
  const int kt = rest % g.nt, bc = rest / g.nt;
  const int k0 = kt * kBT, n0 = nti * kBT;
  const int hs = sp * g.SG, sn = min(g.SG, H - hs);
  const int nh = warp < sn ? (sn - warp + kBWarps - 1) / kBWarps : 0;
  const int n_ps = (P + kBK - 1) / kBK;
  const size_t row0 = (size_t)bc * Q, ld = (size_t)H * P;
  float* wS = sm + kBWarps * kStateWarp;        // [SG][kBT] w of the k rows
  for (int idx = tid; idx < sn * kBT; idx += kBThreads) {
    const int j = idx / kBT, c = idx % kBT;
    wS[idx] = k0 + c < Q ? g.w[((size_t)bc * H + hs + j) * Q + k0 + c] : 0.f;
  }
  __syncthreads();
  float* wr = sm + warp * kStateWarp;
  float* xt = wr + 2 * kStateSlice;             // [kBK][kBT] (w x)^T
  const int l = lane & 7, pg = lane >> 3;
  float acc[8][16];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
  ring(
      nh * n_ps, WarpSync(),
      [&](int s) {
        const int h = hs + warp + kBWarps * (s / n_ps), d0 = (s % n_ps) * kBK;
        float* xs = wr + (s & 1) * kStateSlice;
        load_tile(xs, kNP, g.x + (row0 + k0) * ld + (size_t)h * P + d0, ld, kBT,
                  kBK, Q - k0, P - d0, g.vec_x, lane, 32);
        warp_tile(xs + kBT * kNP, kBT,
                  g.ds + (((size_t)bc * H + h) * P + d0) * N + n0, N, P - d0,
                  N - n0, g.vec_ds, lane);
      },
      [&](int s) {
        const int j = warp + kBWarps * (s / n_ps);
        const float* xs = wr + (s & 1) * kStateSlice;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = lane + 32 * e;
          const float wk = wS[j * kBT + k];
#pragma unroll
          for (int c = 0; c < kBK / 4; ++c) {
            const float4 v = *reinterpret_cast<const float4*>(&xs[k * kNP + 4 * c]);
            xt[(4 * c) * kBT + k] = wk * v.x;
            xt[(4 * c + 1) * kBT + k] = wk * v.y;
            xt[(4 * c + 2) * kBT + k] = wk * v.z;
            xt[(4 * c + 3) * kBT + k] = wk * v.w;
          }
        }
        __syncwarp();
        mma_tn(acc, xt, kBT, xs + kBT * kNP, kBT, lane);
      });
  // the split's sum: the warps' tiles in warp order
  __syncthreads();
  float* red = sm;                              // [kBWarps][kBT][kRP]
  store_tile(red + warp * kBT * kRP + 4 * pg, kRP, acc, l, kBT, kBT - 4 * pg, 1);
  __syncthreads();
  float* out = g.sp + (((size_t)bc * g.n_sp + sp) * Q + k0) * N + n0;
  for (int idx = tid; idx < kBT * kBT; idx += kBThreads) {
    const int r = idx / kBT, c = idx % kBT;
    if (k0 + r >= Q || n0 + c >= N) continue;
    float v = red[r * kRP + c];
    for (int w = 1; w < kBWarps; ++w) v += red[(w * kBT + r) * kRP + c];
    out[(size_t)r * N + c] = v;
  }
}

// 5. dsum (with dy): a block a (bc, pair): the tile of dCB, the head
// groups' partials summed in group order, into cb (C.B^T is read no more)
// and, transposed through shared memory, into dcbt.
__global__ void __launch_bounds__(kBThreads)
ssd_bwd_dsum_kernel(const BwdArgs g) {
  extern __shared__ float4 smem4[];
  float* t = reinterpret_cast<float*>(smem4);   // [kBT][kBT + 1]
  const int Q = g.Q, tid = threadIdx.x;
  const int bc = blockIdx.x / g.n_pairs;
  int qt, kt;
  pair_of(blockIdx.x % g.n_pairs, qt, kt);
  const int q0 = qt * kBT, k0 = kt * kBT;
  const size_t qq = (size_t)Q * Q;
  const float* part = g.dcbp + (size_t)bc * g.n_hg * qq;
  float* dcb = g.cb + (size_t)bc * qq;
  float* dcbt = g.dcbt + (size_t)bc * qq;
#pragma unroll
  for (int idx = tid; idx < kBT * kBT / 4; idx += kBThreads) {
    const int r = idx / (kBT / 4), c = (idx % (kBT / 4)) * 4;
    const int q = q0 + r, k = k0 + c;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (q < Q && k < Q) {
      const size_t o = (size_t)q * Q + k;
      if (g.vec_q) {                            // Q % 4 == 0: k + 3 < Q
        float4 a = *reinterpret_cast<const float4*>(part + o);
        for (int gi = 1; gi < g.n_hg; ++gi) {
          const float4 b = *reinterpret_cast<const float4*>(part + gi * qq + o);
          a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
        }
        *reinterpret_cast<float4*>(dcb + o) = a;
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      } else {
        for (int e = 0; e < 4 && k + e < Q; ++e) {
          v[e] = part[o + e];
          for (int gi = 1; gi < g.n_hg; ++gi) v[e] += part[gi * qq + o + e];
          dcb[o + e] = v[e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) t[r * (kBT + 1) + c + e] = v[e];
  }
  __syncthreads();
  for (int idx = tid; idx < kBT * kBT; idx += kBThreads) {
    const int c = idx / kBT, r = idx % kBT, q = q0 + r, k = k0 + c;
    if (q < Q && k < Q) dcbt[(size_t)k * Q + q] = t[r * (kBT + 1) + c];
  }
}

// 6. bc: a block a (bc, dC or dB, row tile rt, n-tile); warp w sums its
// eighth of the depth's 16-deep slices, 8 x 16 a lane, from a ring of two
// stages: dC's rows q over k < min(Q, q0 + 64) from dCB^T, dB's rows
// k over q >= k0 from dCB; then the block sums the warps in order, and dB
// adds the state's partials in split order.
__global__ void __launch_bounds__(kBcWarps * 32)
ssd_bwd_bc_kernel(const BwdArgs g) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Q = g.Q, N = g.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int rest = blockIdx.x;
  const int nti = rest % g.n_nt;
  rest /= g.n_nt;
  const int rt = rest % g.nt;
  rest /= g.nt;
  const bool is_db = rest % 2;
  const int bc = rest / 2;
  const int r0 = rt * kBT, n0 = nti * kBT;
  const size_t row0 = (size_t)bc * Q;
  const int l = lane & 7, pg = lane >> 3;
  float acc[8][16];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
  if (g.dy) {
    const int d_lo = is_db ? r0 : 0, d_hi = is_db ? Q : min(Q, r0 + kBT);
    const int n_sl = (d_hi - d_lo + kBK - 1) / kBK;
    const int s_lo = warp * n_sl / kBcWarps;
    const int s_hi = (warp + 1) * n_sl / kBcWarps;
    // row d of A is dCB[d][r0 ..] (dB) or dCB^T[d][r0 ..] (dC); of src,
    // C[d][n0 ..] or B[d][n0 ..]
    const float* A = (is_db ? g.cb : g.dcbt) + row0 * Q + r0;
    const float* src = (is_db ? g.C : g.B) + row0 * N + n0;
    float* wr = sm + warp * kBcWarp;
    ring(
        s_hi - s_lo, WarpSync(),
        [&](int s) {
          const int d0 = d_lo + (s_lo + s) * kBK;
          float* st = wr + (s & 1) * 2 * kBK * kBT;
          warp_tile(st, kBT, A + (size_t)d0 * Q, Q, d_hi - d0, Q - r0,
                    g.vec_q, lane);
          warp_tile(st + kBK * kBT, kBT, src + (size_t)d0 * N, N, d_hi - d0,
                    N - n0, g.vec_bc, lane);
        },
        [&](int s) {
          const float* st = wr + (s & 1) * 2 * kBK * kBT;
          mma_tn(acc, st, kBT, st + kBK * kBT, kBT, lane);
        });
  }
  __syncthreads();                              // every ring is done
  float* red = sm;                              // [kBcWarps][kBT][kRP]
  store_tile(red + warp * kBT * kRP + 4 * pg, kRP, acc, l, kBT, kBT - 4 * pg, 1);
  __syncthreads();
  // the thread's elements idx = tid + 256 e of the tile
  constexpr int kE = kBT * kBT / (kBcWarps * 32);
  float v[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int idx = tid + e * kBcWarps * 32, r = idx / kBT, c = idx % kBT;
    v[e] = red[r * kRP + c];
    for (int w = 1; w < kBcWarps; ++w) v[e] += red[(w * kBT + r) * kRP + c];
  }
  if (is_db && g.ds) {
    const float* spb = g.sp + ((size_t)bc * g.n_sp * Q + r0) * N + n0;
    for (int s = 0; s < g.n_sp; ++s) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int idx = tid + e * kBcWarps * 32, r = idx / kBT, c = idx % kBT;
        if (r0 + r < Q && n0 + c < N) v[e] += spb[((size_t)s * Q + r) * N + c];
      }
    }
  }
  float* out = (is_db ? g.dB : g.dC) + (row0 + r0) * N + n0;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int idx = tid + e * kBcWarps * 32, r = idx / kBT, c = idx % kBT;
    if (r0 + r < Q && n0 + c < N) out[(size_t)r * N + c] = v[e];
  }
}

// 7. out: a block a (bc, h).  A thread a step at a time, so that the
// partials' reads are coalesced: ddt, and dacum into shared memory (f64);
// then one warp adds the state's decay and scans dacum in reverse (f64)
// over its lanes' segments into da.
__global__ void __launch_bounds__(kBThreads)
ssd_bwd_out_kernel(const BwdArgs g) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int cell = blockIdx.x;
  const int Q = g.Q, H = g.H, nt = g.nt;
  const int bc = cell / H, h = cell % H;
  const size_t row0 = (size_t)bc * Q;
  const float* cs = g.cs + (size_t)cell * Q;
  const float* w = g.w + (size_t)cell * Q;
  const float* dw = g.dw + (size_t)cell * Q;
  const size_t tile = (size_t)H * Q;            // stride of a partial's tile
  const float* rowg = g.rowg + (size_t)bc * 2 * nt * tile + (size_t)h * Q;
  const float* colg = g.colg + (size_t)bc * nt * tile + (size_t)h * Q;
  const float* cole = g.cole + (size_t)bc * nt * tile + (size_t)h * Q;
  double* dac = reinterpret_cast<double*>(smem4);     // [Q]
  double* tpart = dac + Q;                            // [kBThreads]
  const float last = cs[Q - 1];
  // the state's decay: T_k = dw_k w_k, k < Q - 1, and their sum
  double tp = 0.0;
  for (int q = tid; q < Q; q += kBThreads) {
    const int ti = q / kBT;
    float ve = 0.f, va = 0.f;
    if (g.dy) {
      for (int t = ti; t < nt; ++t) ve += cole[t * tile + q];
      for (int t = 0; t < 2 * (ti + 1); ++t) va += rowg[t * tile + q];
      for (int t = ti; t < nt; ++t) va -= colg[t * tile + q];
    }
    g.ddt[(row0 + q) * H + h] = fmaf(dw[q], expf(last - cs[q]), ve);
    const double T = (double)(dw[q] * w[q]);
    if (q < Q - 1) tp += T;
    dac[q] = q < Q - 1 ? (double)va - T : (double)va;
  }
  tpart[tid] = tp;
  __syncthreads();
  if (tid >= 32) return;
  double tsum = 0.0;
  for (int i = lane; i < kBThreads; i += 32) tsum += tpart[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
  if (lane == 0) dac[Q - 1] += tsum;
  __syncwarp();
  int lo, hi;
  lane_segment(Q, lane, lo, hi);
  double seg = 0.0;
  for (int q = lo; q < hi; ++q) seg += dac[q];
  double incl = seg;                            // sum over lanes >= lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += v;
  }
  double acc = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) acc = 0.0;
  for (int q = hi - 1; q >= lo; --q) {
    acc += dac[q];
    g.da[(row0 + q) * H + h] = (float)acc;
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (set once a size).
template <class K>
cudaError_t allow_smem(K* kernel, size_t bytes, size_t& configured) {
  if (bytes <= configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) configured = bytes;
  return e;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// x, dy, dx: [BC, Q, H, P]; dt, a, ddt, da: [BC, Q, H]; B, C, dB, dC:
// [BC, Q, N]; ds: [BC, H, P, N]; dy or ds may be null (zero).  scratch:
// scratch_floats floats, at least BC (3 H Q + (2 + n_hg) Q^2 + 4 ceil(Q/64)
// H Q + n_sp Q N), n_hg = ceil(H / kPairHeads), n_sp = ceil(H /
// kSplitHeads) (ops.ssd_bwd_scratch_floats).  All f32, contiguous.  Returns
// the CUDA error code of the launches (0 = launched).
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
  g.nt = cdiv(Q, kBT);
  g.n_pairs = g.nt * (g.nt + 1) / 2;
  g.n_pt = cdiv(P, kBT);
  g.n_nt = cdiv(N, kBT);
  g.n_hg = cdiv(H, kPairHeads);
  g.G = cdiv(H, g.n_hg);
  g.n_dg = cdiv(H, kBWarps);
  g.n_sp = cdiv(H, kSplitHeads);
  g.SG = cdiv(H, g.n_sp);
  const long long hq = (long long)BC * H * Q;
  const long long qq = (long long)BC * Q * Q;
  const long long sq = (long long)BC * g.n_sp * Q * N;
  if (scratch_floats < 3 * hq + (2 + g.n_hg) * qq + 4 * g.nt * hq + sq)
    return (int)cudaErrorInvalidValue;
  float* s = static_cast<float*>(scratch);
  g.cs = s;
  g.w = g.cs + hq;
  g.dw = g.w + hq;
  g.cb = g.dw + hq;
  g.dcbt = g.cb + qq;
  g.dcbp = g.dcbt + qq;
  g.rowg = g.dcbp + g.n_hg * qq;
  g.colg = g.rowg + 2 * g.nt * hq;
  g.cole = g.colg + g.nt * hq;
  g.sp = g.cole + g.nt * hq;
  g.vec_x = (P % 4 == 0) &&
            (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx) % 16 == 0);
  g.vec_bc = (N % 4 == 0) && (((uintptr_t)B | (uintptr_t)C) % 16 == 0);
  g.vec_ds = (N % 4 == 0) && ((uintptr_t)ds % 16 == 0);
  g.vec_q = (Q % 4 == 0) && ((uintptr_t)scratch % 16 == 0);
  const long long cells = (long long)BC * H;
  g.n_steps = (int)((cells + kBWarps - 1) / kBWarps);
  const long long pairs = (long long)BC * g.n_pairs;
  const long long blocks[6] = {
      g.n_steps + (dy ? pairs : 0), pairs * g.n_hg,
      (long long)BC * g.nt * g.n_dg, (long long)BC * g.nt * g.n_nt * g.n_sp,
      (long long)BC * 2 * g.nt * g.n_nt, cells};
  for (long long b : blocks)
    if (b > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t f = sizeof(float);
  const size_t steps_smem = (size_t)2 * kBWarps * (Q + 1) * f;
  size_t smem[6] = {
      (size_t)(dy ? kBWarps * 2 * 2 * kBT * kNP : 0) * f,
      (size_t)(kBT * kRP + 3 * kPairHeads * kBT + kBWarps * kBT * kDP +
               kBWarps / 2 * 2 * kPairSlice) * f,
      (size_t)(2 * kDxStage + kBWarps * (g.nt * kBT + 3 * kBT)) * f,
      (size_t)(kBWarps * kStateWarp + g.SG * kBT) * f,
      (size_t)kBcWarps * (kBcWarp > kBT * kRP ? kBcWarp : kBT * kRP) * f,
      (size_t)(Q + kBThreads) * sizeof(double)};
  static size_t configured[6] = {0, 0, 0, 0, 0, 0};
  cudaError_t e;
  if (smem[0] < steps_smem) smem[0] = steps_smem;
  if ((e = allow_smem(ssd_bwd_prep_kernel, smem[0], configured[0])) ||
      (e = allow_smem(ssd_bwd_pairs_kernel, smem[1], configured[1])) ||
      (e = allow_smem(ssd_bwd_dx_kernel, smem[2], configured[2])) ||
      (e = allow_smem(ssd_bwd_state_kernel, smem[3], configured[3])) ||
      (e = allow_smem(ssd_bwd_bc_kernel, smem[4], configured[4])) ||
      (e = allow_smem(ssd_bwd_out_kernel, smem[5], configured[5])))
    return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ssd_bwd_prep_kernel<<<(unsigned)blocks[0], kBThreads, smem[0], st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (dy) {
    ssd_bwd_pairs_kernel<<<(unsigned)blocks[1], kBThreads, smem[1], st>>>(g);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  ssd_bwd_dx_kernel<<<(unsigned)blocks[2], kBThreads, smem[2], st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (ds) {
    ssd_bwd_state_kernel<<<(unsigned)blocks[3], kBThreads, smem[3], st>>>(g);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (dy) {
    ssd_bwd_dsum_kernel<<<(unsigned)pairs, kBThreads, kBT * (kBT + 1) * f, st>>>(g);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  ssd_bwd_bc_kernel<<<(unsigned)blocks[4], kBcWarps * 32, smem[4], st>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_out_kernel<<<(unsigned)blocks[5], kBThreads, smem[5], st>>>(g);
  return (int)cudaGetLastError();
}
