// Mamba2 SSD within a chunk, for Hopper: f32 arithmetic on the FMA pipes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (_ssd_chunk_kernel /
// ssd_chunk_kernel).  For each cell (one batch-chunk bc and one head h),
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
