// Grouped (ragged) matmul for the MoE expert FFN, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul.py (_gmm_kernel /
// grouped_matmul_kernel): lhs [T,D] has its rows sorted by expert, offsets
// [E+1] (int32) give expert e the rows [offsets[e], offsets[e+1]), rhs
// [E,D,F] holds one matrix per expert, and out[rows of e] = lhs[rows] @ rhs[e]
// with an f32 accumulator.  Rows that no group covers (before offsets[0] or
// from offsets[E] on) come out exactly 0.  Offsets are clamped into [0, T]
// and made non-decreasing, so a malformed offsets vector cannot index out of
// bounds.
//
// Row tiles: the TPU kernel's grid walks every (row tile, expert) pair; here
// each block owns one tile of one group, cut at the group's own start, so no
// block loops over all E.  The two uncovered ranges are groups of their own
// whose tiles only write zeros.
//
// bf16, prefill (T > 16 E).  Bound: [32768,1024]x[32,1024,512] moves 134 MB
// (0.040 ms at 3.35 TB/s) and does 34.4 GFLOP (0.035 ms at 989 TFLOP/s), so
// bytes and operations are close.  Design: 128 x 256 output tiles on the
// tensor cores (a 128 x 128 tile needs more L2 bandwidth per flop than the
// card has).  288 threads: one producer thread issues TMA loads (128-byte
// swizzle) of 64-deep K slices into a 4-stage ring in dynamic shared
// memory, 16 KB of A and 32 KB of B a stage, with mbarriers for full and
// empty stages; two consumer warpgroups each issue wgmma m64n256k16 on 64
// rows of A (K-major) and the whole B slice (rhs[e] is [D,F] row-major, so
// B is MN-major and wgmma's transpose bit reads it in place), with f32
// accumulators in registers and one wgmma group kept in flight.  The
// producer is one warp, not a warpgroup, so every thread may hold the 128
// accumulator registers without setmaxnreg.  Block (x, y) takes column
// tile x of row tile y: column tiles vary fastest, so the blocks that share
// an A tile run together and A comes from device memory once.  Warp 0 finds
// the block's tile with two scans over the offsets (a running max gives
// each group's end, a sum the first tile of each group).  An A tile may run
// past its group's last row into the next group's rows: the epilogue
// stores only rows of [r0, r1), and TMA fills rows >= T (and K or F past
// the edge) with zeros.  Epilogue: f32 -> bf16 once (round to nearest
// even), staged in the ring once both warpgroups are done with it, then
// 16-byte row stores.
//
// bf16, decode (T <= 16 E: a few rows per group).  Bound: the expert
// weights, 33.5 MB at [64,1024]x[32,1024,512] -> 0.0094 ms.  A 64-row wgmma
// tile would compute mostly padding, so 16-row tiles go through mma.sync
// m16n8k16: a 128-thread block per (group, 64 columns) streams its expert's
// [D,64] panel through a 6-stage ring of cp.async 16-byte copies (9 KB of B
// a stage, 45 KB in flight) and feeds B with ldmatrix.trans.  The expert is
// known from blockIdx, so the first slices are requested before the
// offsets arrive.  At granite's decode shape each group holds at most 8
// rows, so each weight byte is read once per call.  No tensor map on this
// path: decode is host-bound, and encoding one per call would add host
// time.
//
// The bf16 paths need D % 8 == 0 and F % 8 == 0 (TMA's 16-byte strides and
// the 16-byte copies); the wrapper raises otherwise (ops.py).  f32: a plain
// shared-memory tiled FMA loop (BM x 64 output tile, 16-deep K slices, 256
// threads; BM = 16 at decode, 64 otherwise), so f32 inputs stay exact f32.
//
// dX = dY W^T per group (the backward, grouped_matmul_dx_launch) runs the
// same three kernels with B's layout as a template argument KB: the kernels
// compute out [T, N] = lhs [T, K] B_e, where B_e is rhs[e] of rhs [E, K, N]
// (KB = 0, the forward: K = D, N = F) or rhs[e]^T of rhs [E, N, K] read in
// place (KB = 1, dX: lhs = dY [T, F], rhs = W [E, D, F], K = F, N = D).
// W_e [D, F] row-major holds each output column's K elements contiguously,
// which is wgmma's K-major B: a TMA box of 64 K elements (the 128-byte
// swizzle's row) by 256 N rows, one load a stage in place of four, and the
// descriptor of A's form; for mma.sync it is the native B layout, loaded by
// ldmatrix without .trans from [64 N rows x 64 K] panels.  No copy of W^T
// is made.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxExperts = 1024;

// Which tile of which group tile index `tile` names, found by warp 0 and
// written to s_tile as {group, r0, r1}.  Group g spans [lo, hi): g = 0 is the
// uncovered head, g = 1..E are the experts, g = E + 1 is the uncovered tail;
// hi is the running maximum of the clamped offsets (so lo of g is hi of
// g - 1), and group -1 means there is no such tile.  32 groups at a time:
// a max-scan gives hi, a sum-scan the first tile of each group.
template <int BM>
__device__ void find_tile(const int* s_off, int E, int Tn, int tile,
                          int* s_tile) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) s_tile[0] = -1;
  __syncwarp();
  int carry_hi = 0, carry_t = 0;
  for (int base = 0; base <= E + 1; base += 32) {
    const int g = base + lane;
    int hi = g <= E ? min(max(s_off[g], 0), Tn) : Tn;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(0xffffffffu, hi, d);
      if (lane >= d) hi = max(hi, o);
    }
    hi = max(hi, carry_hi);
    int lo = __shfl_up_sync(0xffffffffu, hi, 1);
    if (lane == 0) lo = carry_hi;
    const int nt = (hi - lo + BM - 1) / BM;
    int incl = nt;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    const int start = carry_t + incl - nt;
    if (g <= E + 1 && tile >= start && tile < start + nt) {
      const int r0 = lo + (tile - start) * BM;
      s_tile[0] = g;
      s_tile[1] = r0;
      s_tile[2] = min(hi, r0 + BM);
    }
    carry_hi = __shfl_sync(0xffffffffu, hi, 31);
    carry_t += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// Stages offsets and finds the tile of row-tile index `tile`; every thread
// gets the result.
template <int BM>
__device__ __forceinline__ void block_tile(const int* offsets, int* s_off,
                                           int* s_tile, int E, int Tn,
                                           int tile, int nthreads, int* group,
                                           int* r0, int* r1) {
  for (int i = threadIdx.x; i <= E; i += nthreads) s_off[i] = offsets[i];
  __syncthreads();
  if (threadIdx.x < 32) find_tile<BM>(s_off, E, Tn, tile, s_tile);
  __syncthreads();
  *group = s_tile[0];
  *r0 = s_tile[1];
  *r1 = s_tile[2];
}

// Zeros of rows [r0, r1) and columns [n0, n0 + bn) of a bf16 output, in
// 16-byte stores (F % 8 == 0).
__device__ __forceinline__ void zero_tile_bf16(__nv_bfloat16* out, int r0,
                                               int r1, int n0, int bn, int F,
                                               int nthreads) {
  const int chunks = bn / 8;
  for (int c = threadIdx.x; c < (r1 - r0) * chunks; c += nthreads) {
    const int row = r0 + c / chunks, col = n0 + (c % chunks) * 8;
    if (col < F)
      *reinterpret_cast<uint4*>(out + (size_t)row * F + col) =
          make_uint4(0, 0, 0, 0);
  }
}

// ------------------------------------------------------------ f32 (FMA)
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;

template <typename T, int BM, int KB>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
           const int* __restrict__ offsets, T* __restrict__ out, int Tn,
           int K, int N, int E) {
  constexpr int RM = BM / 16;  // output rows per thread
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN + 1];   // padded: the K-major fill runs down k
  __shared__ int s_tile[3];

  int group, r0, r1;
  block_tile<BM>(offsets, s_off, s_tile, E, Tn, blockIdx.x, NT, &group, &r0,
                 &r1);
  if (group < 0) return;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (group >= 1 && group <= E) {
    const T* W = rhs + (size_t)(group - 1) * K * N;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int idx = threadIdx.x; idx < BM * BK; idx += NT) {
        const int r = idx / BK, kk = idx % BK;
        const int row = r0 + r, kx = k0 + kk;
        As[kk][r] = (row < r1 && kx < K) ? rt::to_f(lhs[(size_t)row * K + kx]) : 0.f;
      }
      // neighbouring threads read neighbouring elements of W in both layouts
      for (int idx = threadIdx.x; idx < BK * BN; idx += NT) {
        const int kk = KB ? idx % BK : idx / BN, n = KB ? idx / BK : idx % BN;
        const int kx = k0 + kk, col = n0 + n;
        Bs[kk][n] = (kx < K && col < N)
                        ? rt::to_f(W[KB ? (size_t)col * K + kx : (size_t)kx * N + col])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[RM], bv[4];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= r1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[(size_t)row * N + col] = rt::from_f<T>(acc[i][j]);
    }
  }
}

// ------------------------------------------------- bf16 prefill (wgmma)
constexpr int WM = 128, WN = 256, WK = 64, WSTAGES = 4;
// Two consumer warpgroups and one producer warp: 288 threads, so every
// thread may keep the registers the accumulators need without setmaxnreg.
constexpr int W_THREADS = 288;
constexpr int A_BYTES = WM * WK * 2;           // 16 KB
constexpr int B_HALF = WK * 64 * 2;            // one 64-column span, 8 KB
constexpr int B_SPANS = WN / 64;               // (K-major B: one 32 KB box)
constexpr int STAGE_BYTES = A_BYTES + B_SPANS * B_HALF;
constexpr int EPI_LD = WN + 8;                 // staged row, bf16 elements
constexpr int EPI_BYTES = 64 * EPI_LD * 2;     // per consumer warpgroup
constexpr int W_SMEM = 1024 + WSTAGES * STAGE_BYTES + 2 * WSTAGES * 8;
static_assert(2 * EPI_BYTES <= WSTAGES * STAGE_BYTES,
              "the epilogue is staged in the ring");

// KB = 0: B MN-major, rhs [E, K, N] in 64-column spans; KB = 1: B K-major,
// rhs [E, N, K] in one box of 256 N rows by 64 K a stage.
template <int KB>
__global__ void __launch_bounds__(W_THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const int* __restrict__ offsets,
                 __nv_bfloat16* __restrict__ out, int Tn, int K, int N,
                 int E) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ int s_tile[3];

  int group, r0, r1;
  // column tiles vary fastest, so the blocks that share an A tile run together
  // and A comes from device memory once
  block_tile<WM>(offsets, s_off, s_tile, E, Tn, blockIdx.y, W_THREADS, &group,
                 &r0, &r1);
  if (group < 0) return;
  const int n0 = blockIdx.x * WN;
  if (group == 0 || group == E + 1) {
    zero_tile_bf16(out, r0, r1, n0, WN, N, W_THREADS);
    return;
  }

  // Swizzled tiles need 1024-byte alignment.
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + WSTAGES * STAGE_BYTES;
  auto sa = [&](int s) { return base + s * STAGE_BYTES; };
  auto sb = [&](int s) { return base + s * STAGE_BYTES + A_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (WSTAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      hw::mbar_init(full(s), 1);
      hw::mbar_init(empty(s), 2);    // one arrival per consumer warpgroup
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int nk = (K + WK - 1) / WK;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps up to WSTAGES slices in flight
    if (threadIdx.x == 256) {
      const int e = group - 1;
      for (int it = 0; it < nk; ++it) {
        const int s = it % WSTAGES;
        if (it >= WSTAGES) hw::mbar_wait(empty(s), ((it / WSTAGES) - 1) & 1);
        hw::mbar_expect_tx(full(s), STAGE_BYTES);
        hw::tma_load_2d(sa(s), &map_a, full(s), it * WK, r0);
        if (KB) {
          hw::tma_load_3d(sb(s), &map_b, full(s), it * WK, n0, e);
        } else {
#pragma unroll
          for (int h = 0; h < B_SPANS; ++h)
            hw::tma_load_3d(sb(s) + h * B_HALF, &map_b, full(s), n0 + 64 * h,
                            it * WK, e);
        }
      }
    }
  } else {
    // nk >= 1; the first wgmma overwrites acc (no zero fill, which would
    // put non-wgmma writes of the accumulators into the wgmma pipeline)
    float acc[WN / 2];
    for (int it = 0; it < nk; ++it) {
      const int s = it % WSTAGES;
      hw::mbar_wait(full(s), (it / WSTAGES) & 1);
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) {
        // A: rows 64 wg.., K-major, 128-byte rows, 8-row groups 1024 B
        // apart; a k16 step is 32 bytes along the row.  B MN-major: the
        // 64-column spans 8 KB apart, 8-row K groups 1024 B apart; a k16
        // step is 16 rows.  B K-major: A's form over 256 N rows.
        const uint64_t da = hw::wgmma_desc(sa(s) + wg * 8192 + kk * 32, 16,
                                           1024);
        const uint64_t db =
            KB ? hw::wgmma_desc(sb(s) + kk * 32, 16, 1024)
               : hw::wgmma_desc(sb(s) + kk * 2048, B_HALF, 1024);
        hw::wgmma_ss<0, KB ? 0 : 1>(acc, da, db, it > 0 || kk > 0);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<1>();                // slice it - 1 is done with smem
      hw::fence_regs(acc);
      if (it > 0 && threadIdx.x % 128 == 0)
        hw::mbar_arrive(empty((it - 1) % WSTAGES));
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);

    // epilogue: f32 -> bf16 into this warpgroup's staging rows (in the
    // ring, once both warpgroups are done with it), then 16-byte stores of
    // the rows that belong to the group
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(gbase)
                         + wg * 64 * EPI_LD;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int row = 16 * warp + g, col = 8 * j + 2 * q;
      *reinterpret_cast<uint32_t*>(stg + row * EPI_LD + col) =
          hw::pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(stg + (row + 8) * EPI_LD + col) =
          hw::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    for (int c = t; c < 64 * (WN / 8); c += 128) {
      const int r = c / (WN / 8), cc = (c % (WN / 8)) * 8;
      const int row = r0 + 64 * wg + r, col = n0 + cc;
      if (row < r1 && col < N)
        *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
            *reinterpret_cast<const uint4*>(stg + r * EPI_LD + cc);
    }
  }
}

// ---------------------------------------------- bf16 decode (mma.sync)
constexpr int DM = 16, DN = 64, DK = 64, DSTAGES = 6, D_THREADS = 128;
// padded rows (bf16 elements); a B row is 64 columns (KB = 0) or 64 K (1)
constexpr int LDA = DK + 8, LDB = DN + 8;
static_assert(DN == DK, "both B layouts fill the same stage");
constexpr int DA_BYTES = DM * LDA * 2, DB_BYTES = DK * LDB * 2;
constexpr int D_STAGE = DA_BYTES + DB_BYTES;
constexpr int D_SMEM = DSTAGES * D_STAGE;

// One block per (group, 64 columns): the expert is known from blockIdx, so
// the first weight slices are requested before the offsets arrive.  The
// group's rows go through in 16-row tiles (at decode there is one).  A
// stage of B is [64 K rows x 64 columns] of rhs[e] (KB = 0, read by
// ldmatrix.trans) or [64 N rows x 64 K] of rhs[e] [N, K] (KB = 1, read by
// ldmatrix: mma.sync's own B layout).
template <int KB>
__global__ void __launch_bounds__(D_THREADS)
gmm_mma_kernel(const __nv_bfloat16* __restrict__ lhs,
               const __nv_bfloat16* __restrict__ rhs,
               const int* __restrict__ offsets,
               __nv_bfloat16* __restrict__ out, int Tn, int K, int N, int E) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int s_range[2];
  const int grp = blockIdx.x;         // 0 head, 1..E experts, E + 1 tail
  const int n0 = blockIdx.y * DN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t base = hw::smem_u32(smem_raw);
  const int nk = (K + DK - 1) / DK;
  const bool expert = grp >= 1 && grp <= E;
  const __nv_bfloat16* W = rhs + (size_t)(expert ? grp - 1 : 0) * K * N;

  auto load_b = [&](int slice, int st) {
    const uint32_t b_s = base + st * D_STAGE + DA_BYTES;
#pragma unroll
    for (int i = 0; i < DK * DN / 8 / D_THREADS; ++i) {
      const int idx = tid + D_THREADS * i;
      // stage row sr, 16-byte chunk c of it: a K row (KB = 0) or an N row
      const int sr = idx / 8, c = (idx % 8) * 8;
      const int k = slice * DK + (KB ? c : sr), n = n0 + (KB ? sr : c);
      const bool ok = k < K && n < N;
      hw::cp_async16(b_s + (sr * LDB + c) * 2,
                     ok ? W + (KB ? (size_t)n * K + k : (size_t)k * N + n) : W,
                     ok);
    }
  };
  auto load_a = [&](int slice, int st, int r0) {
    const uint32_t a_s = base + st * D_STAGE;
    for (int idx = tid; idx < DM * DK / 8; idx += D_THREADS) {
      const int r = idx / (DK / 8), c = (idx % (DK / 8)) * 8;
      const int row = r0 + r, k = slice * DK + c;
      const bool ok = row < Tn && k < K;
      hw::cp_async16(a_s + (r * LDA + c) * 2,
                     ok ? lhs + (size_t)row * K + k : lhs, ok);
    }
  };

  // weights first: group s holds weight slice s
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (expert && s < nk) load_b(s, s);
    hw::cp_async_commit();
  }
  // the group's rows [lo, hi): hi is the running maximum of the clamped
  // offsets through this group, lo the one through the group before
  if (warp == 0) {
    const int last = min(grp, E);
    int m_lo = 0, m_hi = 0;
    for (int b0 = 0; b0 <= last; b0 += 32) {
      const int i = b0 + lane;
      const int c = i <= last ? min(max(offsets[i], 0), Tn) : 0;
      m_hi = max(m_hi, __reduce_max_sync(0xffffffffu, c));
      m_lo = max(m_lo, __reduce_max_sync(0xffffffffu, i < grp ? c : 0));
    }
    if (lane == 0) {
      s_range[0] = m_lo;
      s_range[1] = grp == E + 1 ? Tn : m_hi;
    }
  }
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  if (!expert || lo >= hi) {
    if (!expert) zero_tile_bf16(out, lo, hi, n0, DN, N, D_THREADS);
    hw::cp_async_wait<0>();
    return;
  }

  const int g = lane / 4, q = lane % 4;
  for (int r0 = lo; r0 < hi; r0 += DM) {
    if (r0 == lo) {                   // the weights are already in flight
      for (int s = 0; s < DSTAGES - 1; ++s)
        if (s < nk) load_a(s, s, r0);
      hw::cp_async_commit();
      hw::cp_async_wait<0>();
    } else {                          // another 16 rows: stream the panel again
      __syncthreads();
      for (int s = 0; s < DSTAGES - 1; ++s) {
        if (s < nk) {
          load_a(s, s, r0);
          load_b(s, s);
        }
        hw::cp_async_commit();
      }
    }
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int it = 0; it < nk; ++it) {
      hw::cp_async_wait<DSTAGES - 2>();
      __syncthreads();                // slice it landed; it - 1 is consumed
      const int nxt = it + DSTAGES - 1;
      if (nxt < nk) {
        load_a(nxt, nxt % DSTAGES, r0);
        load_b(nxt, nxt % DSTAGES);
      }
      hw::cp_async_commit();
      const uint32_t a_s = base + (it % DSTAGES) * D_STAGE;
      const uint32_t b_s = a_s + DA_BYTES;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t a[4], b[4];
        hw::ldmatrix_x4(a, a_s + ((lane % 16) * LDA + kk * 16 + (lane / 16) * 8)
                                     * 2);
        // b[0..1]: columns 16 warp + 0..7 at k 0..7, 8..15; b[2..3]: + 8..15
        if (KB)
          hw::ldmatrix_x4(
              b, b_s + ((16 * warp + (lane / 16) * 8 + lane % 8) * LDB
                        + kk * 16 + ((lane / 8) % 2) * 8) * 2);
        else
          hw::ldmatrix_x4_trans(
              b, b_s + ((kk * 16 + lane % 16) * LDB + 16 * warp
                        + (lane / 16) * 8) * 2);
        hw::mma_bf16(acc[0], a, b[0], b[1]);
        hw::mma_bf16(acc[1], a, b[2], b[3]);
      }
    }
    const int r1 = min(hi, r0 + DM);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + 16 * warp + 8 * j + 2 * q;
      if (col >= N) continue;
      if (r0 + g < r1)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + g) * N + col) =
            hw::pack_bf16(acc[j][0], acc[j][1]);
      if (r0 + g + 8 < r1)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + g + 8) * N + col) =
            hw::pack_bf16(acc[j][2], acc[j][3]);
    }
  }
  hw::cp_async_wait<0>();
}

// ------------------------------------------------------------ launchers
// out [T, N] = lhs [T, K] B_e per group, B_e as the kernels' KB says.
template <int BM, int KB>
void launch_f32(const void* lhs, const void* rhs, const int* offsets,
                void* out, int Tn, int K, int N, int E, cudaStream_t s) {
  dim3 grid((Tn + BM - 1) / BM + E + 2, (N + BN - 1) / BN);
  gmm_kernel<float, BM, KB><<<grid, NT, 0, s>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(rhs), offsets,
      static_cast<float*>(out), Tn, K, N, E);
}

// Allows `bytes` of dynamic shared memory for `kernel`, once.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *done = err == cudaSuccess;
  return err;
}

template <int KB>
int launch_bf16(const void* lhs, const void* rhs, const int* offsets,
                void* out, int Tn, int K, int N, int E, cudaStream_t s) {
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (K == 0) return (int)cudaMemsetAsync(out, 0, (size_t)Tn * N * 2, s);
  if (Tn <= 16 * E) {
    static bool smem_ok = false;
    const cudaError_t err = allow_smem(gmm_mma_kernel<KB>, D_SMEM, &smem_ok);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(E + 2, (N + DN - 1) / DN);
    gmm_mma_kernel<KB><<<grid, D_THREADS, D_SMEM, s>>>(
        static_cast<const __nv_bfloat16*>(lhs),
        static_cast<const __nv_bfloat16*>(rhs), offsets, o, Tn, K, N, E);
    return 0;
  }
  // lhs as a [T, K] map in 64 x 128 boxes; rhs as [E, K, N] in 64 x 64 x 1
  // boxes (KB = 0) or as [E, N, K] in 64 (K) x 256 (N) x 1 boxes (KB = 1)
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)Tn};
  const uint32_t box_a[2] = {WK, WM};
  const uint64_t dims_b[3] = {(uint64_t)(KB ? K : N), (uint64_t)(KB ? N : K),
                              (uint64_t)E};
  const uint32_t box_b[3] = {KB ? WK : 64, KB ? WN : WK, 1};
  if (!hw::encode_bf16(&map_a, lhs, 2, dims_a, box_a) ||
      !hw::encode_bf16(&map_b, rhs, 3, dims_b, box_b))
    return (int)cudaErrorInvalidValue;
  static bool smem_ok = false;
  const cudaError_t err = allow_smem(gmm_wgmma_kernel<KB>, W_SMEM, &smem_ok);
  if (err != cudaSuccess) return (int)err;
  const long row_tiles = (Tn + WM - 1) / WM + E + 2;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + WN - 1) / WN, (unsigned)row_tiles);
  gmm_wgmma_kernel<KB><<<grid, W_THREADS, W_SMEM, s>>>(map_a, map_b, offsets,
                                                       o, Tn, K, N, E);
  return 0;
}

// The checks and the route of both entry points.
template <int KB>
int launch_gmm(const void* lhs, const void* rhs, const void* offsets,
               void* out, int T, int K, int N, int E, int dtype,
               void* stream) {
  if (E <= 0 || E > kMaxExperts || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* offs = static_cast<const int*>(offsets);
  if (dtype == rt::kF32) {
    // Few rows per group (decode): small row tiles waste fewer FMAs on rows
    // that belong to no group of the tile.
    if (T <= 16 * E) {
      launch_f32<16, KB>(lhs, rhs, offs, out, T, K, N, E, s);
    } else {
      launch_f32<64, KB>(lhs, rhs, offs, out, T, K, N, E, s);
    }
  } else if (dtype == rt::kBF16) {
    if (K % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
    const int rc = launch_bf16<KB>(lhs, rhs, offs, out, T, K, N, E, s);
    if (rc) return rc;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- backward
// dW[e] = X[rows of e]^T dY[rows of e] (dX = dY W^T per group is the
// forward's kernels with B K-major, reading W in place: see the top of this
// file and grouped_matmul_dx_launch).  Expert e
// covers [lo, hi): lo is the running maximum of the clamped offsets[0..e],
// hi that of offsets[0..e+1], as find_tile reads them.  An expert with no
// rows gets zeros, and rows no group covers add nothing, so the dropped MoE
// assignments (sorted past the last group) get no gradient.  Deterministic:
// each output is summed by one owner in row order; no atomics, no split-K.
//
// Bound: at granite's training shape ([32768,1024] x [32768,512] over 32
// experts, bf16) 134 MB (0.040 ms at 3.35 TB/s) against 34.4 GFLOP (0.035
// ms on the tensor cores), so bytes bound it, narrowly; f32 FMA alone
// would cap it at 0.51 ms.
//
// bf16: a grouped GEMM on wgmma with M = D, N = F and K = the expert's
// rows.  X_e [K, D] and dY_e [K, F] are both row-major, so both operands
// are MN-major and wgmma reads them in place through its two transpose
// bits.  Each block owns one 128 (D) x 256 (F) tile of one expert (blockIdx
// z is the expert, so an expert's tiles run together and its rows come from
// device memory about once) and walks the expert's rows in 64-row K slices.
// The ring is the forward's: one producer thread issues TMA loads (128-byte
// swizzle) of two 64-column spans of X and four of dY a slice into 4
// stages, with mbarriers for full and empty stages; two consumer
// warpgroups each issue wgmma m64n256k16 on their 64 columns of X against
// the whole dY slice.  TMA takes any start row, so a slice starts at lo;
// the expert's last slice runs past hi into the next expert's rows, and the
// consumers zero those rows of every span before its wgmma (in an MN-major
// tile with 128-byte swizzle a K row is one 128-byte line, so whole rows
// are zeroed whatever the swizzle), then fence.proxy.async and a barrier
// of both warpgroups.  TMA fills rows >= T, and D or F past the edge, with
// zeros.  Epilogue: f32 -> bf16 once, staged in the ring, 16-byte rows.
// D % 8 == 0 and F % 8 == 0 (TMA strides); the wrapper raises otherwise.
//
// f32: an FMA loop, so f32 stays exact f32 (no TF32).  One 256-thread
// block per (64 x 64 tile of dW, expert) walks the expert's rows in steps
// of 32 through shared memory, 4 x 4 outputs a thread.
constexpr int WD = 64;           // rows of dW (D) per block
constexpr int WF = 64;           // columns of dW (F) per block
constexpr int WR = 32;           // rows of the group per step
constexpr int W_NT = 256;

// Expert e's rows [lo, hi) into s_range, by one thread.
__device__ __forceinline__ void expert_range(const int* offsets, int e,
                                             int Tn, int* s_range) {
  int lo = 0, hi = 0;
  for (int g = 0; g <= e + 1; ++g) {
    hi = max(hi, min(max(offsets[g], 0), Tn));
    if (g == e) lo = hi;
  }
  s_range[0] = lo;
  s_range[1] = hi;
}

template <typename T>
__global__ void __launch_bounds__(W_NT)
gmm_dw_kernel(const T* __restrict__ lhs, const T* __restrict__ dy,
              const int* __restrict__ offsets, T* __restrict__ dw, int Tn,
              int D, int F, int E) {
  __shared__ float Xs[WR][WD];
  __shared__ float Ys[WR][WF];
  __shared__ int s_range[2];
  const int e = blockIdx.z;
  const int d0 = blockIdx.y * WD, f0 = blockIdx.x * WF;
  if (threadIdx.x == 0) expert_range(offsets, e, Tn, s_range);
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = lo; r0 < hi; r0 += WR) {
    for (int idx = threadIdx.x; idx < WR * WD; idx += W_NT) {
      const int r = idx / WD, c = idx % WD, row = r0 + r, d = d0 + c;
      Xs[r][c] = (row < hi && d < D) ? rt::to_f(lhs[(size_t)row * D + d]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < WR * WF; idx += W_NT) {
      const int r = idx / WF, c = idx % WF, row = r0 + r, f = f0 + c;
      Ys[r][c] = (row < hi && f < F) ? rt::to_f(dy[(size_t)row * F + f]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < WR; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ys[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  T* out = dw + (size_t)e * D * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty + 16 * i;
    if (d >= D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx + 16 * j;
      if (f < F) out[(size_t)d * F + f] = rt::from_f<T>(acc[i][j]);
    }
  }
}

// bf16 dW on wgmma: block (x, y, z) owns columns [256 x, +256) and rows
// [128 y, +128) of dW[z].  The stage layout is the forward's: six 8 KB
// spans of 64 K rows x 64 columns, two of X (A) then four of dY (B).
__global__ void __launch_bounds__(W_THREADS, 1)
gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_dy,
                    const int* __restrict__ offsets,
                    __nv_bfloat16* __restrict__ dw, int Tn, int D, int F) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int s_range[2];
  const int e = blockIdx.z;
  const int d0 = blockIdx.y * WM, f0 = blockIdx.x * WN;
  if (threadIdx.x == 0) expert_range(offsets, e, Tn, s_range);
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  __nv_bfloat16* out = dw + (size_t)e * D * F;
  const int nk = (hi - lo + WK - 1) / WK;
  if (nk == 0) {                     // an expert with no rows: zeros
    zero_tile_bf16(out, d0, min(D, d0 + WM), f0, WN, F, W_THREADS);
    return;
  }

  // Swizzled tiles need 1024-byte alignment.
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + WSTAGES * STAGE_BYTES;
  auto sa = [&](int s) { return base + s * STAGE_BYTES; };
  auto sb = [&](int s) { return base + s * STAGE_BYTES + A_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (WSTAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      hw::mbar_init(full(s), 1);
      hw::mbar_init(empty(s), 2);    // one arrival per consumer warpgroup
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps up to WSTAGES slices in flight
    if (threadIdx.x == 256) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % WSTAGES, r = lo + it * WK;
        if (it >= WSTAGES) hw::mbar_wait(empty(s), ((it / WSTAGES) - 1) & 1);
        hw::mbar_expect_tx(full(s), STAGE_BYTES);
#pragma unroll
        for (int h = 0; h < WM / 64; ++h)
          hw::tma_load_2d(sa(s) + h * B_HALF, &map_x, full(s), d0 + 64 * h, r);
#pragma unroll
        for (int h = 0; h < B_SPANS; ++h)
          hw::tma_load_2d(sb(s) + h * B_HALF, &map_dy, full(s), f0 + 64 * h,
                          r);
      }
    }
  } else {
    // rows of the last slice that belong to the expert (1..WK)
    const int tail = hi - lo - (nk - 1) * WK;
    float acc[WN / 2];               // the first wgmma overwrites it
    for (int it = 0; it < nk; ++it) {
      const int s = it % WSTAGES;
      hw::mbar_wait(full(s), (it / WSTAGES) & 1);
      if (it == nk - 1 && tail < WK) {
        // zero K rows tail..WK-1 (the next expert's) of all six spans
        constexpr int SPANS = STAGE_BYTES / B_HALF;
        const int per_span = (WK - tail) * 8;      // 16-byte chunks
        for (int c = threadIdx.x; c < SPANS * per_span; c += 256)
          hw::st_shared_zero16(sa(s) + (c / per_span) * B_HALF + tail * 128
                               + (c % per_span) * 16);
        hw::fence_proxy_async();
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
      }
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) {
        // A: this warpgroup's 64 columns of X, one span; B: the four spans
        // of dY, 8 KB apart.  Both MN-major: 8-row K groups 1024 B apart,
        // a k16 step is 16 rows (2048 B).
        const uint64_t da = hw::wgmma_desc(sa(s) + wg * B_HALF + kk * 2048,
                                           B_HALF, 1024);
        const uint64_t db = hw::wgmma_desc(sb(s) + kk * 2048, B_HALF, 1024);
        hw::wgmma_ss<1, 1>(acc, da, db, it > 0 || kk > 0);   // m64n<WN>k16
      }
      hw::wgmma_commit();
      hw::wgmma_wait<1>();                // slice it - 1 is done with smem
      hw::fence_regs(acc);
      if (it > 0 && threadIdx.x % 128 == 0)
        hw::mbar_arrive(empty((it - 1) % WSTAGES));
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(acc);

    // epilogue, as the forward's: f32 -> bf16 into this warpgroup's staging
    // rows in the ring (once both warpgroups are done with it), then
    // 16-byte stores of the rows and columns inside [D, F]
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(gbase)
                         + wg * 64 * EPI_LD;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int row = 16 * warp + g, col = 8 * j + 2 * q;
      *reinterpret_cast<uint32_t*>(stg + row * EPI_LD + col) =
          hw::pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(stg + (row + 8) * EPI_LD + col) =
          hw::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    for (int c = t; c < 64 * (WN / 8); c += 128) {
      const int r = c / (WN / 8), cc = (c % (WN / 8)) * 8;
      const int row = d0 + 64 * wg + r, col = f0 + cc;
      if (row < D && col < F)
        *reinterpret_cast<uint4*>(out + (size_t)row * F + col) =
            *reinterpret_cast<const uint4*>(stg + r * EPI_LD + cc);
    }
  }
}

int launch_dw_bf16(const void* lhs, const void* dy, const int* offsets,
                   void* dw, int Tn, int D, int F, int E, cudaStream_t s) {
  if (Tn == 0)
    return (int)cudaMemsetAsync(dw, 0, (size_t)E * D * F * 2, s);
  // X as a [T, D] map and dY as [T, F], both in 64-column x 64-row boxes
  CUtensorMap map_x, map_dy;
  const uint64_t dims_x[2] = {(uint64_t)D, (uint64_t)Tn};
  const uint64_t dims_dy[2] = {(uint64_t)F, (uint64_t)Tn};
  const uint32_t box[2] = {64, WK};
  if (!hw::encode_bf16(&map_x, lhs, 2, dims_x, box) ||
      !hw::encode_bf16(&map_dy, dy, 2, dims_dy, box))
    return (int)cudaErrorInvalidValue;
  static bool smem_ok = false;
  const cudaError_t err = allow_smem(gmm_dw_wgmma_kernel, W_SMEM, &smem_ok);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F + WN - 1) / WN, (D + WM - 1) / WM, E);
  gmm_dw_wgmma_kernel<<<grid, W_THREADS, W_SMEM, s>>>(
      map_x, map_dy, offsets, static_cast<__nv_bfloat16*>(dw), Tn, D, F);
  return 0;
}

}  // namespace

// lhs: [T,D], rhs: [E,D,F], out: [T,F] contiguous, one dtype (code);
// offsets: [E+1] int32 on the device.  bf16 needs D % 8 == 0 and F % 8 == 0.
// Returns the CUDA error code (0 = ok).
extern "C" int grouped_matmul_launch(const void* lhs, const void* rhs,
                                     const void* offsets, void* out, int T,
                                     int D, int F, int E, int dtype,
                                     void* stream) {
  return launch_gmm<0>(lhs, rhs, offsets, out, T, D, F, E, dtype, stream);
}

// dX of grouped_matmul_launch: dx[rows of e] = dy[rows of e] w[e]^T, with
// w [E,D,F] read in place (no transposed copy); rows no group covers get
// zeros.  dy: [T,F], w: [E,D,F], dx: [T,D] contiguous, one dtype (code);
// offsets: [E+1] int32 on the device.  bf16 needs D % 8 == 0 and
// F % 8 == 0.  Returns the CUDA error code (0 = ok).
extern "C" int grouped_matmul_dx_launch(const void* dy, const void* w,
                                        const void* offsets, void* dx, int T,
                                        int D, int F, int E, int dtype,
                                        void* stream) {
  return launch_gmm<1>(dy, w, offsets, dx, T, F, D, E, dtype, stream);
}

// dW of grouped_matmul_launch: lhs: [T,D], dy: [T,F], dw: [E,D,F]
// contiguous, one dtype (code); offsets: [E+1] int32 on the device.  bf16
// needs D % 8 == 0 and F % 8 == 0.  dw is written, not accumulated.
// Returns the CUDA error code (0 = ok).
extern "C" int grouped_matmul_dw_launch(const void* lhs, const void* dy,
                                        const void* offsets, void* dw, int T,
                                        int D, int F, int E, int dtype,
                                        void* stream) {
  if (E <= 0 || E > 65535 || (D + WD - 1) / WD > 65535)
    return (int)cudaErrorInvalidValue;
  if (D == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* offs = static_cast<const int*>(offsets);
  if (dtype == rt::kF32) {
    const dim3 grid((F + WF - 1) / WF, (D + WD - 1) / WD, E);
    gmm_dw_kernel<float><<<grid, W_NT, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(dy), offs,
        static_cast<float*>(dw), T, D, F, E);
  } else if (dtype == rt::kBF16) {
    if (D % 8 != 0 || F % 8 != 0) return (int)cudaErrorInvalidValue;
    const int rc = launch_dw_bf16(lhs, dy, offs, dw, T, D, F, E, s);
    if (rc) return rc;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
