// RMSNorm forward for Hopper: out[t, :] = x[t, :] * rsqrt(mean(x[t, :]^2) + eps) * w.
// (Its backward, rmsnorm_bwd_launch, is at the end of this file.)
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (_rmsnorm_kernel /
// rmsnorm_kernel).  Bound by bytes: the kernel moves T*D*(in + out) bytes
// from device memory, and at the main path's rows (D 1024 to 3072, 2 to 6 KB
// in bf16) what limits it is how many of those bytes each SM keeps in flight,
// not arithmetic.
// Design: one warp per row, kWarps rows per block (4096 rows of D 1024 fit
// in one wave on 132 SMs), and no barrier or shared-memory sum between a
// row's loads and its reduction.  On the aligned route each lane issues all of its
// 16-byte loads of the row before it reduces (NV vectors a lane, a template
// parameter, so the row stays in registers), the sum of squares is reduced
// with shuffles only, and the row is scaled and written from registers.
// Meanwhile the block copies w into shared memory with cp.async, so the
// scale reads it as float4 from there instead of waiting on a second trip
// to device memory after the reduction.  Rows wider than kMaxNV vectors a
// lane (D above 4096 in bf16, 2048 in f32) are walked in register-sized
// pieces: the first pass sums the squares, the second reads x again (from
// L2) and writes.  A row that is not 16-byte aligned takes the scalar route.
// The arithmetic is (x * inv) * w in f32, rounded once, as in
// _rmsnorm_kernel.
//
// A row split over ranks (the gated norm of an SSM mixer whose d_inner is
// cut over the model axis) runs the same kernels in two phases: kSums writes
// each row's f32 sum of squares of the local columns, the caller sums those
// over the ranks, and kScale scales the local columns by rsqrt(sum / Dn + eps)
// and w, Dn the whole row's length.  kScale runs the one-pass kernel's code.
// kSums, whose rows are only read, runs on a grid that fills the card once,
// each warp walking rows with the next rows' loads in flight while it
// reduces (rmsnorm_part_kernel); a lane sums its vectors in the one-pass
// kernel's order, so a row's sum is its sum (the route, and so the order,
// follows from x and D alone once w and out are 16-byte aligned, which the
// wrapper ensures); over one rank the two launches give its bits.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;        // rows per block, a warp each

// What a launch computes: the whole norm, or one phase of a row split over
// ranks (kSums: each row's partial sum of squares, or for the backward its
// (sum of squares, sum of w dy x); kScale: the rest, from the summed rows).
enum Phase { kWhole = 0, kSums = 1, kScale = 2 };
constexpr int kMaxNV = 16;       // 16-byte vectors a lane holds in registers

template <typename T>
struct Vec {
  static constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
};

// (x * inv) * w for the V elements of one vector; w4 points at its weights.
template <typename T>
__device__ __forceinline__ uint4 scale_vec(const uint4& raw, float inv,
                                           const float4* __restrict__ w4) {
  constexpr int V = Vec<T>::V;
  float wv[V];
#pragma unroll
  for (int j = 0; j < V / 4; ++j) {
    const float4 f = w4[j];
    wv[4 * j] = f.x; wv[4 * j + 1] = f.y; wv[4 * j + 2] = f.z; wv[4 * j + 3] = f.w;
  }
  uint4 res;
  const T* e = reinterpret_cast<const T*>(&raw);
  T* r = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int j = 0; j < V; ++j) r[j] = rt::from_f<T>((rt::to_f(e[j]) * inv) * wv[j]);
  return res;
}

template <typename T>
__device__ __forceinline__ float sum_sq(const uint4& raw, float ss) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < Vec<T>::V; ++j) {
    const float f = rt::to_f(e[j]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Aligned route, the row in registers (nvec = D / V <= 32 * NV vectors): w
// is copied into shared memory while the row's loads are in flight, so the
// scaled write after the reduction reads it from there.  kScale reads the
// row's sum from ss (kSums runs rmsnorm_part_kernel).
template <typename T, int NV, int P>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_reg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, const float* __restrict__ ss_io,
                   int T_, int D, int Dn, float eps) {
  extern __shared__ float4 w_s[];  // [D / 4]
  constexpr int V = Vec<T>::V;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = row < T_;
  const int nvec = D / V;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  for (int i = threadIdx.x; i < D / 4; i += kWarps * 32)
    hw::cp_async16(hw::smem_u32(w_s + i), w4 + i, true);
  hw::cp_async_commit();
  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  uint4 reg[NV];
  float ss = 0.f;
  // every load of the row issued before the reduction
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (live && v < nvec) reg[i] = xv[v];
  }
  float total;
  if (P == kScale) {
    total = live ? ss_io[row] : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (live && lane + 32 * i < nvec) ss = sum_sq<T>(reg[i], ss);
    total = warp_sum(ss);
  }
  const float inv = rsqrtf(total / (float)Dn + eps);
  hw::cp_async_wait<0>();
  __syncthreads();
  if (!live) return;
  uint4* ov = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) ov[v] = scale_vec<T>(reg[i], inv, w_s + v * (V / 4));
  }
}

// Aligned route for rows wider than kMaxNV vectors a lane: pieces of
// 32 * kMaxNV vectors, twice (the second pass reads x again).
template <typename T, int P>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ out, float* __restrict__ ss_io, int T_,
                    int D, int Dn, float eps) {
  constexpr int V = Vec<T>::V, NV = kMaxNV;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T_) return;
  const int nvec = D / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  uint4* ov = reinterpret_cast<uint4*>(out + (size_t)row * D);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  uint4 reg[NV];
  float total;
  if (P == kScale) {
    total = ss_io[row];
  } else {
    float ss = 0.f;
    for (int base = 0; base < nvec; base += 32 * NV) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = base + lane + 32 * i;
        if (v < nvec) reg[i] = xv[v];
      }
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (base + lane + 32 * i < nvec) ss = sum_sq<T>(reg[i], ss);
    }
    total = warp_sum(ss);
  }
  if (P == kSums) {
    if (lane == 0) ss_io[row] = total;
    return;
  }
  const float inv = rsqrtf(total / (float)Dn + eps);
  for (int base = 0; base < nvec; base += 32 * NV) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = base + lane + 32 * i;
      if (v < nvec) reg[i] = xv[v];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = base + lane + 32 * i;
      if (v < nvec) ov[v] = scale_vec<T>(reg[i], inv, w4 + v * (V / 4));
    }
  }
}

// Unaligned route: one element at a time, the second pass reads x again.
template <typename T, int P>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      T* __restrict__ out, float* __restrict__ ss_io, int T_,
                      int D, int Dn, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T_) return;
  const T* xr = x + (size_t)row * D;
  T* orow = out + (size_t)row * D;
  float total;
  if (P == kScale) {
    total = ss_io[row];
  } else {
    float ss = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float f = rt::to_f(xr[i]);
      ss = fmaf(f, f, ss);
    }
    total = warp_sum(ss);
  }
  if (P == kSums) {
    if (lane == 0) ss_io[row] = total;
    return;
  }
  const float inv = rsqrtf(total / (float)Dn + eps);
  for (int i = lane; i < D; i += 32)
    orow[i] = rt::from_f<T>((rt::to_f(xr[i]) * inv) * w[i]);
}

// kSums on the aligned route, the row in registers (nvec <= 32 NV), on a
// grid sized to the card: twice the blocks it holds at once, so a second
// set waits to start as the first drains, and past that each warp walks
// rows (row gw, gw + nw, ...), the next row's loads issued before it reduces
// the current one's.  At 4096 rows of D 3072 or 192 each warp takes one row:
// every load of the launch is in flight at once (walking two rows a warp
// measured slower there, and four or eight rows a warp at D 192 too).  A
// lane sums its vectors v = lane + 32 i in rising i, then the warp's
// shuffles: rmsnorm_reg_kernel's order, so its bits.
constexpr int kPartWarps = 8;    // warps a block of rmsnorm_part_kernel

template <typename T, int NV>
__device__ __forceinline__ void part_load(const T* __restrict__ x,
                                          uint4 (&r)[NV], int row, int D,
                                          int lane) {
  const int nvec = D / Vec<T>::V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * D);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < nvec) r[i] = xv[lane + 32 * i];
}

template <typename T, int NV>
__device__ __forceinline__ void part_reduce(const uint4 (&r)[NV], int row,
                                            float* __restrict__ ss, int D,
                                            int lane) {
  const int nvec = D / Vec<T>::V;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < nvec) s = sum_sq<T>(r[i], s);
  s = warp_sum(s);
  if (lane == 0) ss[row] = s;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kPartWarps * 32)
rmsnorm_part_kernel(const T* __restrict__ x, float* __restrict__ ss, int T_,
                    int D) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * kPartWarps;
  uint4 a[NV], b[NV];
  int row = blockIdx.x * kPartWarps + (threadIdx.x >> 5);
  if (row < T_) part_load<T, NV>(x, a, row, D, lane);
  for (; row < T_; row += 2 * nw) {
    const int r1 = row + nw, r2 = r1 + nw;
    if (r1 < T_) part_load<T, NV>(x, b, r1, D, lane);
    part_reduce<T, NV>(a, row, ss, D, lane);
    if (r2 < T_) part_load<T, NV>(x, a, r2, D, lane);
    if (r1 < T_) part_reduce<T, NV>(b, r1, ss, D, lane);
  }
}

// Blocks of `threads` threads of `kernel` (with `smem` bytes of dynamic
// shared memory) that the card holds at once.
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, int NV>
void launch_part(const T* x, float* ss, int T_, int D, cudaStream_t stream) {
  static const int cap =
      2 * resident_blocks(rmsnorm_part_kernel<T, NV>, kPartWarps * 32);
  const int need = (T_ + kPartWarps - 1) / kPartWarps;
  rmsnorm_part_kernel<T, NV><<<need < cap ? need : cap, kPartWarps * 32, 0,
                               stream>>>(x, ss, T_, D);
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Phase P of the norm of rows of D columns over a row of Dn.  The route
// follows from x and D where w and out are aligned (kSums reads neither).
template <typename T, int P>
void launch(const void* x, const void* w, void* out, float* ss, int T_, int D,
            int Dn, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  const dim3 grid((unsigned)((T_ + kWarps - 1) / kWarps)), block(kWarps * 32);
  const bool vec = aligned16(x) &&
                   (P == kSums || (aligned16(out) && aligned16(w))) &&
                   (((size_t)D * sizeof(T)) % 16 == 0);
  if (!vec) {
    rmsnorm_scalar_kernel<T, P><<<grid, block, 0, stream>>>(xp, wp, op, ss, T_,
                                                            D, Dn, eps);
    return;
  }
  // the fewest registers that hold the row; wider rows go in pieces
  const int per_lane = (D / Vec<T>::V + 31) / 32;
  if (per_lane > kMaxNV) {
    rmsnorm_wide_kernel<T, P><<<grid, block, 0, stream>>>(xp, wp, op, ss, T_,
                                                          D, Dn, eps);
    return;
  }
#define BY_NV(F)              \
  if (per_lane <= 1)          \
    F(1);                     \
  else if (per_lane <= 2)     \
    F(2);                     \
  else if (per_lane <= 4)     \
    F(4);                     \
  else if (per_lane <= 6)     \
    F(6);                     \
  else if (per_lane <= 8)     \
    F(8);                     \
  else if (per_lane <= 12)    \
    F(12);                    \
  else                        \
    F(kMaxNV)
  if constexpr (P == kSums) {
#define RMS_PART(NV) launch_part<T, NV>(xp, ss, T_, D, stream)
    BY_NV(RMS_PART);
#undef RMS_PART
  } else {
    const size_t ws = (size_t)D * sizeof(float);
#define RMS_REG(NV)                                                       \
  rmsnorm_reg_kernel<T, NV, P><<<grid, block, ws, stream>>>(xp, wp, op, ss, \
                                                          T_, D, Dn, eps)
    BY_NV(RMS_REG);
#undef RMS_REG
  }
#undef BY_NV
}

// ------------------------------------------------------------- backward
// dx = w r dy - x r^3 mean(dy w x) and dw = sum_rows dy x r, with
// r = rsqrt(mean(x^2) + eps), all in f32.  Bound by bytes: x and dy read
// once and dx written once, 3 T D elements (25.2 MB at granite's training
// rows [4096, 1024] in bf16: 0.0075 ms at 3.35 TB/s).
//
// Design: one pass over each row, from registers, and dw in the same pass.
// Each block owns a fixed run of rows (`rpb`, a multiple of the rows its
// warps take at once, so that there are at most kMaxParts blocks).  On the
// register route a group of G lanes takes a row (G = 32 from D = 32 V on;
// 4, 8 or 16 below, so a warp takes 32 / G rows at once), holding NV
// 16-byte vectors of x and of dy a lane: both are loaded before the two sums
// (shuffles within the group), dx is written from the same registers, and
// the lane adds dy x r of its columns to NV V f32 sums that live in
// registers across the block's rows.  Then the row groups of a warp are
// summed by shuffles, the warps one after another into shared memory in
// warp order, and the block writes one f32 partial row of dw.  A second
// launch sums the partials of each column in order of block (a warp per
// stride of partials, then the warps in order).  So x and dy are read once,
// in two launches; when one block holds all rows (T <= rpb) it writes dw
// itself and the second launch is skipped, which keeps few rows at one
// launch.  No atomics: every sum has one owner and one order, so two calls
// give the same bits.  w is copied into shared memory (cp.async) while the
// first rows load.
//
// Aligned rows past the register budget (more than kMaxBwdNV vectors a
// lane: D > 2048 in bf16, 1024 in f32) take the wide route, which keeps the
// register route's order over the same runs of rows: a lane folds its
// vectors v = lane + 32 i in rising i, the warp sums by shuffles, and each
// column folds its run's rows in row order from zero.  The whole backward
// stages each run in shared memory (rmsnorm_bwd_staged_kernel: x and dy
// read from device memory once, by TMA bulk copies a group of rows ahead);
// at a D where two groups do not fit (D 12288) it runs the split
// launches' kernels instead, the sums (rmsnorm_bwd_part_kernel) then the
// streaming kScale (rmsnorm_bwd_scale_kernel), the same bits by
// construction.  Rows not 16-byte aligned, or wider than shared memory
// holds w, take the scalar route (rmsnorm_bwd_scalar_kernel): a warp a
// row, two passes over it, then a thread a column adds 8 rows' dy x r at a
// time to the block's partial, one element a load.
//
// Split over ranks, kSums writes each row's (sum x^2, sum w dy x) over the
// local columns to sums [T, 2], and after the caller's sum over the ranks
// kScale writes dx and the local columns' dw from them: each row's sums and
// dw's partials in the one-pass order.  On the register route both run on
// the one-pass grid.  On the wide route kSums is rmsnorm_bwd_part_kernel (a
// warp a row on a grid sized to the card, every load of a row in flight)
// and kScale rmsnorm_bwd_scale_kernel (a pass over column tiles by the same
// runs of rows): x and dy read once by each.  The wide route's kernels copy
// x and dy into shared memory with TMA: held in the lanes' registers
// instead, the bytes a warp keeps in flight are fewer and the walk is
// slower.
constexpr int kBwdWarps = 8;              // warps a block
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kMaxParts = 256;            // dw partials at most (ops.RMS_DW_PARTS)
constexpr int kMaxBwdNV = 8;              // register route: vectors a lane

// Sum over the aligned group of G lanes that holds v (every lane gets it).
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dx of one element, w r dy - x c, rounded in this order by every backward
// kernel (no contraction that the compiler could choose differently in each),
// so that a split row's kScale gives the one-pass kernels' bits.
__device__ __forceinline__ float bwd_dx(float w, float r, float g, float x,
                                        float c) {
  return __fsub_rn(__fmul_rn(__fmul_rn(w, r), g), __fmul_rn(x, c));
}

// VW consecutive elements at p (16-byte aligned; VW elements fill whole
// 16-byte loads) as f32.
template <int VW, typename T>
__device__ __forceinline__ void load_f(const T* p, float (&f)[VW]) {
  constexpr int PER = 16 / sizeof(T);
  static_assert(VW % PER == 0, "load_f reads whole 16-byte vectors");
#pragma unroll
  for (int q = 0; q < VW / PER; ++q) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[q];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < PER; ++j) f[q * PER + j] = rt::to_f(e[j]);
  }
}

// A lane's fold of one 16-byte vector of x and of dy into its row sums, w
// at its columns: the order of every backward kernel's sums.
template <typename T>
__device__ __forceinline__ void fold_sums(const uint4& xv, const uint4& gv,
                                          const float* w, float& ss,
                                          float& dot) {
  constexpr int V = Vec<T>::V;
  const T* xe = reinterpret_cast<const T*>(&xv);
  const T* ge = reinterpret_cast<const T*>(&gv);
  float wf[V];
  load_f<V>(w, wf);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xf = rt::to_f(xe[j]);
    ss = fmaf(xf, xf, ss);
    dot = fmaf(rt::to_f(ge[j]) * wf[j], xf, dot);
  }
}

// dx of one 16-byte vector of a row whose r and c are given, w at its
// columns, and its g x r folded into acc (the dw fold of every backward
// kernel).
template <typename T>
__device__ __forceinline__ uint4 vec_dx(const uint4& xv, const uint4& gv,
                                        const float (&wf)[Vec<T>::V], float r,
                                        float c, float (&acc)[Vec<T>::V]) {
  constexpr int V = Vec<T>::V;
  const T* xe = reinterpret_cast<const T*>(&xv);
  const T* ge = reinterpret_cast<const T*>(&gv);
  uint4 out;
  T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xf = rt::to_f(xe[j]), gf = rt::to_f(ge[j]);
    oe[j] = rt::from_f<T>(bwd_dx(wf[j], r, gf, xf, c));
    acc[j] = fmaf(gf * xf, r, acc[j]);
  }
  return out;
}

// Register route: rows [rpb b, rpb (b + 1)) of block b.  A lane holds RW
// rows at once (RW NV <= 8 vectors of each of x and dy: more bytes in
// flight where the row is short), so a block takes P = 8 (32 / G) RW rows
// a pass: row base + (u 8 + k) (32 / G) + g is row u of group g of warp k.
// Writes dx, and the block's dw partial to part[b] (or to dw when the grid
// is one block).  Dynamic shared memory: w [D] and the block's dw [D].
template <int NV>
__host__ __device__ constexpr int bwd_rows_at_once() {
  return NV <= 4 ? 8 / NV : 1;
}

template <typename T, int NV, int G, int P>
__global__ void __launch_bounds__(kBwdThreads, NV <= 6 ? 2 : 1)
rmsnorm_bwd_reg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ dw, float* __restrict__ part,
                       float2* __restrict__ sums, int T_, int D, int Dn,
                       float eps, int rpb) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* dw_s = w_s + D;
  constexpr int V = Vec<T>::V, R = 32 / G, RW = bwd_rows_at_once<NV>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / G, gl = lane % G;
  const int nvec = D / V;
  for (int i = threadIdx.x; i < D / 4; i += kBwdThreads)
    hw::cp_async16(hw::smem_u32(smem4 + i),
                   reinterpret_cast<const float4*>(w) + i, true);
  hw::cp_async_commit();

  float acc[NV * V];
#pragma unroll
  for (int k = 0; k < NV * V; ++k) acc[k] = 0.f;
  const int r0 = blockIdx.x * rpb, r1 = min(T_, r0 + rpb);
  for (int base = r0; base < r1; base += kBwdWarps * R * RW) {
    uint4 xv[RW][NV], gv[RW][NV];
    // every load of the RW rows issued before the sums
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      const int row = base + (u * kBwdWarps + warp) * R + grp;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = gl + G * i;
        if (row < r1 && v < nvec) {
          xv[u][i] = reinterpret_cast<const uint4*>(x + (size_t)row * D)[v];
          gv[u][i] = reinterpret_cast<const uint4*>(dy + (size_t)row * D)[v];
        }
      }
    }
    hw::cp_async_wait<0>();
    __syncthreads();                  // w is in shared memory
    float ss[RW], dot[RW];
    if (P == kScale) {
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        const int row = base + (u * kBwdWarps + warp) * R + grp;
        const float2 t = row < r1 ? sums[row] : make_float2(0.f, 0.f);
        ss[u] = t.x;
        dot[u] = t.y;
      }
    } else {
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        const int row = base + (u * kBwdWarps + warp) * R + grp;
        ss[u] = dot[u] = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int v = gl + G * i;
          if (!(row < r1 && v < nvec)) continue;
          const T* xe = reinterpret_cast<const T*>(&xv[u][i]);
          const T* ge = reinterpret_cast<const T*>(&gv[u][i]);
          float wf[V];
          load_f<V>(w_s + v * V, wf);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xf = rt::to_f(xe[j]);
            ss[u] = fmaf(xf, xf, ss[u]);
            dot[u] = fmaf(rt::to_f(ge[j]) * wf[j], xf, dot[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        ss[u] = group_sum<G>(ss[u]);
        dot[u] = group_sum<G>(dot[u]);
      }
    }
    if (P == kSums) {
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        const int row = base + (u * kBwdWarps + warp) * R + grp;
        if (row < r1 && gl == 0) sums[row] = make_float2(ss[u], dot[u]);
      }
      continue;
    }
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      const int row = base + (u * kBwdWarps + warp) * R + grp;
      if (row >= r1) continue;
      const float r = rsqrtf(ss[u] / (float)Dn + eps);
      const float c = r * r * r * (dot[u] / (float)Dn);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = gl + G * i;
        if (v >= nvec) continue;
        const T* xe = reinterpret_cast<const T*>(&xv[u][i]);
        const T* ge = reinterpret_cast<const T*>(&gv[u][i]);
        float wf[V];
        load_f<V>(w_s + v * V, wf);
        uint4 out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xf = rt::to_f(xe[j]), gf = rt::to_f(ge[j]);
          oe[j] = rt::from_f<T>(bwd_dx(wf[j], r, gf, xf, c));
          acc[i * V + j] = fmaf(gf * xf, r, acc[i * V + j]);
        }
        reinterpret_cast<uint4*>(dx + (size_t)row * D)[v] = out;
      }
    }
  }
  if (P == kSums) return;
  // the warp's row groups (butterfly), then the warps in order
#pragma unroll
  for (int o = G; o < 32; o *= 2)
#pragma unroll
    for (int k = 0; k < NV * V; ++k)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], o);
  for (int k = 0; k < kBwdWarps; ++k) {
    if (warp == k && grp == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = gl + G * i;
        if (v >= nvec) continue;
#pragma unroll
        for (int j = 0; j < V; ++j)
          dw_s[v * V + j] = (k ? dw_s[v * V + j] : 0.f) + acc[i * V + j];
      }
    }
    __syncthreads();
  }
  float4* dst = reinterpret_cast<float4*>(
      gridDim.x == 1 ? dw : part + (size_t)blockIdx.x * D);
  for (int i = threadIdx.x; i < D / 4; i += kBwdThreads)
    dst[i] = smem4[D / 4 + i];
}

// Scalar route (rows not 16-byte aligned): rows [rpb b, rpb (b + 1)), a
// warp a row, 8 rows at a time, U single-element loads of each of x, dy
// and w in flight a lane; two passes over the row (sums, then dx), then a
// thread a column adds the 8 rows' dy x r in row order to the block's
// partial (reading x and dy a third time, from L2).  Shared memory: the 8
// rows' r.
template <typename T, int P>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_scalar_kernel(const T* __restrict__ x,
                          const float* __restrict__ w,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ dw, float* __restrict__ part,
                          float2* __restrict__ sums, int T_, int D, int Dn,
                          float eps, int rpb) {
  constexpr int U = 16;
  __shared__ float s_r[kBwdWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rpb, r1 = min(T_, r0 + rpb);
  float* dst = gridDim.x == 1 ? dw : part + (size_t)blockIdx.x * D;
  for (int base = r0; base < r1; base += kBwdWarps) {
    const int row = base + warp;
    if (row < r1) {
      const T* xr = x + (size_t)row * D;
      const T* gr = dy + (size_t)row * D;
      float ss = 0.f, dot = 0.f;
      for (int v0 = lane; P != kScale && v0 < D; v0 += 32 * U) {
        float xf[U], gf[U], wf[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = v0 + 32 * u;
          if (v < D) {
            xf[u] = rt::to_f(xr[v]);
            gf[u] = rt::to_f(gr[v]);
            wf[u] = w[v];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (v0 + 32 * u >= D) continue;
          ss = fmaf(xf[u], xf[u], ss);
          dot = fmaf(gf[u] * wf[u], xf[u], dot);
        }
      }
      if (P == kScale) {
        const float2 t = sums[row];
        ss = t.x;
        dot = t.y;
      } else {
        ss = warp_sum(ss);
        dot = warp_sum(dot);
      }
      if (P == kSums) {
        if (lane == 0) sums[row] = make_float2(ss, dot);
        continue;
      }
      const float r = rsqrtf(ss / (float)Dn + eps);
      const float c = r * r * r * (dot / (float)Dn);
      for (int v0 = lane; v0 < D; v0 += 32 * U) {
        float xf[U], gf[U], wf[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = v0 + 32 * u;
          if (v < D) {
            xf[u] = rt::to_f(xr[v]);
            gf[u] = rt::to_f(gr[v]);
            wf[u] = w[v];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = v0 + 32 * u;
          if (v < D)
            dx[(size_t)row * D + v] =
                rt::from_f<T>(bwd_dx(wf[u], r, gf[u], xf[u], c));
        }
      }
      if (lane == 0) s_r[warp] = r;
    }
    if (P == kSums) continue;
    __syncthreads();
    // dw: a thread a column, the 8 rows' loads in flight, summed in order
    const int n = min(kBwdWarps, r1 - base);
    for (int d = threadIdx.x; d < D; d += kBwdThreads) {
      float xs[kBwdWarps], gs[kBwdWarps];
#pragma unroll
      for (int k = 0; k < kBwdWarps; ++k) {
        if (k < n) {
          const size_t off = (size_t)(base + k) * D + d;
          xs[k] = rt::to_f(x[off]);
          gs[k] = rt::to_f(dy[off]);
        }
      }
      float a = base == r0 ? 0.f : dst[d];
#pragma unroll
      for (int k = 0; k < kBwdWarps; ++k)
        if (k < n) a = fmaf(gs[k] * xs[k], s_r[k], a);
      dst[d] = a;
    }
    __syncthreads();
  }
}

// kSums on the wide route (aligned rows past the register budget): a warp
// a row on a grid of the blocks the card holds at once, each warp walking
// rows gw, gw + nw, ... in pieces of kPieceVecs 16-byte vectors (6 KB of x
// and 6 KB of dy: the whole row at D 3072 in bf16, 12 vectors of each a
// lane).  Lane 0 of each warp copies a piece of x and of dy into one of the
// warp's two stages of shared memory with TMA bulk copies (completion on
// the stage's mbarrier) and, once a piece has landed, the next one into
// the other stage: every load of a piece is in flight at once, and the
// next piece's while the warp folds this one.  The copy engine rather than
// the lanes' registers holds those bytes in flight, and the copies read x
// and dy under L2's evict-first policy (read once, they recycle their own
// lines rather than evict the cache's dirty ones).  w is copied to shared
// memory once.  The fold is fold_sums over v = lane + 32 i in rising i (a
// piece holds 12 consecutive i of each lane), then the warp's shuffles:
// the one-pass kernels' order, so their (ss, dot) bits.
constexpr int kPartStageWarps = 4;   // warps a block
constexpr int kPieceVecs = 32 * 12;  // 16-byte vectors of x (and dy) a piece

// Byte offsets in rmsnorm_bwd_part_kernel's shared memory at D columns: w
// [D] f32, each warp's two stages of a piece of x and of dy, each warp's
// two mbarriers; then the total.
struct PartLayout {
  size_t stages, bar, bytes;
  __host__ __device__ explicit PartLayout(int D)
      : stages((size_t)D * sizeof(float)),
        bar(stages + (size_t)kPartStageWarps * 2 * 2 * kPieceVecs * 16),
        bytes(bar + (size_t)kPartStageWarps * 2 * sizeof(uint64_t)) {}
};

template <typename T>
__global__ void __launch_bounds__(kPartStageWarps * 32)
rmsnorm_bwd_part_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const T* __restrict__ dy, float2* __restrict__ sums,
                        int T_, int D) {
  extern __shared__ float4 smem4[];
  constexpr int V = Vec<T>::V, PB = kPieceVecs * 16;  // bytes of a piece
  const PartLayout L(D);
  const float* w_s = reinterpret_cast<const float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = D / V, pieces = (nvec + kPieceVecs - 1) / kPieceVecs;
  const int nw = gridDim.x * kPartStageWarps;
  const uint32_t base = hw::smem_u32(smem4);
  const uint32_t st0 = base + (uint32_t)L.stages + warp * 2 * 2 * PB;
  const uint32_t bar0 = base + (uint32_t)L.bar + warp * 2 * 8;
  // lane 0: piece p of row into stage s (x, then dy PB bytes on)
  auto issue = [&](int row, int p, int s) {
    const int v0 = p * kPieceVecs;
    const uint32_t bytes = (uint32_t)min(kPieceVecs, nvec - v0) * 16;
    const size_t at = (size_t)row * D + (size_t)v0 * V;
    const uint64_t once = hw::l2_evict_first();
    hw::mbar_expect_tx(bar0 + 8 * s, 2 * bytes);
    hw::bulk_load(st0 + s * 2 * PB, x + at, bytes, bar0 + 8 * s, once);
    hw::bulk_load(st0 + s * 2 * PB + PB, dy + at, bytes, bar0 + 8 * s, once);
  };
  int row = blockIdx.x * kPartStageWarps + warp, piece = 0;
  if (lane == 0) {
    hw::mbar_init(bar0, 1);
    hw::mbar_init(bar0 + 8, 1);
    hw::mbar_fence_init();
    if (row < T_) issue(row, 0, 0);
  }
  for (int i = threadIdx.x; i < D / 4; i += kPartStageWarps * 32)
    hw::cp_async16(hw::smem_u32(smem4 + i),
                   reinterpret_cast<const float4*>(w) + i, true);
  hw::cp_async_commit();
  hw::cp_async_wait<0>();
  __syncthreads();                    // w and the mbarriers are in place
  float ss = 0.f, dot = 0.f;
  for (int c = 0; row < T_; ++c) {
    int next = row, npiece = piece + 1;
    if (npiece == pieces) {
      next += nw;
      npiece = 0;
    }
    const int s = c & 1;
    hw::mbar_wait(bar0 + 8 * s, (c >> 1) & 1);
    if (lane == 0 && next < T_) {     // the other stage was read at c - 1
      hw::fence_proxy_async();
      issue(next, npiece, s ^ 1);
    }
    const uint32_t xs = st0 + s * 2 * PB;
    const int v0 = piece * kPieceVecs;
#pragma unroll
    for (int k = 0; k < kPieceVecs / 32; ++k) {
      const int i = lane + 32 * k;
      if (v0 + i < nvec)
        fold_sums<T>(hw::ld_shared16(xs + 16 * i),
                     hw::ld_shared16(xs + PB + 16 * i), w_s + (v0 + i) * V,
                     ss, dot);
    }
    if (npiece == 0) {
      ss = warp_sum(ss);
      dot = warp_sum(dot);
      if (lane == 0) sums[row] = make_float2(ss, dot);
      ss = dot = 0.f;
    }
    __syncwarp();                     // stage s is read
    row = next;
    piece = npiece;
  }
}

// kWhole on the wide route: x and dy read from device memory once.  Block
// b takes the run of rows [rpb b, rpb (b + 1)) (the runs, and so the dw
// partials, of rmsnorm_bwd_scale_kernel) in groups of kStageRows rows.
// Thread 0 copies each group's rows of x and dy into one of kStages
// stages of shared memory with TMA 1D bulk copies (a row of each a copy,
// under L2's evict-first policy; completion on the stage's mbarrier; w
// with the first group), the group kStages - 1 ahead as soon as this one
// has landed, so that it is in flight while the block works on this one.
// Warp u sums row u of the group from shared memory (fold_sums over v =
// lane + 32 i in rising i, then shuffles) and puts its r and c in shared
// memory; then thread t takes the 16-byte column vectors t, t +
// kBwdThreads, ... of each row in order, writes dx (vec_dx, 16-byte
// stores) and folds g x r into registers held across the run, from zero;
// the run's partial is written once at the end.  Shared memory is read in
// whole 16-byte vectors (ld_shared16).  Rows a stage and threads a block:
// a group of 4 rows at D 3072 in bf16 takes 48 KB a stage, 110.6 KB a
// block with w, so two blocks share an SM and at 4096 rows (256 runs of
// 16) every run is resident at once; 8 warps a block give the SM 16 to
// issue the dx pass, while 4 of them sum a group's rows (a row's sums are
// one warp's, for the one-pass order).  Groups of 2 or 8 rows, or 3
// stages, measured no faster.
constexpr int kStageRows = 4;     // rows a stage
constexpr int kStages = 2;        // stages, each a group of rows
constexpr int kStagedCols = 4;    // column vectors a thread at most

// Byte offsets in rmsnorm_bwd_staged_kernel's shared memory at D columns
// of element size es: the stages' x and dy rows, w [D] f32, the group's
// (r, c), the stages' mbarriers; then the total.
struct StagedLayout {
  size_t w, rc, bar, bytes;
  __host__ __device__ StagedLayout(int D, int es)
      : w((size_t)kStages * 2 * kStageRows * D * es),
        rc(w + (size_t)D * sizeof(float)),
        bar(rc + kStageRows * sizeof(float2)),
        bytes(bar + kStages * sizeof(uint64_t)) {}
};

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
rmsnorm_bwd_staged_kernel(const T* __restrict__ x,
                          const float* __restrict__ w,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ dw, float* __restrict__ part,
                          int T_, int D, float eps, int rpb) {
  extern __shared__ float4 smem4[];
  constexpr int V = Vec<T>::V, R = kStageRows, KV = kStagedCols;
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const StagedLayout L(D, sizeof(T));
  T* rows_s = reinterpret_cast<T*>(smem);      // [stage][x, dy][R][D]
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  float2* rc_s = reinterpret_cast<float2*>(smem + L.rc);
  const uint32_t bar0 = hw::smem_u32(smem + L.bar);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = D / V;
  const uint32_t row_bytes = (uint32_t)D * sizeof(T);
  const int r0 = blockIdx.x * rpb, r1 = min(T_, r0 + rpb);
  const int groups = (r1 - r0 + R - 1) / R;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hw::mbar_init(bar0 + 8 * s, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();
  // thread 0: group g's rows into stage g % kStages (and w with group 0)
  auto issue = [&](int g) {
    const int s = g % kStages, base = r0 + g * R, n = min(R, r1 - base);
    const uint32_t bar = bar0 + 8 * s;
    const uint32_t w_bytes = (uint32_t)(D * sizeof(float));
    hw::mbar_expect_tx(bar, 2u * n * row_bytes + (g == 0 ? w_bytes : 0u));
    if (g == 0) hw::bulk_load(hw::smem_u32(w_s), w, w_bytes, bar);
    const uint64_t once = hw::l2_evict_first();
    for (int u = 0; u < n; ++u) {
      T* xs = rows_s + ((size_t)2 * s * R + u) * D;
      hw::bulk_load(hw::smem_u32(xs), x + (size_t)(base + u) * D, row_bytes,
                    bar, once);
      hw::bulk_load(hw::smem_u32(xs + (size_t)R * D),
                    dy + (size_t)(base + u) * D, row_bytes, bar, once);
    }
  };
  if (tid == 0)
    for (int g = 0; g < kStages - 1 && g < groups; ++g) issue(g);
  float acc[KV][V];
#pragma unroll
  for (int k = 0; k < KV; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  for (int g = 0; g < groups; ++g) {
    const int s = g % kStages, base = r0 + g * R, n = min(R, r1 - base);
    // the stage's x and dy rows, read as whole 16-byte vectors (the
    // compiler would otherwise read bf16 elements one at a time)
    const uint32_t xa = hw::smem_u32(rows_s + (size_t)2 * s * R * D);
    const uint32_t ga = xa + R * row_bytes;
    hw::mbar_wait(bar0 + 8 * s, (g / kStages) & 1);
    if (tid == 0 && g + kStages - 1 < groups) {
      hw::fence_proxy_async();        // its stage was read at g - 1
      issue(g + kStages - 1);
    }
    if (warp < n) {
      const uint32_t row = (uint32_t)warp * row_bytes;
      float ss = 0.f, dot = 0.f;
#pragma unroll 4
      for (int v = lane; v < nvec; v += 32)
        fold_sums<T>(hw::ld_shared16(xa + row + 16 * v),
                     hw::ld_shared16(ga + row + 16 * v), w_s + v * V, ss,
                     dot);
      ss = warp_sum(ss);
      dot = warp_sum(dot);
      if (lane == 0) {
        const float r = rsqrtf(ss / (float)D + eps);
        rc_s[warp] = make_float2(r, r * r * r * (dot / (float)D));
      }
    }
    __syncthreads();                  // the group's r and c are in place
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int v = tid + kBwdThreads * k;
      if (v >= nvec) break;
      float wf[V];
      load_f<V>(w_s + v * V, wf);
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (u >= n) break;
        const float2 rc = rc_s[u];
        const uint32_t at = (uint32_t)u * row_bytes + 16 * v;
        reinterpret_cast<uint4*>(dx + (size_t)(base + u) * D)[v] =
            vec_dx<T>(hw::ld_shared16(xa + at), hw::ld_shared16(ga + at), wf,
                      rc.x, rc.y, acc[k]);
      }
    }
    __syncthreads();                  // stage s is read
  }
  float* dst = gridDim.x == 1 ? dw : part + (size_t)blockIdx.x * D;
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    const int v = tid + kBwdThreads * k;
    if (v >= nvec) break;
    float4* d4 = reinterpret_cast<float4*>(dst + v * V);
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      d4[q] = make_float4(acc[k][4 * q], acc[k][4 * q + 1], acc[k][4 * q + 2],
                          acc[k][4 * q + 3]);
  }
}

// kScale on the wide route with aligned rows: a streaming pass, as the row
// sums are given.  Block (bx, by) takes kScaleThreads 16-byte column vectors
// (a thread each) of the rows [rpb by, rpb (by + 1)), the run whose dw
// partial rmsnorm_bwd_staged_kernel writes.  A thread keeps its columns' w
// and dw sums in registers and walks the run's rows in order, kScaleRows
// rows' loads of x, dy and sums in flight, and writes dx as it goes: x and
// dy read once, dx written once, all in coalesced 16-byte vectors, no
// barrier.  Each column's partial is the staged kernel's fold (vec_dx), in
// row order from zero, so its bits; part[by] (dw when one run holds every
// row) as there.
constexpr int kScaleThreads = 128;   // column vectors a block
constexpr int kScaleRows = 2;        // rows a thread has in flight

template <typename T>
__global__ void __launch_bounds__(kScaleThreads)
rmsnorm_bwd_scale_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dw, float* __restrict__ part,
                         const float2* __restrict__ sums, int T_, int D,
                         int Dn, float eps, int rpb) {
  constexpr int V = Vec<T>::V;
  const int nvec = D / V;
  const int v = blockIdx.x * kScaleThreads + threadIdx.x;
  if (v >= nvec) return;
  const int r0 = blockIdx.y * rpb, r1 = min(T_, r0 + rpb);
  const uint4* xv = reinterpret_cast<const uint4*>(x) + v;
  const uint4* gv = reinterpret_cast<const uint4*>(dy) + v;
  uint4* ov = reinterpret_cast<uint4*>(dx) + v;
  float wf[V], acc[V];
  load_f<V>(w + v * V, wf);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (int base = r0; base < r1; base += kScaleRows) {
    uint4 xr[kScaleRows], gr[kScaleRows];
    float2 s[kScaleRows];
#pragma unroll
    for (int u = 0; u < kScaleRows; ++u) {
      const size_t row = base + u;
      if (base + u < r1) {
        xr[u] = xv[row * nvec];
        gr[u] = gv[row * nvec];
        s[u] = sums[row];
      }
    }
#pragma unroll
    for (int u = 0; u < kScaleRows; ++u) {
      if (base + u >= r1) break;
      const float r = rsqrtf(s[u].x / (float)Dn + eps);
      const float c = r * r * r * (s[u].y / (float)Dn);
      ov[(size_t)(base + u) * nvec] = vec_dx<T>(xr[u], gr[u], wf, r, c, acc);
    }
  }
  float4* dst = reinterpret_cast<float4*>(
      (gridDim.y == 1 ? dw : part + (size_t)blockIdx.y * D) + v * V);
#pragma unroll
  for (int q = 0; q < V / 4; ++q)
    dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                         acc[4 * q + 3]);
}

// dw[d] = the sum over the n partials of column d, in order of block: warp
// k sums partials k, k + 8, ... of 32 columns, then the 8 sums in order.
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_dw_sum_kernel(const float* __restrict__ part,
                          float* __restrict__ dw, int n, int D) {
  __shared__ float s[kBwdWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (d < D)
    for (int p = warp; p < n; p += kBwdWarps) a += part[(size_t)p * D + d];
  s[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && d < D) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdWarps; ++k) t += s[k][lane];
    dw[d] = t;
  }
}

// Rows a block takes: a multiple of `pass` (the rows its warps take at
// once), enough that there are at most kMaxParts blocks.
inline int rows_per_block(int T_, int pass) {
  const int need = (T_ + kMaxParts - 1) / kMaxParts;
  return (need + pass - 1) / pass * pass;
}

// The operands of one backward launch (kSums writes sums and reads no dx,
// dw or part; kScale reads sums).
template <typename T>
struct BwdArgs {
  const T* x;
  const float* w;
  const T* dy;
  T* dx;
  float* dw;
  float* part;
  float2* sums;
  int T_, D, Dn;
  float eps;
};

template <typename T, int NV, int G, int P>
int launch_bwd_reg(const BwdArgs<T>& a, cudaStream_t stream) {
  const int rpb =
      rows_per_block(a.T_, kBwdWarps * (32 / G) * bwd_rows_at_once<NV>());
  const int blocks = (a.T_ + rpb - 1) / rpb;
  rmsnorm_bwd_reg_kernel<T, NV, G, P>
      <<<blocks, kBwdThreads, 2 * (size_t)a.D * sizeof(float), stream>>>(
          a.x, a.w, a.dy, a.dx, a.dw, a.part, a.sums, a.T_, a.D, a.Dn, a.eps,
          rpb);
  return blocks;
}

// The shared memory a block of the card may opt in to.
inline int smem_optin() {
  static const int bytes = [] {
    int dev = 0, b = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&b, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return b;
  }();
  return bytes;
}

// Lets `kernel` take all of it as dynamic shared memory.
template <typename K>
bool allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_optin()) == cudaSuccess;
}

// kSums on the wide route: as many blocks as the card holds at once, fewer
// where the rows need fewer.
template <typename T>
void launch_bwd_part(const T* x, const float* w, const T* dy, float2* sums,
                     int T_, int D, cudaStream_t stream) {
  static const bool allowed = allow_smem(rmsnorm_bwd_part_kernel<T>);
  (void)allowed;
  constexpr int threads = kPartStageWarps * 32;
  const size_t smem = PartLayout(D).bytes;
  const int cap = resident_blocks(rmsnorm_bwd_part_kernel<T>, threads, smem);
  const int need = (T_ + kPartStageWarps - 1) / kPartStageWarps;
  rmsnorm_bwd_part_kernel<T><<<need < cap ? need : cap, threads, smem,
                               stream>>>(x, w, dy, sums, T_, D);
}

// Phase P of the backward.  The route follows from x, dy, w and D where dx
// is aligned (kSums writes none) and the sums kernel's shared memory (w and
// its stages) fits.
template <typename T, int P>
void launch_bwd(const BwdArgs<T>& a, cudaStream_t stream) {
  constexpr int V = Vec<T>::V;
  const bool vec = aligned16(a.x) && aligned16(a.dy) && aligned16(a.w) &&
                   (P == kSums || aligned16(a.dx)) &&
                   (((size_t)a.D * sizeof(T)) % 16 == 0) &&
                   PartLayout(a.D).bytes <= (size_t)smem_optin();
  const int nvec = a.D / V, per_lane = (nvec + 31) / 32;
  int blocks;
  if (vec && per_lane <= kMaxBwdNV) {
    // the fewest registers that hold the row; short rows share a warp
    if (nvec <= 4)
      blocks = launch_bwd_reg<T, 1, 4, P>(a, stream);
    else if (nvec <= 8)
      blocks = launch_bwd_reg<T, 1, 8, P>(a, stream);
    else if (nvec <= 16)
      blocks = launch_bwd_reg<T, 1, 16, P>(a, stream);
    else if (per_lane <= 1)
      blocks = launch_bwd_reg<T, 1, 32, P>(a, stream);
    else if (per_lane <= 2)
      blocks = launch_bwd_reg<T, 2, 32, P>(a, stream);
    else if (per_lane <= 4)
      blocks = launch_bwd_reg<T, 4, 32, P>(a, stream);
    else if (per_lane <= 6)
      blocks = launch_bwd_reg<T, 6, 32, P>(a, stream);
    else
      blocks = launch_bwd_reg<T, kMaxBwdNV, 32, P>(a, stream);
  } else {
    const int rpb = rows_per_block(a.T_, kBwdWarps);
    blocks = (a.T_ + rpb - 1) / rpb;
    const StagedLayout staged(a.D, sizeof(T));
    if (!vec) {
      rmsnorm_bwd_scalar_kernel<T, P><<<blocks, kBwdThreads, 0, stream>>>(
          a.x, a.w, a.dy, a.dx, a.dw, a.part, a.sums, a.T_, a.D, a.Dn, a.eps,
          rpb);
    } else if constexpr (P == kSums) {
      launch_bwd_part<T>(a.x, a.w, a.dy, a.sums, a.T_, a.D, stream);
    } else if (P == kWhole && staged.bytes <= (size_t)smem_optin() &&
               nvec <= kStagedCols * kBwdThreads) {
      static const bool allowed = allow_smem(rmsnorm_bwd_staged_kernel<T>);
      (void)allowed;
      rmsnorm_bwd_staged_kernel<T>
          <<<blocks, kBwdThreads, staged.bytes, stream>>>(
              a.x, a.w, a.dy, a.dx, a.dw, a.part, a.T_, a.D, a.eps, rpb);
    } else {
      // kScale, or the whole backward where two stages do not fit: the
      // split launches' kernels over one rank, the sums in the scratch
      // behind the partials
      float2* sums = a.sums;
      if (P == kWhole) {
        sums = reinterpret_cast<float2*>(
            a.part + (size_t)(a.T_ < kMaxParts ? a.T_ : kMaxParts) * a.D);
        launch_bwd_part<T>(a.x, a.w, a.dy, sums, a.T_, a.D, stream);
      }
      rmsnorm_bwd_scale_kernel<T>
          <<<dim3((unsigned)((nvec + kScaleThreads - 1) / kScaleThreads),
                  (unsigned)blocks),
             kScaleThreads, 0, stream>>>(a.x, a.w, a.dy, a.dx, a.dw, a.part,
                                         sums, a.T_, a.D, a.Dn, a.eps, rpb);
    }
  }
  if (P != kSums && blocks > 1)
    rmsnorm_bwd_dw_sum_kernel<<<(a.D + 31) / 32, kBwdThreads, 0, stream>>>(
        a.part, a.dw, blocks, a.D);
}

// The dtype code's launch of launcher<T> for T = float or bf16; returns the
// CUDA error code (0 = launched).
template <template <typename> class L, typename... A>
int by_dtype(int dtype, A... args) {
  if (dtype == rt::kF32) {
    L<float>::run(args...);
  } else if (dtype == rt::kBF16) {
    L<__nv_bfloat16>::run(args...);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int P>
struct Fwd {
  template <typename T>
  struct L {
    static void run(const void* x, const void* w, void* out, float* ss, int T_,
                    int D, int Dn, float eps, cudaStream_t s) {
      launch<T, P>(x, w, out, ss, T_, D, Dn, eps, s);
    }
  };
};

template <int P>
struct Bwd {
  template <typename T>
  struct L {
    static void run(const void* x, const void* w, const void* dy, void* dx,
                    void* dw, void* part, void* sums, int T_, int D, int Dn,
                    float eps, cudaStream_t s) {
      launch_bwd<T, P>(BwdArgs<T>{static_cast<const T*>(x),
                                  static_cast<const float*>(w),
                                  static_cast<const T*>(dy),
                                  static_cast<T*>(dx), static_cast<float*>(dw),
                                  static_cast<float*>(part),
                                  static_cast<float2*>(sums), T_, D, Dn, eps},
                       s);
    }
  };
};

}  // namespace

// x, out: [T, D] contiguous, f32 or bf16 (dtype code); w: [D] f32.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int T,
                              int D, float eps, int dtype, void* stream) {
  if (T <= 0 || D <= 0) return 0;
  return by_dtype<Fwd<kWhole>::L>(dtype, x, w, out, (float*)nullptr, T, D, D,
                                  eps, static_cast<cudaStream_t>(stream));
}

// A row split over ranks, phase one: ss [T] f32 gets each row's sum of
// squares over its D local columns of x [T, D] (rmsnorm_launch's order).
extern "C" int rmsnorm_part_launch(const void* x, void* ss, int T, int D,
                                   int dtype, void* stream) {
  if (T <= 0 || D <= 0) return 0;
  return by_dtype<Fwd<kSums>::L>(dtype, x, (const void*)nullptr,
                                 (void*)nullptr, static_cast<float*>(ss), T, D,
                                 D, 0.f, static_cast<cudaStream_t>(stream));
}

// Phase two: out = x rsqrt(ss / Dn + eps) w over the local columns, ss [T]
// the rows' sums over all Dn columns; w [D] f32 16-byte aligned.
extern "C" int rmsnorm_scale_launch(const void* x, const void* w,
                                    const void* ss, void* out, int T, int D,
                                    int Dn, float eps, int dtype,
                                    void* stream) {
  if (T <= 0 || D <= 0) return 0;
  return by_dtype<Fwd<kScale>::L>(dtype, x, w, out,
                                  const_cast<float*>(static_cast<const float*>(ss)),
                                  T, D, Dn, eps,
                                  static_cast<cudaStream_t>(stream));
}

// Backward of rmsnorm_launch.  x, dy, dx: [T, D] contiguous, f32 or bf16
// (dtype code); w: [D] f32; dw: [D] f32 (written, not accumulated);
// part: min(T, 256) D + 2 T f32, the wrapper's scratch for the per-block dw
// partials (kMaxParts rows of D at most) and, behind them, the rows' sums
// where the route takes the split launches' kernels.  Returns the CUDA
// error code of the launches (0 = launched).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w,
                                  const void* dy, void* dx, void* dw,
                                  void* part, int T, int D, float eps,
                                  int dtype, void* stream) {
  if (T <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  return by_dtype<Bwd<kWhole>::L>(dtype, x, w, dy, dx, dw, part,
                                  (void*)nullptr, T, D, D, eps,
                                  static_cast<cudaStream_t>(stream));
}

// The backward of a row split over ranks, phase one: sums [T, 2] f32 gets
// each row's (sum x^2, sum w dy x) over its D local columns
// (rmsnorm_bwd_launch's order).
extern "C" int rmsnorm_bwd_part_launch(const void* x, const void* w,
                                       const void* dy, void* sums, int T,
                                       int D, int dtype, void* stream) {
  if (T <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  return by_dtype<Bwd<kSums>::L>(dtype, x, w, dy, (void*)nullptr,
                                 (void*)nullptr, (void*)nullptr, sums, T, D, D,
                                 0.f, static_cast<cudaStream_t>(stream));
}

// Phase two: dx and the local columns' dw from sums [T, 2], the rows' sums
// over all Dn columns (part as rmsnorm_bwd_launch's).
extern "C" int rmsnorm_bwd_scale_launch(const void* x, const void* w,
                                        const void* dy, const void* sums,
                                        void* dx, void* dw, void* part, int T,
                                        int D, int Dn, float eps, int dtype,
                                        void* stream) {
  if (T <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  return by_dtype<Bwd<kScale>::L>(dtype, x, w, dy, dx, dw, part,
                                  const_cast<void*>(sums), T, D, Dn, eps,
                                  static_cast<cudaStream_t>(stream));
}
