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

// Blocks of `threads` threads of `kernel` that the card holds at once.
template <typename K>
int resident_blocks(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
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
// Rows past the register budget (more than kMaxBwdNV vectors a lane: D >
// 2048 in bf16, 1024 in f32) or not 16-byte aligned take the wide route:
// a warp a row, two passes over it (sums, then dx; the second from
// L1/L2), 8 rows at a time, then a thread a column adds those rows' dy x r
// in row order to the block's partial (reading x and dy a third time, from
// L2).  Its loads are 16-byte vectors where the rows are aligned, single
// elements otherwise.
//
// Split over ranks, kSums writes each row's (sum x^2, sum w dy x) over the
// local columns to sums [T, 2], and after the caller's sum over the ranks
// kScale writes dx and the local columns' dw from them: each row's sums and
// dw's partials in the one-pass order.  On the register route kScale runs on
// the one-pass grid.  On the wide route with aligned rows the sums are given,
// so kScale is a streaming pass over column tiles by the same runs of rows
// (rmsnorm_bwd_scale_kernel): x and dy read once, not three times.
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

// VW consecutive elements at p as f32, in 16-byte loads where VW elements
// fill them (p then 16-byte aligned); then the same for stores.
template <int VW, typename T>
__device__ __forceinline__ void load_f(const T* p, float (&f)[VW]) {
  constexpr int PER = 16 / sizeof(T);
  if constexpr (VW % PER == 0) {
#pragma unroll
    for (int q = 0; q < VW / PER; ++q) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[q];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < PER; ++j) f[q * PER + j] = rt::to_f(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) f[j] = rt::to_f(p[j]);
  }
}
template <int VW, typename T>
__device__ __forceinline__ void store_f(T* p, const float (&f)[VW]) {
  constexpr int PER = 16 / sizeof(T);
  if constexpr (VW % PER == 0) {
#pragma unroll
    for (int q = 0; q < VW / PER; ++q) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < PER; ++j) e[j] = rt::from_f<T>(f[q * PER + j]);
      reinterpret_cast<uint4*>(p)[q] = raw;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VW; ++j) p[j] = rt::from_f<T>(f[j]);
  }
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

// Wide route: rows [rpb b, rpb (b + 1)), a warp a row, 8 rows at a time;
// VW elements a load (Vec<T>::V on aligned rows, else 1), U loads of each
// of x, dy and w in flight a lane.  Shared memory: the 8 rows' r.
template <typename T, int VW, int P>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ dw, float* __restrict__ part,
                        float2* __restrict__ sums, int T_, int D, int Dn,
                        float eps, int rpb) {
  constexpr int U = VW == 1 ? 16 : 2;
  __shared__ float s_r[kBwdWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = D / VW;
  const int r0 = blockIdx.x * rpb, r1 = min(T_, r0 + rpb);
  float* dst = gridDim.x == 1 ? dw : part + (size_t)blockIdx.x * D;
  for (int base = r0; base < r1; base += kBwdWarps) {
    const int row = base + warp;
    if (row < r1) {
      const T* xr = x + (size_t)row * D;
      const T* gr = dy + (size_t)row * D;
      float ss = 0.f, dot = 0.f;
      for (int v0 = lane; P != kScale && v0 < nvec; v0 += 32 * U) {
        float xf[U][VW], gf[U][VW], wf[U][VW];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = v0 + 32 * u;
          if (v < nvec) {
            load_f<VW>(xr + v * VW, xf[u]);
            load_f<VW>(gr + v * VW, gf[u]);
            load_f<VW>(w + v * VW, wf[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (v0 + 32 * u >= nvec) continue;
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            ss = fmaf(xf[u][j], xf[u][j], ss);
            dot = fmaf(gf[u][j] * wf[u][j], xf[u][j], dot);
          }
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
      for (int v0 = lane; v0 < nvec; v0 += 32 * U) {
        float xf[U][VW], gf[U][VW], wf[U][VW];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = v0 + 32 * u;
          if (v < nvec) {
            load_f<VW>(xr + v * VW, xf[u]);
            load_f<VW>(gr + v * VW, gf[u]);
            load_f<VW>(w + v * VW, wf[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int v = v0 + 32 * u;
          if (v >= nvec) continue;
          float of[VW];
#pragma unroll
          for (int j = 0; j < VW; ++j)
            of[j] = bwd_dx(wf[u][j], r, gf[u][j], xf[u][j], c);
          store_f<VW>(dx + (size_t)row * D + v * VW, of);
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

// kScale on the wide route with aligned rows: a streaming pass, as the row
// sums are given.  Block (bx, by) takes kScaleThreads 16-byte column vectors
// (a thread each) of the rows [rpb by, rpb (by + 1)), the run whose dw
// partial rmsnorm_bwd_wide_kernel writes.  A thread keeps its columns' w and
// dw sums in registers and walks the run's rows in order, kScaleRows rows'
// loads of x, dy and sums in flight, and writes dx as it goes: x and dy read
// once, dx written once, all in coalesced 16-byte vectors, no barrier.  Each
// column's partial is the wide kernel's fold, in row order from zero, so its
// bits; part[by] (dw when one run holds every row) as there.
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
      const T* xe = reinterpret_cast<const T*>(&xr[u]);
      const T* ge = reinterpret_cast<const T*>(&gr[u]);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xf = rt::to_f(xe[j]), gf = rt::to_f(ge[j]);
        oe[j] = rt::from_f<T>(bwd_dx(wf[j], r, gf, xf, c));
        acc[j] = fmaf(gf * xf, r, acc[j]);
      }
      ov[(size_t)(base + u) * nvec] = out;
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

// Phase P of the backward.  The route follows from x, dy, w and D where dx
// is aligned (kSums writes none).
template <typename T, int P>
void launch_bwd(const BwdArgs<T>& a, cudaStream_t stream) {
  constexpr int V = Vec<T>::V;
  const bool vec = aligned16(a.x) && aligned16(a.dy) && aligned16(a.w) &&
                   (P == kSums || aligned16(a.dx)) &&
                   (((size_t)a.D * sizeof(T)) % 16 == 0);
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
    if (!vec)
      rmsnorm_bwd_wide_kernel<T, 1, P><<<blocks, kBwdThreads, 0, stream>>>(
          a.x, a.w, a.dy, a.dx, a.dw, a.part, a.sums, a.T_, a.D, a.Dn, a.eps,
          rpb);
    else if constexpr (P == kScale)
      rmsnorm_bwd_scale_kernel<T>
          <<<dim3((unsigned)((nvec + kScaleThreads - 1) / kScaleThreads),
                  (unsigned)blocks),
             kScaleThreads, 0, stream>>>(a.x, a.w, a.dy, a.dx, a.dw, a.part,
                                         a.sums, a.T_, a.D, a.Dn, a.eps, rpb);
    else
      rmsnorm_bwd_wide_kernel<T, V, P><<<blocks, kBwdThreads, 0, stream>>>(
          a.x, a.w, a.dy, a.dx, a.dw, a.part, a.sums, a.T_, a.D, a.Dn, a.eps,
          rpb);
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
// part: [min(T, 256), D] f32, the wrapper's scratch for the per-block dw
// partials (kMaxParts).  Returns the CUDA error code of the launches
// (0 = launched).
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
