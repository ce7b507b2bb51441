// RMSNorm forward for Hopper: out[t, :] = x[t, :] * rsqrt(mean(x[t, :]^2) + eps) * w.
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
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;        // rows per block, a warp each
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
// scaled write after the reduction reads it from there.
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_reg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int T_, int D, float eps) {
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
  uint4* ov = reinterpret_cast<uint4*>(out + (size_t)row * D);
  uint4 reg[NV];
  float ss = 0.f;
  // every load of the row issued before the reduction
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (live && v < nvec) reg[i] = xv[v];
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (live && lane + 32 * i < nvec) ss = sum_sq<T>(reg[i], ss);
  const float inv = rsqrtf(warp_sum(ss) / (float)D + eps);
  hw::cp_async_wait<0>();
  __syncthreads();
  if (!live) return;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) ov[v] = scale_vec<T>(reg[i], inv, w_s + v * (V / 4));
  }
}

// Aligned route for rows wider than kMaxNV vectors a lane: pieces of
// 32 * kMaxNV vectors, twice (the second pass reads x again).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ out, int T_, int D, float eps) {
  constexpr int V = Vec<T>::V, NV = kMaxNV;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T_) return;
  const int nvec = D / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  uint4* ov = reinterpret_cast<uint4*>(out + (size_t)row * D);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  uint4 reg[NV];
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
  const float inv = rsqrtf(warp_sum(ss) / (float)D + eps);
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
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      T* __restrict__ out, int T_, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T_) return;
  const T* xr = x + (size_t)row * D;
  T* orow = out + (size_t)row * D;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float f = rt::to_f(xr[i]);
    ss = fmaf(f, f, ss);
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)D + eps);
  for (int i = lane; i < D; i += 32)
    orow[i] = rt::from_f<T>((rt::to_f(xr[i]) * inv) * w[i]);
}

template <typename T>
void launch(const void* x, const void* w, void* out, int T_, int D, float eps,
            cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  const dim3 grid((unsigned)((T_ + kWarps - 1) / kWarps)), block(kWarps * 32);
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                   ((uintptr_t)w % 16 == 0) &&
                   (((size_t)D * sizeof(T)) % 16 == 0);
  if (!vec) {
    rmsnorm_scalar_kernel<T><<<grid, block, 0, stream>>>(xp, wp, op, T_, D, eps);
    return;
  }
  // the fewest registers that hold the row; wider rows go in pieces
  const int per_lane = (D / Vec<T>::V + 31) / 32;
  const size_t ws = (size_t)D * sizeof(float);
  if (per_lane <= 1)
    rmsnorm_reg_kernel<T, 1><<<grid, block, ws, stream>>>(xp, wp, op, T_, D, eps);
  else if (per_lane <= 2)
    rmsnorm_reg_kernel<T, 2><<<grid, block, ws, stream>>>(xp, wp, op, T_, D, eps);
  else if (per_lane <= 4)
    rmsnorm_reg_kernel<T, 4><<<grid, block, ws, stream>>>(xp, wp, op, T_, D, eps);
  else if (per_lane <= 6)
    rmsnorm_reg_kernel<T, 6><<<grid, block, ws, stream>>>(xp, wp, op, T_, D, eps);
  else if (per_lane <= 8)
    rmsnorm_reg_kernel<T, 8><<<grid, block, ws, stream>>>(xp, wp, op, T_, D, eps);
  else if (per_lane <= 12)
    rmsnorm_reg_kernel<T, 12><<<grid, block, ws, stream>>>(xp, wp, op, T_, D, eps);
  else if (per_lane <= kMaxNV)
    rmsnorm_reg_kernel<T, kMaxNV><<<grid, block, ws, stream>>>(xp, wp, op, T_, D, eps);
  else
    rmsnorm_wide_kernel<T><<<grid, block, 0, stream>>>(xp, wp, op, T_, D, eps);
}

// ------------------------------------------------------------- backward
// dx = w r dy - x r^3 mean(dy w x) and dw = sum_rows dy x r, with
// r = rsqrt(mean(x^2) + eps), all in f32.  Bound by bytes (x and dy read,
// dx written).  A simple design that is right first: one warp a row for dx
// (two passes over the row, the second from L1/L2), then dw in two fixed
// orders and no atomics, so two calls give the same bits: a block of
// threads, one a column, sums kDwRows rows each into a partial, and a
// second kernel sums the partials of a column in order.
constexpr int kDwRows = 64;      // rows a dw partial sums (ops.RMS_DW_ROWS)
constexpr int kDwCols = 128;     // columns (threads) a dw block takes

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ r_out, int T_, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T_) return;
  const T* xr = x + (size_t)row * D;
  const T* gr = dy + (size_t)row * D;
  float ss = 0.f, dot = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float xf = rt::to_f(xr[i]);
    ss = fmaf(xf, xf, ss);
    dot = fmaf(rt::to_f(gr[i]) * w[i], xf, dot);
  }
  ss = warp_sum(ss);
  dot = warp_sum(dot);
  const float r = rsqrtf(ss / (float)D + eps);
  const float c = r * r * r * (dot / (float)D);
  T* orow = dx + (size_t)row * D;
  for (int i = lane; i < D; i += 32)
    orow[i] = rt::from_f<T>(w[i] * r * rt::to_f(gr[i]) - rt::to_f(xr[i]) * c);
  if (lane == 0) r_out[row] = r;
}

// partial[c, d] = sum over rows c*kDwRows .. (c+1)*kDwRows - 1 of dy x r.
template <typename T>
__global__ void __launch_bounds__(kDwCols)
rmsnorm_bwd_dw_partial_kernel(const T* __restrict__ x,
                              const T* __restrict__ dy,
                              const float* __restrict__ r,
                              float* __restrict__ partial, int T_, int D) {
  const int d = blockIdx.x * kDwCols + threadIdx.x;
  const int c = blockIdx.y;
  if (d >= D) return;
  const int t1 = min(T_, (c + 1) * kDwRows);
  float acc = 0.f;
  for (int t = c * kDwRows; t < t1; ++t) {
    const size_t off = (size_t)t * D + d;
    acc = fmaf(rt::to_f(dy[off]) * rt::to_f(x[off]), r[t], acc);
  }
  partial[(size_t)c * D + d] = acc;
}

// dw[d] = sum over c of partial[c, d], in order of c.
__global__ void __launch_bounds__(kDwCols)
rmsnorm_bwd_dw_reduce_kernel(const float* __restrict__ partial,
                             float* __restrict__ dw, int n_part, int D) {
  const int d = blockIdx.x * kDwCols + threadIdx.x;
  if (d >= D) return;
  float acc = 0.f;
  for (int c = 0; c < n_part; ++c) acc += partial[(size_t)c * D + d];
  dw[d] = acc;
}

template <typename T>
void launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                void* dw, void* r, void* partial, int T_, int D, float eps,
                cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  float* rp = static_cast<float*>(r);
  float* pp = static_cast<float*>(partial);
  rmsnorm_bwd_dx_kernel<T><<<(T_ + kWarps - 1) / kWarps, kWarps * 32, 0,
                             stream>>>(xp, static_cast<const float*>(w), gp,
                                       static_cast<T*>(dx), rp, T_, D, eps);
  const int n_part = (T_ + kDwRows - 1) / kDwRows;
  const int col_blocks = (D + kDwCols - 1) / kDwCols;
  rmsnorm_bwd_dw_partial_kernel<T><<<dim3(col_blocks, n_part), kDwCols, 0,
                                     stream>>>(xp, gp, rp, pp, T_, D);
  rmsnorm_bwd_dw_reduce_kernel<<<col_blocks, kDwCols, 0, stream>>>(
      pp, static_cast<float*>(dw), n_part, D);
}

}  // namespace

// x, out: [T, D] contiguous, f32 or bf16 (dtype code); w: [D] f32.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int T,
                              int D, float eps, int dtype, void* stream) {
  if (T <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32) {
    launch<float>(x, w, out, T, D, eps, s);
  } else if (dtype == rt::kBF16) {
    launch<__nv_bfloat16>(x, w, out, T, D, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Backward of rmsnorm_launch.  x, dy, dx: [T, D] contiguous, f32 or bf16
// (dtype code); w: [D] f32; dw: [D] f32 (written, not accumulated);
// r: [T] f32 and partial: [ceil(T / 64), D] f32 are the wrapper's scratch.
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w,
                                  const void* dy, void* dx, void* dw,
                                  void* r, void* partial, int T, int D,
                                  float eps, int dtype, void* stream) {
  if (T <= 0 || D <= 0 || T > 65535 * kDwRows) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32) {
    launch_bwd<float>(x, w, dy, dx, dw, r, partial, T, D, eps, s);
  } else if (dtype == rt::kBF16) {
    launch_bwd<__nv_bfloat16>(x, w, dy, dx, dw, r, partial, T, D, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
