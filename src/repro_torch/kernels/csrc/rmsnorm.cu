// RMSNorm forward for Hopper: out[t, :] = x[t, :] * rsqrt(mean(x[t, :]^2) + eps) * w.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (_rmsnorm_kernel /
// rmsnorm_kernel).  Bound by bytes: each element is read once for the sum of
// squares and once more (from L1/L2, the row is at most a few KB) for the
// scaled write, so the kernel moves T*D*(in + out) bytes from device memory.
// Design: one 128-thread block per row (no T % block_rows condition), 16-byte
// vector loads and stores when the row is 16-byte aligned, f32 sum of squares
// reduced with warp shuffles and one shared-memory step across the 4 warps.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int D, float eps, int vec) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const size_t base = (size_t)blockIdx.x * D;
  const T* xr = x + base;
  T* orow = out + base;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  uint4* ov = reinterpret_cast<uint4*>(orow);

  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x; i < D / V; i += kThreads) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = rt::to_f(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads) {
      const float f = rt::to_f(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float s_inv;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) t += warp_sums[i];
    s_inv = rsqrtf(t / (float)D + eps);
  }
  __syncthreads();
  const float inv = s_inv;

  if (vec) {
    for (int i = threadIdx.x; i < D / V; i += kThreads) {
      uint4 raw = xv[i];
      uint4 res;
      const T* e = reinterpret_cast<const T*>(&raw);
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < V; ++j)
        r[j] = rt::from_f<T>((rt::to_f(e[j]) * inv) * w[i * V + j]);
      ov[i] = res;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads)
      orow[i] = rt::from_f<T>((rt::to_f(xr[i]) * inv) * w[i]);
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int T_, int D, float eps,
            cudaStream_t stream) {
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                   (((size_t)D * sizeof(T)) % 16 == 0);
  rmsnorm_kernel<T><<<T_, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), D, eps, vec ? 1 : 0);
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
