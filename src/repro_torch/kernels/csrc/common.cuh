// Helpers shared by the port's kernels: element conversions to and from the
// f32 compute type.  Every kernel loads f32 or bf16, computes in f32 and
// rounds once on the way out (round-to-nearest-even, as torch's .to() does).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace rt {

// dtype codes passed from Python (kernels/build.py: DTYPE_CODES)
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace rt
