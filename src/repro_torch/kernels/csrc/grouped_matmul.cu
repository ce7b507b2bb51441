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
// Bound: at prefill (T = 32768 rows, D = 1024, F = 512) by operations, at
// decode (T = 64 rows over 32 experts) by the bytes of the expert weights.
// Design: the TPU kernel's grid walks every (row tile, expert) pair; here each
// block owns one tile of one group, cut at the group's own start, so a tile
// never straddles two experts and no block loops over all E.  Block b of the
// row axis walks the groups' tile counts (from offsets staged in shared
// memory) to find its group; there are at most ceil(T/BM) + E + 2 such tiles,
// and blocks past the last one exit at once.  The two uncovered ranges are
// groups of their own whose tiles only write zeros.  The product itself is a
// plain shared-memory tiled FMA loop in f32 (BM x 64 output tile, 16-deep K
// slices, 256 threads); BM = 16 for the decode shape, where groups hold a few
// rows, and 64 otherwise.  No tensor cores yet: f32 inputs stay exact f32.
#include "common.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr int kMaxExperts = 1024;

template <typename T, int BM>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
           const int* __restrict__ offsets, T* __restrict__ out, int Tn,
           int D, int F, int E) {
  constexpr int RM = BM / 16;  // output rows per thread
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  __shared__ int s_group, s_r0, s_r1;

  for (int i = threadIdx.x; i <= E; i += NT) s_off[i] = offsets[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    // Group g spans [lo, hi): g = 0 is the uncovered head, g = 1..E are the
    // experts, g = E + 1 is the uncovered tail.
    long tile = blockIdx.x;
    int group = -1, r0 = 0, r1 = 0, lo = 0;
    for (int g = 0; g <= E + 1; ++g) {
      const int hi = (g == E + 1) ? Tn : max(lo, min(max(s_off[g], 0), Tn));
      const int nt = (hi - lo + BM - 1) / BM;
      if (tile < nt) {
        group = g;
        r0 = lo + (int)tile * BM;
        r1 = min(hi, r0 + BM);
        break;
      }
      tile -= nt;
      lo = hi;
    }
    s_group = group;
    s_r0 = r0;
    s_r1 = r1;
  }
  __syncthreads();
  const int group = s_group;
  if (group < 0) return;
  const int r0 = s_r0, r1 = s_r1;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (group >= 1 && group <= E) {
    const T* W = rhs + (size_t)(group - 1) * D * F;
    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int idx = threadIdx.x; idx < BM * BK; idx += NT) {
        const int r = idx / BK, kk = idx % BK;
        const int row = r0 + r, kx = k0 + kk;
        As[kk][r] = (row < r1 && kx < D) ? rt::to_f(lhs[(size_t)row * D + kx]) : 0.f;
      }
      for (int idx = threadIdx.x; idx < BK * BN; idx += NT) {
        const int kk = idx / BN, n = idx % BN;
        const int kx = k0 + kk, col = n0 + n;
        Bs[kk][n] = (kx < D && col < F) ? rt::to_f(W[(size_t)kx * F + col]) : 0.f;
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
      if (col < F) out[(size_t)row * F + col] = rt::from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM>
void launch(const void* lhs, const void* rhs, const int* offsets, void* out,
            int Tn, int D, int F, int E, cudaStream_t s) {
  dim3 grid((Tn + BM - 1) / BM + E + 2, (F + BN - 1) / BN);
  gmm_kernel<T, BM><<<grid, NT, 0, s>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs), offsets,
      static_cast<T*>(out), Tn, D, F, E);
}

template <typename T>
void dispatch_bm(const void* lhs, const void* rhs, const int* offsets,
                 void* out, int Tn, int D, int F, int E, cudaStream_t s) {
  // Few rows per group (decode): small row tiles waste fewer FMAs on rows
  // that belong to no group of the tile.
  if (Tn <= 16 * E) {
    launch<T, 16>(lhs, rhs, offsets, out, Tn, D, F, E, s);
  } else {
    launch<T, 64>(lhs, rhs, offsets, out, Tn, D, F, E, s);
  }
}

}  // namespace

// lhs: [T,D], rhs: [E,D,F], out: [T,F] contiguous, one dtype (code);
// offsets: [E+1] int32 on the device.  Returns the CUDA error code (0 = ok).
extern "C" int grouped_matmul_launch(const void* lhs, const void* rhs,
                                     const void* offsets, void* out, int T,
                                     int D, int F, int E, int dtype,
                                     void* stream) {
  if (E <= 0 || E > kMaxExperts || (F + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* offs = static_cast<const int*>(offsets);
  if (dtype == rt::kF32) {
    dispatch_bm<float>(lhs, rhs, offs, out, T, D, F, E, s);
  } else if (dtype == rt::kBF16) {
    dispatch_bm<__nv_bfloat16>(lhs, rhs, offs, out, T, D, F, E, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
