// Flash-attention forward (FA2-style, online softmax) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_attn_kernel /
// flash_attention_kernel) and keeps its contract: q [B,Sq,H,Dh], k/v
// [B,Sk,KV,Dh]; GQA kv head = h / (H/KV); causal masks kj <= qi with no Sk-Sq
// offset, so causal needs Sq == Sk (rejected otherwise); running max, sum and
// accumulator in f32; a row with no valid key gives 0; out in q's dtype.
//
// Bound: at the prefill shape (Sq = Sk = 512, Dh = 64) the work is ~S*Dh*4
// flops per q element against a few bytes, so it is bound by operations; this
// first version uses the f32 FMA pipes (no tensor cores, so f32 inputs keep
// full f32 precision) and is far from the bf16 tensor-core bound.
// Design: one 256-thread block per (b*h, 64-row q block); 4 threads per query
// row, each holding Dh/4 interleaved dims of q and of the accumulator, the
// q.k partial dots summed with two xor shuffles.  K and V tiles of 32 keys are
// staged in shared memory as f32; key tiles wholly above the diagonal are not
// visited.  K/V are never repeated per q head.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per shared-memory tile
constexpr int G = 4;          // threads per query row
constexpr int NT = BQ * G;    // threads per block
constexpr float NEG_INF = -1e30f;

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, float scale, int causal) {
  constexpr int DP = DH / G;
  __shared__ float Ks[BK][DH];
  __shared__ float Vs[BK][DH];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int part = threadIdx.x % G;
  const int qi = q0 + threadIdx.x / G;
  const bool row_ok = qi < Sq;

  float qr[DP], acc[DP];
  const T* qp = q + (((size_t)b * Sq + (row_ok ? qi : 0)) * H + h) * DH;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = row_ok ? rt::to_f(qp[part + G * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * DH; idx += NT) {
      const int j = idx / DH, d = idx % DH;
      const int kj = k0 + j;
      const bool ok = kj < Sk;
      const size_t off = (((size_t)b * Sk + (ok ? kj : 0)) * KV + kvh) * DH + d;
      Ks[j][d] = ok ? rt::to_f(k[off]) : 0.f;
      Vs[j][d] = ok ? rt::to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) dot = fmaf(qr[i], Ks[j][part + G * i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kj = k0 + j;
      const bool ok = kj < Sk && (!causal || kj <= qi);
      s[j] = ok ? dot * scale : NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = (s[j] == NEG_INF) ? 0.f : expf(s[j] - m_new);
      psum += s[j];
    }
    l = alpha * l + psum;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(s[j], Vs[j][part + G * i], acc[i]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = (l == 0.f) ? 1.f : l;
    T* op = o + (((size_t)b * Sq + qi) * H + h) * DH;
#pragma unroll
    for (int i = 0; i < DP; ++i) op[part + G * i] = rt::from_f<T>(acc[i] / denom);
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
            int Sk, int H, int KV, float scale, int causal, cudaStream_t s) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, DH><<<grid, NT, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, scale,
      causal);
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Sk, int H, int KV, int Dh, float scale, int causal,
                cudaStream_t s) {
  if (Dh == 64) {
    launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal, s);
  } else if (Dh == 128) {
    launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// q, o: [B,Sq,H,Dh]; k, v: [B,Sk,KV,Dh]; all contiguous, one dtype (code).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KV, int Dh,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (KV <= 0 || H % KV != 0 || (causal && Sq != Sk) || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == rt::kF32) {
    rc = dispatch_dh<float>(q, k, v, o, B, Sq, Sk, H, KV, Dh, scale, causal, s);
  } else if (dtype == rt::kBF16) {
    rc = dispatch_dh<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, Dh, scale,
                                    causal, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
