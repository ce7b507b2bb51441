// Flash-attention forward (FA2-style, online softmax) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_attn_kernel /
// flash_attention_kernel) and keeps its contract: q [B,Sq,H,Dh], k/v
// [B,Sk,KV,Dh]; GQA kv head = h / (H/KV); causal masks kj <= qi with no Sk-Sq
// offset, so causal needs Sq == Sk (rejected otherwise); running max, sum and
// accumulator in f32; a row with no valid key gives 0; out in q's dtype.
// Beyond the TPU kernel: a sliding window (window > 0, causal only) also
// masks kj <= qi - window, as repro.models.layers._causal_mask does; key
// tiles wholly below every row's window are not visited, as tiles wholly
// above the diagonal are not.  Head dims 64, 96 and 128 are built.
//
// bf16.  Bound: at the prefill shape (q [8,512,16,64], k/v [8,512,8,64],
// causal) the function moves 25 MB (0.0075 ms at 3.35 TB/s) and needs 4.3
// GFLOP for the pairs kj <= qi (0.0044 ms at 989 TFLOP/s), so bytes bound
// it.  Three routes, chosen by shape in ops.attention_plan and passed in
// (Route, checked against the shape here): flash_wgmma_kernel (below)
// wherever a (b, kv head) has 64 rows or more; the split decode route
// (flash_decode_split_kernel, then flash_decode_merge_kernel) where it has
// at most 16, not causal, with 128 keys or more; flash_mma_kernel for the
// rest (rows 17 to 63, causal decode-sized shapes, Sk 0 or few keys, a
// scale that is not positive).
//
// flash_wgmma_kernel (wgmma and TMA, Hopper's own): one block per (tile of
// 64 NWG rows, b, kv head), rows as below; each warpgroup owns 64 rows.
// Q arrives by one TMA load (a 4-D map (Dh, H, Sq, B), box 64 columns x G
// heads x ROWS/G queries, so shared memory holds the rows in order) and
// stays; K and V tiles of TK keys stream through a ring of NS stages of
// 128-byte-swizzled 64-column TMA boxes, each stage with a full mbarrier,
// refilled by the last warpgroup to release it.  S = Q K^T is wgmma
// m64nTKk16 with both operands K-major in shared memory; O += P V is wgmma
// m64n(Dh)k16 with P packed to bf16 in registers as the A operand (the
// accumulator's layout is mma.sync's C fragment, so the softmax below
// carries over) and V MN-major.  Tile i's S is issued before tile i - 1's
// P V, so a warpgroup's softmax runs while its P V is on the tensor cores.
// Dh 96 loads a second box with 32 real columns (the rest zero fill) and
// stops its k-steps at 96.  Rows and keys past the ends arrive as zero
// fill and are masked; the output is staged in the warpgroup's own Q rows
// and stored in 16-byte rows.  Deterministic: each output element has one
// owner and a fixed order, no atomics on data.
//
// flash_mma_kernel (FA2 on mma.sync m16n8k16): one block per (b, kv head,
// tile of rows), where a row is a (query, q head of the GQA group) pair,
// query-major, so the block serves every q head of the group from the same
// K/V tiles.  Each warp owns 16 MT rows (MT = 2 at Dh 64, 1 at Dh 128):
// each K and V fragment it loads from shared memory feeds MT mma tiles,
// which halves the shared-memory reads per flop at Dh 64.  4 warps a
// block: at Dh 64 a block has 128 rows (64 queries of granite's 2-head
// groups) and two blocks share an SM, so one block's first loads and last
// stores overlap the other's tiles; 8 warps (128 queries, each K/V byte
// read half as often) measured slower, because one such block fills the
// register file.  Q goes from shared memory to registers once (ldmatrix).
// K/V tiles of 64 keys stream through a ring of cp.async 16-byte copies,
// later tiles in flight while the tensor cores work on this one.  Row
// tiles start in reverse order, so those with the most keys start first.
// S = Q K^T lands in f32 registers; only tiles that cross a warp's
// diagonal, a window's edge or the end of the keys are masked, and tiles
// wholly above the diagonal or below the window are skipped.  The online
// softmax runs on the C-fragment rows with quad shuffles and ex2.approx on a
// log2(e)-prescaled scale.  P is packed to
// bf16 in registers as the A operand of P V (no shared-memory round trip),
// and V goes through ldmatrix.trans.  The output is normalised, rounded
// once to bf16, staged in the warp's own Q rows and stored in 16-byte rows.
//
// The split decode route (flash-decoding) replaces the same TPU kernel at
// few rows: whisper-medium's decoder cross-attention at every token, q
// [8,1,16,64] against k/v [8,1500,16,64], one row a (b, kv head).  Bytes
// bound it: 49 MB of K and V (0.0147 ms at 3.35 TB/s) against 0.2 GFLOP.
// flash_mma_kernel gave that shape one block a (b, kv head), 128 blocks for
// 132 SMs, each streaming 24 key tiles through its ring one tile at a time
// (one real row of 128: a serial chain of waits).  Here the keys of a (b, kv
// head) are split across blocks (ops.attention_plan: runs of 2 or 3 whole
// 64-key tiles, so 2 to 4 blocks share an SM, and enough runs to fill the
// card, none empty); a block's warps own tiles, not rows, and every copy of
// the block is in flight before its first S, read under L2 evict-first so
// the stream recycles its own lines rather than the cache's dirty ones.
// Each split writes its partial softmax (m, l and the unnormalised
// accumulator, f32), and a second launch, placed early as the split's
// programmatic dependent, merges them in split order, so two calls give the
// same bits.  The fragment code (S, the online softmax, P V) is
// flash_mma_kernel's (mma_scores, online_softmax, mma_pv).
//
// Dh 96 (phi-3-vision): the same tiling as Dh 128, one m16 tile a warp; Q K^T
// takes 6 k-steps of 16 and P V 12 n-tiles of 8; a 192-byte row is 12
// cp.async copies, and the padded 208-byte smem row keeps ldmatrix free of
// bank conflicts.
//
// f32: the FMA kernel, so f32 inputs keep full f32 precision.  One
// 256-thread block per (b*h, 64-row q block); 4 threads per query row, each
// holding Dh/4 interleaved dims of q and of the accumulator, the q.k
// partial dots summed with two xor shuffles.  K and V tiles of 32 keys are
// staged in shared memory as f32; key tiles wholly above the diagonal, or
// wholly below the window of the block's first row, are not visited.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per shared-memory tile
constexpr int G = 4;          // threads per query row
constexpr int NT = BQ * G;    // threads per block
constexpr float NEG_INF = -1e30f;

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 float scale, int causal, int window) {
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

  const bool windowed = causal && window > 0;
  // the first key of the block's first row's window, down to its tile
  const int k_begin = windowed ? max(0, q0 - window + 1) / BK * BK : 0;
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
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
      const bool ok = kj < Sk && (!causal || kj <= qi) &&
                      (!windowed || kj > qi - window);
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
    if (lse != nullptr && part == 0)
      lse[((size_t)b * H + h) * Sq + qi] = l > 0.f ? m + logf(l) : INFINITY;
  }
}

// ------------------------------------------------- bf16 (tensor cores)
constexpr int TK = 64;        // keys per K/V tile
constexpr float kNegInf = -__builtin_huge_valf();

template <int DH>
struct MmaCfg {
  // Dh 96 and 128 hold one m16 tile a warp: two would not fit the registers
  static constexpr int MT = DH == 64 ? 2 : 1;     // m16 tiles per warp
  static constexpr int NW = 4;                    // warps per block
  static constexpr int WR = 16 * MT;              // rows per warp
  static constexpr int ROWS = WR * NW;            // (query, head) rows
  static constexpr int LD = DH + 8;               // padded smem row
  static constexpr int Q_BYTES = ROWS * LD * 2;
  static constexpr int KV_BYTES = TK * LD * 2;    // one K or V tile
  static constexpr int NS = DH == 64 ? 4 : 3;     // K/V ring stages
  static constexpr int SMEM = Q_BYTES + NS * 2 * KV_BYTES;
};

// The fragment code of the mma.sync kernels (flash_mma_kernel and the split
// decode route): one warp, MT m16 tiles of rows, one TK-key tile of K and V
// in shared memory in padded rows of LD elements (ldmatrix, bank-conflict
// free).  C fragments: this lane holds rows 16 mt + g (e 0, 1) and + 8 (e 2,
// 3), keys (or columns) 8 i + 2 t + (e & 1).

// s = Q K^T for the tile whose K rows start at sk: each K fragment feeds
// every m16 tile of the warp
template <int DH, int MT, int LD>
__device__ __forceinline__ void mma_scores(
    float (&s)[MT][TK / 8][4], const uint32_t (&qf)[MT][DH / 16][4],
    uint32_t sk, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < TK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][i][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < TK / 16; ++np) {
      uint32_t kb[4];
      hw::ldmatrix_x4(kb, sk + ((np * 16 + lane % 8 + 8 * (lane / 16)) * LD
                                + ks * 16 + 8 * ((lane / 8) % 2)) * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        hw::mma_bf16(s[mt][2 * np], qf[mt][ks], kb[0], kb[1]);
        hw::mma_bf16(s[mt][2 * np + 1], qf[mt][ks], kb[2], kb[3]);
      }
    }
  }
}

// The online softmax on the fragment rows, in the log2 domain: s is scaled
// by scale_log2; where need_mask, the key kj = kt0 + 8 i + 2 t + (e & 1) of
// the row whose query is qi[mt][e / 2] is set to -inf when kj >= Sk, or
// above the diagonal (causal) or below the window (windowed); the row
// maxima m (shared by the lanes of a quad) and this lane's partial row sums
// l are updated, acc is rescaled, and s is left holding P = 2^(s - m).  A
// row with no key yet keeps m = -inf and P = 0.  The mask's terms are
// arguments, not a callback: with a callback nvcc gave each element a
// branch and two copies of the loop, and flash_mma_kernel<64> ran slower.
template <int DH, int MT>
__device__ __forceinline__ void online_softmax(
    float (&s)[MT][TK / 8][4], float (&m)[MT][2], float (&l)[MT][2],
    float (&acc)[MT][DH / 8][4], float scale_log2, bool need_mask, int kt0,
    int t, int Sk, const int (&qi)[MT][2], int causal, bool windowed,
    int window) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < TK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[mt][i][e] * scale_log2;
        if (need_mask) {
          const int kj = kt0 + 8 * i + 2 * t + (e & 1);
          const int qr = qi[mt][e / 2];
          if (kj >= Sk || (causal && kj > qr) ||
              (windowed && kj <= qr - window))
            x = kNegInf;
        }
        s[mt][i][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[mt][r], mx[r]);
      m_use[r] = m_new == kNegInf ? 0.f : m_new;
      alpha[r] = hw::ex2(m[mt][r] - m_use[r]);
      m[mt][r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < TK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mt][i][e] = hw::ex2(s[mt][i][e] - m_use[e / 2]);
        rs[e / 2] += s[mt][i][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      acc[mt][i][0] *= alpha[0];
      acc[mt][i][1] *= alpha[0];
      acc[mt][i][2] *= alpha[1];
      acc[mt][i][3] *= alpha[1];
    }
  }
}

// acc += P V for the tile whose V rows start at sv: P packed to bf16 A
// fragments in registers; each V fragment (ldmatrix.trans) feeds every m16
// tile of the warp
template <int DH, int MT, int LD>
__device__ __forceinline__ void mma_pv(float (&acc)[MT][DH / 8][4],
                                       const float (&s)[MT][TK / 8][4],
                                       uint32_t sv, int lane) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      pa[mt][0] = hw::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      pa[mt][1] = hw::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      pa[mt][2] = hw::pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      pa[mt][3] = hw::pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t vb[4];
      hw::ldmatrix_x4_trans(vb, sv + ((kk * 16 + lane % 16) * LD + dp * 16
                                      + 8 * (lane / 16)) * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        hw::mma_bf16(acc[mt][2 * dp], pa[mt], vb[0], vb[1]);
        hw::mma_bf16(acc[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(MmaCfg<DH>::NW * 32, 1)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int H, int KV, float scale_log2, int causal,
                 int window) {
  using C = MmaCfg<DH>;
  constexpr int NT = C::NW * 32, LD = C::LD, CH = DH / 8;  // 16-byte chunks
  constexpr int MT = C::MT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sq = hw::smem_u32(smem_raw);
  auto sk = [&](int buf) { return sq + C::Q_BYTES + buf * 2 * C::KV_BYTES; };
  auto sv = [&](int buf) { return sk(buf) + C::KV_BYTES; };

  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  // row tiles in reverse, so the tiles with the most keys start first
  const int p0 = (gridDim.y - 1 - blockIdx.y) * C::ROWS;  // first row
  const int n_rows = Sq * G;
  const int q_last = min(n_rows - 1, p0 + C::ROWS - 1) / G;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const bool windowed = causal && window > 0;
  // tiles j0 .. n_tiles - 1: from the tile of the first key in the window of
  // the block's first row, to the diagonal of its last
  const int j0 = windowed ? max(0, p0 / G - window + 1) / TK : 0;
  const int n_tiles = (k_end + TK - 1) / TK;
  const int nt = n_tiles - j0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // global element offset of (query, head) row p (p < n_rows)
  auto row_off = [&](int p) {
    return (((size_t)b * Sq + p / G) * H + kvh * G + p % G) * DH;
  };
  auto load_kv = [&](int tile, int buf) {
    for (int c = tid; c < TK * CH; c += NT) {
      const int r = c / CH, d = (c % CH) * 8, kj = tile * TK + r;
      const bool ok = kj < Sk;
      const size_t off = (((size_t)b * Sk + (ok ? kj : 0)) * KV + kvh) * DH + d;
      hw::cp_async16(sk(buf) + (r * LD + d) * 2, k + off, ok);
      hw::cp_async16(sv(buf) + (r * LD + d) * 2, v + off, ok);
    }
  };

  for (int c = tid; c < C::ROWS * CH; c += NT) {
    const int r = c / CH, d = (c % CH) * 8, p = p0 + r;
    const bool ok = p < n_rows;
    hw::cp_async16(sq + (r * LD + d) * 2, q + (ok ? row_off(p) : 0) + d, ok);
  }
  // group s holds K/V tile j0 + s (and group 0 the Q tile too)
#pragma unroll
  for (int s = 0; s < C::NS - 1; ++s) {
    if (s < nt) load_kv(j0 + s, s);
    hw::cp_async_commit();
  }

  // the warp's rows: this thread holds rows 16 mt + g and 16 mt + g + 8
  const int wp = p0 + C::WR * warp;
  const int w_first = wp / G, w_last = (wp + C::WR - 1) / G;
  int qi[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    qi[mt][0] = (wp + 16 * mt + g) / G;
    qi[mt][1] = (wp + 16 * mt + g + 8) / G;
  }

  uint32_t qf[MT][DH / 16][4];
  float acc[MT][DH / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = kNegInf;
      l[mt][r] = 0.f;
    }

  for (int jj = 0; jj < nt; ++jj) {
    const int buf = jj % C::NS;
    hw::cp_async_wait<C::NS - 2>();
    __syncthreads();          // tile j0 + jj landed; the one before is consumed
    if (jj + C::NS - 1 < nt)
      load_kv(j0 + jj + C::NS - 1, (jj + C::NS - 1) % C::NS);
    hw::cp_async_commit();
    if (jj == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks)
          hw::ldmatrix_x4(qf[mt][ks],
                          sq + ((C::WR * warp + 16 * mt + lane % 16) * LD
                                + ks * 16 + (lane / 16) * 8) * 2);
    }
    const int kt0 = (j0 + jj) * TK;
    if (causal && kt0 > w_last) continue;   // wholly above the diagonal
    // wholly below the window of every row of the warp
    if (windowed && kt0 + TK - 1 <= w_first - window) continue;

    float s[MT][TK / 8][4];
    mma_scores<DH, MT, LD>(s, qf, sk(buf), lane);
    // mask only tiles that cross the end of the keys, a diagonal or a
    // window's edge
    const bool need_mask = kt0 + TK > Sk || (causal && kt0 + TK - 1 > w_first)
                           || (windowed && kt0 <= w_last - window);
    online_softmax<DH, MT>(s, m, l, acc, scale_log2, need_mask, kt0, t, Sk,
                           qi, causal, windowed, window);
    mma_pv<DH, MT, LD>(acc, s, sv(buf), lane);
  }

  // normalise, round once, stage in this warp's own Q rows, store rows
  hw::cp_async_wait<0>();
  __syncthreads();                    // no copy into Q is still in flight
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(smem_raw)
                       + C::WR * warp * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[mt][r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      inv[r] = lt > 0.f ? 1.f / lt : 0.f;
      // the row's logsumexp (natural log) for the backward: m is in log2
      // units of the scaled scores
      const int p = wp + 16 * mt + g + 8 * r;
      if (lse != nullptr && t == 0 && p < n_rows)
        lse[((size_t)b * H + kvh * G + p % G) * Sq + p / G] =
            lt > 0.f ? (m[mt][r] + log2f(lt)) * 0.6931471805599453f
                     : INFINITY;
    }
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      const int col = 8 * i + 2 * t, row = 16 * mt + g;
      *reinterpret_cast<uint32_t*>(stg + row * LD + col) =
          hw::pack_bf16(acc[mt][i][0] * inv[0], acc[mt][i][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(stg + (row + 8) * LD + col) =
          hw::pack_bf16(acc[mt][i][2] * inv[1], acc[mt][i][3] * inv[1]);
    }
  }
  __syncwarp();
  for (int c = lane; c < C::WR * CH; c += 32) {
    const int r = c / CH, d = (c % CH) * 8, p = wp + r;
    if (p < n_rows)
      *reinterpret_cast<uint4*>(o + row_off(p) + d) =
          *reinterpret_cast<const uint4*>(stg + r * LD + d);
  }
}

// ------------------------------------------- bf16 (split-key decode route)
// One (b, kv head) with few rows (Sq G <= 16, one m16 tile) and many keys:
// the keys are split across blocks, each writing a partial softmax, and a
// second launch merges the partials in order (flash-decoding).
template <int DH>
struct DecodeCfg {
  static constexpr int LD = DH + 8;               // padded smem row
  static constexpr int KV_BYTES = TK * LD * 2;    // one K or V tile
  static constexpr int PAIR = 2 * KV_BYTES;       // a tile's K, then its V
  static constexpr int MAX_WARPS = 4;
  // 64-key tiles a split at most: all of a block's tiles are in shared
  // memory at once (147, 160 and 139 KB)
  static constexpr int MAX_TILES = DH == 64 ? 8 : DH == 96 ? 6 : 4;
  static constexpr int RLD = DH + 8;              // padded row of a warp's acc
};

// Grid (split, b * KV + kv head); blockDim 32 min(tiles a split, MAX_WARPS).
// The block takes keys [split keys, min(Sk, (split + 1) keys)) of its (b, kv
// head), in tiles of TK, and every row of the (b, kv head): p = query G +
// head of the group, query-major, as flash_mma_kernel orders them.  Warp w
// owns tiles w, w + nw, ...: it issues all of their cp.async copies at once
// (keys past Sk zero-filled; a commit group a tile), loads Q's fragments
// from global memory while they fly, then runs mma_scores, online_softmax
// (keys past Sk masked) and mma_pv on each of its tiles as it lands.  The
// launch lets the merge be scheduled at once.  The warps' (m, l, acc) are
// combined in shared memory, each row's terms summed in warp order, and the
// block writes its split's partial: part[(bkv splits + split) n_rows +
// p][DH] (acc, unnormalised) and stat[...][2] (m in log2 units of the
// scaled scores, l).  A split with no valid key would write m = -inf, l = 0.
template <int DH>
__global__ void __launch_bounds__(DecodeCfg<DH>::MAX_WARPS * 32)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          float* __restrict__ part, float* __restrict__ stat,
                          int Sq, int Sk, int H, int KV, float scale_log2,
                          int keys) {
  using C = DecodeCfg<DH>;
  constexpr int LD = C::LD, CH = DH / 8;          // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t s0 = hw::smem_u32(smem_raw);
  const int split = blockIdx.x, bkv = blockIdx.y;
  const int G = H / KV, b = bkv / KV, kvh = bkv % KV;
  const int n_rows = Sq * G;
  const int k0 = split * keys;
  const int nt = (min(Sk, k0 + keys) - k0 + TK - 1) / TK;
  const int nw = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the merge may be scheduled now; it waits for this grid's writes
  hw::griddep_launch_dependents();

  // K and V are read once: evict-first, so they recycle their own L2 lines.
  // One commit group a tile, in the order the warp takes them.
  const uint64_t once = hw::l2_evict_first();
  for (int j = warp; j < nt; j += nw) {
    const uint32_t sk = s0 + j * C::PAIR, sv = sk + C::KV_BYTES;
    for (int c = lane; c < TK * CH; c += 32) {
      const int r = c / CH, d = (c % CH) * 8, kj = k0 + j * TK + r;
      const bool ok = kj < Sk;
      const size_t off = (((size_t)b * Sk + (ok ? kj : 0)) * KV + kvh) * DH + d;
      hw::cp_async16(sk + (r * LD + d) * 2, k + off, ok, once);
      hw::cp_async16(sv + (r * LD + d) * 2, v + off, ok, once);
    }
    hw::cp_async_commit();
  }

  // Q's A fragments (flash_mma_kernel's ldmatrix layout): rows g and g + 8,
  // columns 2 t and 2 t + 8 of each 16-column step; rows past n_rows zero
  uint32_t qf[1][DH / 16][4];
  const uint32_t* qrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = g + 8 * r;
    qrow[r] = p < n_rows ? reinterpret_cast<const uint32_t*>(
        q + (((size_t)b * Sq + p / G) * H + kvh * G + p % G) * DH) : nullptr;
  }
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t* row = qrow[e % 2];
      qf[0][ks][e] = row ? row[ks * 8 + t + 4 * (e / 2)] : 0u;
    }

  constexpr int kNoRows[1][2] = {{0, 0}};    // the rows' queries: unread
  float acc[1][DH / 8][4], m[1][2], l[1][2];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][i][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[0][r] = kNegInf;
    l[0][r] = 0.f;
  }
  const int mine = nt > warp ? (nt - warp + nw - 1) / nw : 0;   // my tiles
  for (int j = warp, i = 0; j < nt; j += nw, ++i) {
    // my tile i landed (the ones after it may still be in flight)
    hw::cp_async_wait_dyn(mine - 1 - i);
    __syncwarp();
    const uint32_t sk = s0 + j * C::PAIR;
    const int kt0 = k0 + j * TK;
    float s[1][TK / 8][4];
    mma_scores<DH, 1, LD>(s, qf, sk, lane);
    // no diagonal and no window: only the end of the keys is masked
    online_softmax<DH, 1>(s, m, l, acc, scale_log2, kt0 + TK > Sk, kt0, t,
                          Sk, kNoRows, 0, false, 0);
    mma_pv<DH, 1, LD>(acc, s, sk + C::KV_BYTES, lane);
  }

  // combine the warps: M = max m_w, each warp's acc and l scaled by
  // 2^(m_w - M) (0 for a warp that saw no key), summed in warp order
  float lt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lt[r] = l[0][r];
    lt[r] += __shfl_xor_sync(0xffffffffu, lt[r], 1);
    lt[r] += __shfl_xor_sync(0xffffffffu, lt[r], 2);
  }
  __syncthreads();                    // no warp reads its tiles any more
  float* red = reinterpret_cast<float*>(smem_raw);     // [nw][16][RLD]
  float* rst = red + nw * 16 * C::RLD;                 // [nw][16] (m, l)
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rst[(warp * 16 + g + 8 * r) * 2] = m[0][r];
      rst[(warp * 16 + g + 8 * r) * 2 + 1] = lt[r];
    }
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float M = kNegInf;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, rst[(w * 16 + g + 8 * r) * 2]);
    f[r] = hw::ex2(m[0][r] - (M == kNegInf ? 0.f : M));
  }
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    float* row = red + (warp * 16 + g) * C::RLD + 8 * i + 2 * t;
    *reinterpret_cast<float2*>(row) =
        make_float2(acc[0][i][0] * f[0], acc[0][i][1] * f[0]);
    *reinterpret_cast<float2*>(row + 8 * C::RLD) =
        make_float2(acc[0][i][2] * f[1], acc[0][i][3] * f[1]);
  }
  __syncthreads();
  const size_t base = ((size_t)bkv * gridDim.x + split) * n_rows;
  for (int c = threadIdx.x; c < n_rows * (DH / 4); c += blockDim.x) {
    const int row = c / (DH / 4), col = (c % (DH / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < nw; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(
          red + (w * 16 + row) * C::RLD + col);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    *reinterpret_cast<float4*>(part + (base + row) * DH + col) = a;
  }
  for (int row = threadIdx.x; row < n_rows; row += blockDim.x) {
    float M = kNegInf, L = 0.f;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, rst[(w * 16 + row) * 2]);
    const float mu = M == kNegInf ? 0.f : M;
    for (int w = 0; w < nw; ++w)
      L += rst[(w * 16 + row) * 2 + 1] * hw::ex2(rst[(w * 16 + row) * 2] - mu);
    stat[(base + row) * 2] = M;
    stat[(base + row) * 2 + 1] = L;
  }
}

// One thread a (row, 8 columns), rows = B H Sq in the split kernel's order
// (b, kv head, p): M = max m_s, L = sum l_s 2^(m_s - M), O = sum acc_s
// 2^(m_s - M) / L, summed over s = 0, 1, ... in order, a split with m_s =
// -inf (no valid key) adding nothing; O rounded once to bf16 and stored in
// 16-byte rows; the row's logsumexp (natural log, +inf where L = 0) into lse
// when given.  A row with no key gets 0.  Launched as the split kernel's
// programmatic dependent, so it may be resident before that grid ends and
// waits for its writes first.
template <int DH>
__global__ void __launch_bounds__(256)
flash_decode_merge_kernel(const float* __restrict__ part,
                          const float* __restrict__ stat,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int H, int KV,
                          int splits, long rows) {
  constexpr int CH = DH / 8;
  hw::griddep_wait();
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * CH) return;
  const long r = idx / CH;
  const int c = (int)(idx % CH);
  const int G = H / KV, n_rows = Sq * G;
  const long bkv = r / n_rows;
  const int p = (int)(r % n_rows);
  const size_t r0 = (size_t)bkv * splits * n_rows + p;   // split 0's row
  // M over every split, then the sums in split order.  The partials are
  // loaded CHUNK splits at a time, all in flight together, and the first
  // chunk's stay in registers between the two passes, so up to CHUNK
  // splits take one round trip to memory.
  constexpr int CHUNK = 8;
  float2 ml[CHUNK];
  float4 x[CHUNK][2];
  auto load = [&](int s0) {
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const size_t row = r0 + (size_t)(s0 + u) * n_rows;
      const bool in = s0 + u < splits;
      const float4* src =
          reinterpret_cast<const float4*>(part + row * DH + 8 * c);
      ml[u] = in ? *reinterpret_cast<const float2*>(stat + row * 2)
                 : make_float2(kNegInf, 0.f);
      x[u][0] = in ? src[0] : make_float4(0.f, 0.f, 0.f, 0.f);
      x[u][1] = in ? src[1] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load(0);
  float M = kNegInf;
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) M = fmaxf(M, ml[u].x);
  for (int s0 = CHUNK; s0 < splits; s0 += CHUNK) {
    float ms[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u)
      ms[u] = s0 + u < splits ? stat[(r0 + (size_t)(s0 + u) * n_rows) * 2]
                              : kNegInf;
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) M = fmaxf(M, ms[u]);
  }
  float L = 0.f, a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < splits; s0 += CHUNK) {
    if (s0 > 0) load(s0);
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      // a split with no valid key (m = -inf, l = 0, acc 0), and a slot
      // past the last split, add nothing
      const float f = ml[u].x == kNegInf ? 0.f : hw::ex2(ml[u].x - M);
      L += ml[u].y * f;
      a[0] += x[u][0].x * f;
      a[1] += x[u][0].y * f;
      a[2] += x[u][0].z * f;
      a[3] += x[u][0].w * f;
      a[4] += x[u][1].x * f;
      a[5] += x[u][1].y * f;
      a[6] += x[u][1].z * f;
      a[7] += x[u][1].w * f;
    }
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
  uint4 out;
  out.x = hw::pack_bf16(a[0] * inv, a[1] * inv);
  out.y = hw::pack_bf16(a[2] * inv, a[3] * inv);
  out.z = hw::pack_bf16(a[4] * inv, a[5] * inv);
  out.w = hw::pack_bf16(a[6] * inv, a[7] * inv);
  const int b = (int)(bkv / KV), kvh = (int)(bkv % KV);
  const int h = kvh * G + p % G, qi = p / G;
  *reinterpret_cast<uint4*>(o + (((size_t)b * Sq + qi) * H + h) * DH + 8 * c) =
      out;
  if (lse != nullptr && c == 0)
    lse[((size_t)b * H + h) * Sq + qi] =
        L > 0.f ? (M + log2f(L)) * 0.6931471805599453f : INFINITY;
}

// ------------------------------------------ bf16 (wgmma and TMA, Hopper)
// NWG warpgroups of 64 rows, TK keys a K/V tile, NS ring stages, MINB
// blocks an SM (__launch_bounds__)
template <int DH, int NWG_, int TK_, int NS_, int MINB_>
struct WgShape {
  static constexpr int NWG = NWG_, TK = TK_, NS = NS_, MINB = MINB_;
  static constexpr int SPANS = (DH + 63) / 64;    // 64-column (128-byte) spans
  static constexpr int ROWS = 64 * NWG;           // rows per block, at most
  static constexpr int THREADS = 128 * NWG;
  static constexpr int Q_SPAN = ROWS * 128;       // bytes of a Q span
  static constexpr int KV_SPAN = TK * 128;        // bytes of a K or V span
  static constexpr int Q_BYTES = SPANS * Q_SPAN;
  static constexpr int STAGE = 2 * SPANS * KV_SPAN;   // K's spans, then V's
  static constexpr int SMEM = 1024 + Q_BYTES + NS * STAGE + (NS + 1) * 8 + NS * 4;
};
// Chosen by timing the kernel table's rows on the H100 (chip_smoke.py
// prints each kernel's registers): Dh 64 two blocks of 2 warpgroups an SM
// (16 warps leave a thread 128 registers), 64-key tiles; Dh 96 one block
// of 4 warpgroups, 64-key tiles; Dh 128 one block of 2 warpgroups,
// 128-key tiles (its accumulators do not fit 128 registers).
template <int DH> struct WgCfg;
template <> struct WgCfg<64> : WgShape<64, 2, 64, 4, 2> {};
template <> struct WgCfg<96> : WgShape<96, 4, 64, 4, 1> {};
template <> struct WgCfg<128> : WgShape<128, 2, 128, 3, 1> {};

// One block per (tile of up to 64 NWG rows, b, kv head); rows as in
// flash_mma_kernel.  Warpgroup wg owns rows 64 wg .. 64 wg + 63 of the
// tile.  Shared memory, 1024-byte aligned: Q's spans (ROWS rows of 128
// bytes each, 128-byte swizzled, as TMA writes them), then NS stages of K's
// spans and V's spans (TK key rows of 128 bytes each), then the stages'
// full barriers, Q's barrier and the stages' release counts.  No producer
// warp (it would cost every thread registers): thread 0 loads Q and the
// first NS tiles, and the last warpgroup to release a stage loads the tile
// NS on into it.
template <int DH>
__global__ void __launch_bounds__(WgCfg<DH>::THREADS, WgCfg<DH>::MINB)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int Sq, int Sk, int H, int KV, float scale_log2,
                   int causal, int window) {
  using C = WgCfg<DH>;
  constexpr int TK = C::TK, NS = C::NS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sq = (hw::smem_u32(smem_raw) + 1023u) & ~1023u;
  auto sk = [&](int s) { return sq + C::Q_BYTES + s * C::STAGE; };
  auto sv = [&](int s) { return sk(s) + C::SPANS * C::KV_SPAN; };
  const uint32_t bars = sq + C::Q_BYTES + NS * C::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  const uint32_t qbar = bars + 8 * NS;
  uint32_t* released = reinterpret_cast<uint32_t*>(
      smem_raw + (bars - hw::smem_u32(smem_raw)) + 8 * (NS + 1));

  const int G = H / KV;
  const int qpb = C::ROWS / G;           // queries a block
  const int rows = qpb * G;              // its rows (ROWS when G divides it)
  // row tiles vary fastest, so the blocks that read one head's K and V run
  // together (it comes from device memory once); in reverse, so the tiles
  // with the most keys start first
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int s0 = (gridDim.x - 1 - blockIdx.x) * qpb;    // first query
  const int p0 = s0 * G;                                // first row
  const int n_rows = Sq * G;
  const int q_last = min(n_rows - 1, p0 + rows - 1) / G;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const bool windowed = causal && window > 0;
  // key tiles j0 .. j0 + nt - 1: from the tile of the first key in the window
  // of the block's first query to the diagonal of its last (Sk > 0: nt >= 1)
  const int j0 = windowed ? max(0, s0 - window + 1) / TK : 0;
  const int nt = (k_end + TK - 1) / TK - j0;

  auto load_kv = [&](int it) {           // tile j0 + it into its stage
    const int s = it % NS, k0 = (j0 + it) * TK;
    hw::mbar_expect_tx(full(s), C::STAGE);
#pragma unroll
    for (int c = 0; c < C::SPANS; ++c) {
      hw::tma_load_4d(sk(s) + c * C::KV_SPAN, &map_k, full(s), 64 * c, kvh, k0,
                      b);
      hw::tma_load_4d(sv(s) + c * C::KV_SPAN, &map_v, full(s), 64 * c, kvh, k0,
                      b);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hw::mbar_init(full(s), 1);
      released[s] = 0;
    }
    hw::mbar_init(qbar, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hw::mbar_expect_tx(qbar, C::SPANS * rows * 128);
#pragma unroll
    for (int c = 0; c < C::SPANS; ++c)
      hw::tma_load_4d(sq + c * C::Q_SPAN, &map_q, qbar, 64 * c, kvh * G, s0, b);
    for (int it = 0; it < min(nt, NS); ++it) load_kv(it);
  }

  // the warpgroup, broadcast from lane 0 so that the compiler knows it is
  // warp-uniform: branches on it are not divergent, and the wgmma after
  // them stay asynchronous
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the warpgroup's rows; this thread holds rows 16 warp + g and + 8
  const int wp = p0 + 64 * wg;
  const int w_first = wp / G, w_last = (wp + 63) / G;
  const int qi[2] = {(wp + 16 * warp + g) / G, (wp + 16 * warp + g + 8) / G};

  float acc[DH / 2], sc[TK / 2];
  uint32_t pa[TK / 16][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  hw::mbar_wait_uniform(qbar, 0);

  // S = Q K^T for tile it: the warpgroup's 64 Q rows against TK keys, k16
  // steps along the head dim (32 bytes within a span; Dh 96 stops half way
  // through its second span); committed, not waited on
  auto issue_s = [&](int it) {
    const uint32_t kb = sk(it % NS);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = hw::wgmma_desc(
          sq + (kk / 4) * C::Q_SPAN + wg * 8192 + off, 16, 1024);
      const uint64_t db = hw::wgmma_desc(kb + (kk / 4) * C::KV_SPAN + off,
                                         16, 1024);
      hw::wgmma_ss_kmajor<TK>(sc, da, db, kk > 0);
    }
    hw::wgmma_commit();
    hw::fence_regs(sc);
  };
  // O += P V for tile it: P (pa) the A operand in registers (the
  // accumulator columns 16 kk .. 16 kk + 15 are the A fragment of k16 step
  // kk); V MN-major, a k16 step 16 key rows (2048 bytes) on
  auto issue_pv = [&](int it) {
    const uint32_t vb = sv(it % NS);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      hw::wgmma_rs_mnmajor<DH>(
          acc, pa[kk], hw::wgmma_desc(vb + kk * 2048, C::KV_SPAN, 1024), 1);
    hw::wgmma_commit();
    hw::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) hw::fence_regs(pa[kk]);
  };
  auto fence_all = [&]() {
    hw::fence_regs(sc);
    hw::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) hw::fence_regs(pa[kk]);
  };
  // tile it's K and V are read: the last warpgroup to say so loads tile it
  // + NS into the stage
  auto release = [&](int it) {
    if (tid == 0) {
      const int s = it % NS;
      if (atomicAdd(&released[s], 1u) % C::NWG == C::NWG - 1 && it + NS < nt)
        load_kv(it + NS);
    }
  };
  // online softmax of tile it on the accumulator rows, in log2 units of the
  // scaled scores: the row maximum of the raw scores (the scale is
  // positive), then p = 2^(s scale - m) in one FFMA and ex2, into sc;
  // masked scores are -inf.  Returns O's factors in alpha.
  auto softmax = [&](int it, float (&alpha)[2]) {
    const int kt0 = (j0 + it) * TK;
    if (kt0 + TK > Sk || (causal && kt0 + TK - 1 > w_first) ||
        (windowed && kt0 <= w_last - window)) {
#pragma unroll
      for (int i = 0; i < TK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kt0 + 8 * i + 2 * t + (e & 1), qr = qi[e / 2];
          if (kj >= Sk || (causal && kj > qr) ||
              (windowed && kj <= qr - window))
            sc[4 * i + e] = kNegInf;
        }
      }
    }
    // four partial maxima and sums a row, for instruction-level parallelism
    float mx[2][4], rs[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r][j] = kNegInf;
        rs[r][j] = 0.f;
      }
#pragma unroll
    for (int i = 0; i < TK / 2; ++i)
      mx[(i % 4) / 2][(i / 4) % 4] = fmaxf(mx[(i % 4) / 2][(i / 4) % 4], sc[i]);
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x * scale_log2);
      m_use[r] = m_new == kNegInf ? 0.f : m_new;
      alpha[r] = hw::ex2(m[r] - m_use[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      sc[i] = hw::ex2(fmaf(sc[i], scale_log2, -m_use[(i % 4) / 2]));
      rs[(i % 4) / 2][(i / 4) % 4] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * alpha[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
  };
  // O to the new maxima (skipped where every row of the warp kept its
  // maximum: a factor of 1 changes no bit), then P packed to bf16
  auto rescale_pack = [&](const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
    }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = hw::pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
  };

  // The warpgroup computes tiles a .. z: the tiles before them lie below
  // the window of every row of the warpgroup, the tiles after them above
  // its diagonal (those are waited for and released only).  Pipelined
  // within the warpgroup: tile i's S = Q K^T is issued, then tile i - 1's
  // P V; the softmax of tile i runs while P V is on the tensor cores, and O
  // is rescaled once P V is done.  At most two stages are held, so a ring
  // of two or more never waits on itself.  No wgmma is under a branch (the
  // compiler would make every wgmma of the kernel synchronous).
  auto skipped = [&](int it) {
    const int kt0 = (j0 + it) * TK;
    return (causal && kt0 > w_last) ||
           (windowed && kt0 + TK - 1 <= w_first - window);
  };
  int a = 0, z = nt - 1;
  while (a < nt && skipped(a)) ++a;
  while (z >= a && skipped(z)) --z;
  auto pass = [&](int it) {
    hw::mbar_wait_uniform(full(it % NS), (it / NS) & 1);
    release(it);
  };
  for (int it = 0; it < a; ++it) pass(it);
  if (a <= z) {
    float alpha[2];
    hw::mbar_wait_uniform(full(a % NS), (a / NS) & 1);
    fence_all();
    hw::wgmma_fence();
    issue_s(a);
    hw::wgmma_wait<0>();
    fence_all();
    softmax(a, alpha);
    rescale_pack(alpha);
    for (int it = a + 1; it <= z; ++it) {
      hw::mbar_wait_uniform(full(it % NS), (it / NS) & 1);
      fence_all();
      hw::wgmma_fence();
      issue_s(it);
      issue_pv(it - 1);
      hw::wgmma_wait<1>();
      hw::fence_regs(sc);
      softmax(it, alpha);
      hw::wgmma_wait<0>();
      fence_all();
      release(it - 1);
      rescale_pack(alpha);
    }
    fence_all();
    hw::wgmma_fence();
    issue_pv(z);
    hw::wgmma_wait<0>();
    fence_all();
    release(z);
  }
  for (int it = max(a, z + 1); it < nt; ++it) pass(it);

  // normalise, round once, stage in the warpgroup's own Q rows (its
  // products are done) in their 128-byte swizzle, then store 16-byte rows
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[r] = lt > 0.f ? 1.f / lt : 0.f;
    // the row's logsumexp (natural log) for the backward: m is in log2
    // units of the scaled scores
    const int rr = 64 * wg + 16 * warp + g + 8 * r, p = p0 + rr;
    if (lse != nullptr && t == 0 && rr < rows && p < n_rows)
      lse[((size_t)b * H + kvh * G + p % G) * Sq + p / G] =
          lt > 0.f ? (m[r] + log2f(lt)) * 0.6931471805599453f : INFINITY;
  }
  const uint32_t stg = sq + wg * 8192;
  auto stg_addr = [&](int r, int j) {      // row r, 16-byte chunk j (8 cols)
    return stg + (j / 8) * C::Q_SPAN + r * 128 + (((j % 8) ^ (r % 8)) << 4);
  };
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int r = 16 * warp + g;
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(stg_addr(r, j) + 4 * t),
                 "r"(hw::pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]))
                 : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(stg_addr(r + 8, j) + 4 * t),
                 "r"(hw::pack_bf16(acc[4 * j + 2] * inv[1],
                                   acc[4 * j + 3] * inv[1]))
                 : "memory");
  }
  hw::named_sync(1 + wg, 128);
  for (int c = tid; c < 64 * (DH / 8); c += 128) {
    const int r = c / (DH / 8), j = c % (DH / 8);
    const int rr = 64 * wg + r, p = p0 + rr;
    if (rr < rows && p < n_rows)
      *reinterpret_cast<uint4*>(
          o + (((size_t)b * Sq + p / G) * H + kvh * G + p % G) * DH + 8 * j) =
          hw::ld_shared16(stg_addr(r, j));
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, void* o,
            float* lse, int B, int Sq, int Sk, int H, int KV, float scale,
            int causal, int window, cudaStream_t s) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, DH><<<grid, NT, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, H, KV, scale,
      causal, window);
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Sk, int H, int KV, float scale,
               int causal, int window, cudaStream_t s) {
  using C = MmaCfg<DH>;
  static bool smem_ok = false;        // set once per instantiation
  if (!smem_ok) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_ok = true;
  }
  const long rows = (long)Sq * (H / KV);
  dim3 grid(B * KV, (unsigned)((rows + C::ROWS - 1) / C::ROWS));
  flash_mma_kernel<DH><<<grid, C::NW * 32, C::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Sq, Sk, H, KV, scale * 1.4426950408889634f, causal, window);
  return 0;
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Sk, int H, int KV, int Dh,
                 float scale, int causal, int window, cudaStream_t s) {
  if (Dh == 64) {
    launch<float, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale, causal,
                      window, s);
  } else if (Dh == 96) {
    launch<float, 96>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale, causal,
                      window, s);
  } else if (Dh == 128) {
    launch<float, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale, causal,
                       window, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Sk, int H, int KV, float scale,
                 int causal, int window, cudaStream_t s) {
  using C = WgCfg<DH>;
  const int G = H / KV, qpb = C::ROWS / G;
  // q as (Dh, H, Sq, B) in boxes of 64 columns x the group's G heads x qpb
  // queries, so a box lands as the block's rows in order; k and v as (Dh,
  // KV, Sk, B) in boxes of 64 columns x TK keys of one kv head
  CUtensorMap map_q, map_k, map_v;
  const uint64_t dims_q[4] = {(uint64_t)DH, (uint64_t)H, (uint64_t)Sq,
                              (uint64_t)B};
  const uint64_t dims_kv[4] = {(uint64_t)DH, (uint64_t)KV, (uint64_t)Sk,
                               (uint64_t)B};
  const uint32_t box_q[4] = {64, (uint32_t)G, (uint32_t)qpb, 1};
  const uint32_t box_kv[4] = {64, 1, C::TK, 1};
  if (!hw::encode_bf16(&map_q, q, 4, dims_q, box_q) ||
      !hw::encode_bf16(&map_k, k, 4, dims_kv, box_kv) ||
      !hw::encode_bf16(&map_v, v, 4, dims_kv, box_kv))
    return (int)cudaErrorInvalidValue;
  static bool smem_ok = false;        // set once per instantiation
  if (!smem_ok) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_ok = true;
  }
  dim3 grid((unsigned)((Sq + qpb - 1) / qpb), B * KV);
  flash_wgmma_kernel<DH><<<grid, C::THREADS, C::SMEM, s>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, KV,
      scale * 1.4426950408889634f, causal, window);
  return 0;
}

// The split decode route: flash_decode_split_kernel over (splits, B KV)
// blocks of min(tiles, 4) warps and keys / TK tiles of shared memory, the
// partials in part (acc: splits B H Sq Dh floats, then (m, l): splits B H Sq
// 2), then flash_decode_merge_kernel over B H Sq Dh / 8 threads.
template <int DH>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  float* lse, float* part, int B, int Sq, int Sk, int H,
                  int KV, float scale, int splits, int keys, cudaStream_t s) {
  using C = DecodeCfg<DH>;
  static bool smem_ok = false;        // set once per instantiation
  if (!smem_ok) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_split_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::MAX_TILES * C::PAIR);
    if (err != cudaSuccess) return (int)err;
    smem_ok = true;
  }
  const int tiles = keys / TK;
  const int warps = tiles < C::MAX_WARPS ? tiles : C::MAX_WARPS;
  const long rows = (long)B * H * Sq;
  float* stat = part + (size_t)splits * rows * DH;
  flash_decode_split_kernel<DH>
      <<<dim3(splits, B * KV), warps * 32, tiles * C::PAIR, s>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), part, stat, Sq, Sk, H, KV,
          scale * 1.4426950408889634f, keys);
  // the merge as a programmatic dependent of the split kernel: its blocks
  // are placed while the split's last ones run, and wait for their writes
  const long threads = rows * (DH / 8);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((threads + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, flash_decode_merge_kernel<DH>,
                                 static_cast<const float*>(part),
                                 static_cast<const float*>(stat),
                                 static_cast<__nv_bfloat16*>(o), lse, Sq, H,
                                 KV, splits, rows);
}

// The forward's routes: ops.attention_plan chooses one by shape and passes
// it in with the split decode route's splits and keys a split; each launch
// here first checks that its route can take the shape.
enum Route { kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2, kRouteSplit = 3 };

// flash_wgmma_kernel needs a (b, kv head) of 64 rows or more (a warpgroup's
// tile), keys to map (a tensor map has no extent 0), a group of at most 128
// heads (a block's rows hold whole queries) and a positive scale (it takes
// the row maximum of the raw scores).
bool wgmma_legal(int Sq, int Sk, int H, int KV, float scale) {
  return (long)Sq * (H / KV) >= 64 && Sk > 0 && H / KV <= 128 && scale > 0.f;
}

// The split decode route needs no mask but the end of the keys (not causal,
// so no window), one m16 tile of rows (Sq G <= 16), keys, a positive scale,
// the partials' scratch, whole tiles a split within the shared memory, and
// splits that cover Sk with none empty.
template <int DH>
bool split_legal(int Sq, int Sk, int H, int KV, float scale, int causal,
                 int splits, int keys, const float* part) {
  return !causal && (long)Sq * (H / KV) <= 16 && Sk > 0 && scale > 0.f &&
         part != nullptr && keys > 0 && keys % TK == 0 &&
         keys / TK <= DecodeCfg<DH>::MAX_TILES && splits >= 1 &&
         (long)(splits - 1) * keys < Sk && (long)splits * keys >= Sk;
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, float* part, int B, int Sq, int Sk, int H, int KV,
                float scale, int causal, int window, int route, int splits,
                int keys, cudaStream_t s) {
  if (route == kRouteWgmma && wgmma_legal(Sq, Sk, H, KV, scale))
    return launch_wgmma<DH>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale, causal,
                            window, s);
  if (route == kRouteSplit &&
      split_legal<DH>(Sq, Sk, H, KV, scale, causal, splits, keys, part))
    return launch_decode<DH>(q, k, v, o, lse, part, B, Sq, Sk, H, KV, scale,
                             splits, keys, s);
  if (route == kRouteMma)
    return launch_mma<DH>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale, causal,
                          window, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  float* lse, float* part, int B, int Sq, int Sk, int H,
                  int KV, int Dh, float scale, int causal, int window,
                  int route, int splits, int keys, cudaStream_t s) {
  if (Dh == 64)
    return launch_bf16<64>(q, k, v, o, lse, part, B, Sq, Sk, H, KV, scale,
                           causal, window, route, splits, keys, s);
  if (Dh == 96)
    return launch_bf16<96>(q, k, v, o, lse, part, B, Sq, Sk, H, KV, scale,
                           causal, window, route, splits, keys, s);
  if (Dh == 128)
    return launch_bf16<128>(q, k, v, o, lse, part, B, Sq, Sk, H, KV, scale,
                            causal, window, route, splits, keys, s);
  return (int)cudaErrorInvalidValue;
}


// ------------------------------------------------------------- backward
// The gradient of the TPU kernel src/repro/kernels/flash_attention.py
// (_attn_kernel), which has none of its own (jax.vjp of the reference
// there).  FA2's backward, with P recomputed from the forward's row
// logsumexp:
//   D_i = rowsum(dO o O),  P = exp(S scale - LSE),  dV = P^T dO,
//   dP = dO V^T,  dS = P o (dP - D),  dQ = dS K scale,  dK = dS^T Q scale.
// Bound: at granite's training shape (q [8,512,16,64], causal, bf16) q, o,
// dO, dq at 16 heads, k, v, dk, dv at 8 and the LSE are 51 MB (0.0151 ms at
// 3.35 TB/s) against 10.8 GFLOP for the 5 products over the kept pairs
// (0.011 ms on the tensor cores), so bytes bound it; the pairs grow with
// S^2 and the bytes with S, so past about S 700 (G 2) operations do.
// Deterministic: every output element is summed by one owner in a fixed
// order, with no atomics.  Three kernels, so that the GQA sum over a
// group's heads and dQ's sum over key tiles need no atomics (FA2 and FA3
// add dQ up with f32 atomics from the dK/dV kernel, which changes its bits
// from call to call):
//  * D: a few lanes a (b, query, head) row;
//  * dK, dV: one block per (b, kv head, tile of keys); it walks the rows of
//    every q head of the GQA group that the causal mask and window let see
//    a key of the tile;
//  * dQ: one block per (b, kv head, tile of rows), rows as the forward's;
//    it recomputes S and dP, so the backward takes 7 products where FA2
//    takes 5: the price of no atomics.
// A row is a (query, q head of the group) pair, query-major, as in the
// forward, so one loop walks every head of the group and one K/V tile
// serves them all.  Only steps and tiles that cross a diagonal, a
// window's edge or the end of the rows or keys are masked element by
// element; those that see no kept pair are not computed.
//
// bf16, two routes chosen by shape in ops.attention_bwd_plan and passed in
// (checked against the shape by launch_bwd_bf16).
//
// wgmma and TMA (Hopper's own), where a (b, kv head) has 64 rows or more:
// D writes each row's D and LSE log2(e) into a row-ordered scratch (one
// run of rows a step, so one TMA box of each loads a step's).
//  * flash_bwd_dkdv_wgmma_kernel: warpgroup wg owns 64 keys of the block;
//    K's and V's spans arrive once by TMA; steps of 64 rows (whole queries)
//    stream through a ring of Q's and dO's 128-byte-swizzled spans and the
//    step's statistics, refilled by the last warpgroup to release a stage.
//    Transposed products: S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16,
//    both operands K-major), P^T = 2^(S^T scale log2(e) - LSE log2(e)) and
//    dS^T = P^T o (dP^T - D) in registers (a row with no key, LSE +inf,
//    gives P exactly 0), packed to bf16 as the A operand of dV += P^T dO
//    and dK += dS^T Q (m64n(Dh)k16, A from registers, B the same spans
//    MN-major).  A step's S^T and dP^T are issued, then the step before's
//    dV and dK, and P^T and dS^T are computed while those run.
//  * flash_bwd_dq_wgmma_kernel: flash_wgmma_kernel's skeleton; Q's and
//    dO's spans arrive once, K/V tiles stream through the ring; S = Q K^T
//    and dP = dO V^T (K-major), dS with each row's statistics in
//    registers, dQ += dS K (K's tile MN-major); a tile's S and dP are
//    issued before the tile before's dS K.
//  Against the bytes: each input is read from device memory once a block
//  by TMA into swizzled spans that wgmma reads in place (no register or
//  ldmatrix staging), and the blocks that share a head's K, V (or Q, dO)
//  run together, so the rereads are L2 hits; outputs are rounded once and
//  stored in 16-byte rows.  Against the operations: every product is an
//  asynchronous wgmma, the exponentials and dS overlap the products, and
//  the masks cost only on edge steps.  A warpgroup whose keys (rows) see
//  none of a step's rows (keys) waits for and releases the stage only.  No
//  wgmma is under a branch that is not warp-uniform, and no register of
//  one is touched while it is in flight (ptxas would serialize every
//  wgmma: notes C7510 to C7520).  A group of more than 64 heads (a step
//  holds whole queries), Sk 0 (a tensor map has no extent 0) and fewer
//  rows stay on mma.sync.
//
// mma.sync m16n8k16 (FA2's backward, bf16 in, f32 accumulate, with
// cp.async and ldmatrix as flash_mma_kernel), below 64 rows a (b, kv head)
// and for the shapes above.
//  * dK/dV: 4 warps a block, 16 keys a warp; K and V stay in shared memory
//    (bf16, padded rows) and dK, dV in registers as mma fragments.  Q, dO,
//    the LSE and D of BQ rows a step are double-buffered through cp.async.
//    The products are taken transposed as above, with Q and dO as B
//    through ldmatrix; P^T and dS^T go from their accumulators straight to
//    bf16 A fragments (no shared-memory round trip, rounded as FA2 rounds
//    them), and dV += P^T dO, dK += dS^T Q read dO and Q through
//    ldmatrix.trans.  BQ = 64 at Dh 64, 32 at Dh 96 and 128, so dK, dV (Dh
//    floats a thread) and S^T, dP^T (BQ) fit the registers.
//  * dQ: 4 warps a block, 16 rows a warp; Q and dO stay in shared memory,
//    dQ in registers, and the block walks the 64-key tiles the mask keeps
//    (double-buffered K, V): S = Q K^T, dP = dO V^T, P, dS as above, dQ +=
//    dS K with K as B through ldmatrix.trans.  Row tiles start in reverse,
//    the longest first.
//
// f32: FMA loops in f32 on f32 tiles in shared memory, so the f32 route
// never touches TF32.  dK/dV blocks of 64 keys walk 32 query rows a step;
// dQ blocks of 64 query rows walk 32 keys a step.
constexpr int BWD_NT = 256;      // threads per backward block
constexpr int KB_KEYS = 64;      // keys per dK/dV block
constexpr int KB_Q = 32;         // query rows per step of its loop
constexpr int QB_Q = 64;         // query rows per dQ block
constexpr int QB_KEYS = 32;      // keys per step of its loop

template <int DH>
struct BwdSmem {
  static constexpr int LD = DH + 1;   // padded rows: conflict-free columns
  static constexpr int DKDV = (2 * KB_KEYS * LD + 2 * KB_Q * LD
                               + 2 * KB_Q * (KB_KEYS + 1) + 2 * KB_Q) * 4;
  static constexpr int DQ = (2 * QB_Q * LD + 2 * QB_KEYS * LD
                             + QB_Q * (QB_KEYS + 1) + 2 * QB_Q) * 4;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dd[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d]
template <typename T>
__global__ void __launch_bounds__(BWD_NT)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ Dd, int B, int Sq, int H, int Dh) {
  const long row = (long)blockIdx.x * (BWD_NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long)B * Sq * H) return;
  const T* op = o + (size_t)row * Dh;
  const T* gp = dout + (size_t)row * Dh;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32)
    acc = fmaf(rt::to_f(op[d]), rt::to_f(gp[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long b = row / ((long)Sq * H), i = (row / H) % Sq, h = row % H;
    Dd[((size_t)b * H + h) * Sq + i] = acc;
  }
}

// Rows [r0, r0 + n) of head h of x [B, S, NH, DH] into xs [n][LD] as f32
// (zeros past S).
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float* xs, const T* x, int b,
                                           int S, int NH, int h, int r0,
                                           int n) {
  constexpr int LD = DH + 1;
  for (int idx = threadIdx.x; idx < n * DH; idx += BWD_NT) {
    const int r = idx / DH, d = idx % DH, row = r0 + r;
    const bool ok = row < S;
    xs[r * LD + d] =
        ok ? rt::to_f(x[(((size_t)b * S + row) * NH + h) * DH + d]) : 0.f;
  }
}

__device__ __forceinline__ bool kept(int qi, int kj, int Sq, int Sk,
                                     int causal, int window) {
  return qi < Sq && kj < Sk && (!causal || kj <= qi) &&
         (window <= 0 || kj > qi - window);
}

template <typename T, int DH>
__global__ void __launch_bounds__(BWD_NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ Dd, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                      float scale, int causal, int window) {
  constexpr int LD = DH + 1, PL = KB_KEYS + 1, DP = DH / 4;
  extern __shared__ float sm[];
  float* Ks = sm;                       // [KB_KEYS][LD]
  float* Vs = Ks + KB_KEYS * LD;        // [KB_KEYS][LD]
  float* Qs = Vs + KB_KEYS * LD;        // [KB_Q][LD]
  float* Gs = Qs + KB_Q * LD;           // dO, [KB_Q][LD]
  float* Ps = Gs + KB_Q * LD;           // P, [KB_Q][PL]
  float* Ss = Ps + KB_Q * PL;           // dS, [KB_Q][PL]
  float* Ls = Ss + KB_Q * PL;           // LSE, [KB_Q]
  float* Ds = Ls + KB_Q;                // D, [KB_Q]

  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV, G = H / KV;
  const int k0 = blockIdx.x * KB_KEYS;
  const int tid = threadIdx.x;
  stage_rows<T, DH>(Ks, k, b, Sk, KV, kvh, k0, KB_KEYS);
  stage_rows<T, DH>(Vs, v, b, Sk, KV, kvh, k0, KB_KEYS);
  // accumulators: key row jr, dims part + 4 i
  const int jr = tid / 4, part = tid % 4;
  float adk[DP], adv[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) adk[i] = adv[i] = 0.f;
  // score pairs (ti + 16 a, tj + 16 c), a < 2, c < 4
  const int ti = tid / 16, tj = tid % 16;
  const int w = causal ? window : 0;
  // queries that can see a key of this block: qi >= k0 (causal) and
  // qi < k_last + window (a window)
  const int q_begin = causal ? k0 / KB_Q * KB_Q : 0;
  const int q_end = w > 0 ? min(Sq, min(Sk, k0 + KB_KEYS) - 1 + w) : Sq;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    for (int q0 = q_begin; q0 < q_end; q0 += KB_Q) {
      __syncthreads();          // the last step's tiles are no longer read
      stage_rows<T, DH>(Qs, q, b, Sq, H, h, q0, KB_Q);
      stage_rows<T, DH>(Gs, dout, b, Sq, H, h, q0, KB_Q);
      if (tid < KB_Q) {
        const int qi = q0 + tid;
        const size_t off = ((size_t)b * H + h) * Sq + qi;
        Ls[tid] = qi < Sq ? lse[off] : 0.f;
        Ds[tid] = qi < Sq ? Dd[off] : 0.f;
      }
      __syncthreads();
      float s[2][4], dp[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
      for (int d = 0; d < DH; ++d) {
        float qa[2], ga[2], kc[4], vc[4];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          qa[a] = Qs[(ti + 16 * a) * LD + d];
          ga[a] = Gs[(ti + 16 * a) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kc[c] = Ks[(tj + 16 * c) * LD + d];
          vc[c] = Vs[(tj + 16 * c) * LD + d];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
            dp[a][c] = fmaf(ga[a], vc[c], dp[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ti + 16 * a, j = tj + 16 * c;
          const float p = kept(q0 + i, k0 + j, Sq, Sk, causal, w)
                              ? expf(s[a][c] * scale - Ls[i]) : 0.f;
          Ps[i * PL + j] = p;
          Ss[i * PL + j] = p * (dp[a][c] - Ds[i]);
        }
      __syncthreads();
      for (int i = 0; i < KB_Q; ++i) {
        const float p = Ps[i * PL + jr], ds = Ss[i * PL + jr];
#pragma unroll
        for (int e = 0; e < DP; ++e) {
          adv[e] = fmaf(p, Gs[i * LD + part + 4 * e], adv[e]);
          adk[e] = fmaf(ds, Qs[i * LD + part + 4 * e], adk[e]);
        }
      }
    }
  }
  const int kj = k0 + jr;
  if (kj < Sk) {
    const size_t off = (((size_t)b * Sk + kj) * KV + kvh) * DH + part;
#pragma unroll
    for (int e = 0; e < DP; ++e) {
      dk[off + 4 * e] = rt::from_f<T>(adk[e] * scale);
      dv[off + 4 * e] = rt::from_f<T>(adv[e]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(BWD_NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ Dd, T* __restrict__ dq, int Sq,
                    int Sk, int H, int KV, float scale, int causal,
                    int window) {
  constexpr int LD = DH + 1, PL = QB_KEYS + 1, DP = DH / 4;
  extern __shared__ float sm[];
  float* Qs = sm;                       // [QB_Q][LD]
  float* Gs = Qs + QB_Q * LD;           // dO, [QB_Q][LD]
  float* Ks = Gs + QB_Q * LD;           // [QB_KEYS][LD]
  float* Vs = Ks + QB_KEYS * LD;        // [QB_KEYS][LD]
  float* Ss = Vs + QB_KEYS * LD;        // dS, [QB_Q][PL]
  float* Ls = Ss + QB_Q * PL;           // LSE, [QB_Q]
  float* Ds = Ls + QB_Q;                // D, [QB_Q]

  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / (H / KV);
  const int q0 = blockIdx.x * QB_Q;
  const int tid = threadIdx.x;
  stage_rows<T, DH>(Qs, q, b, Sq, H, h, q0, QB_Q);
  stage_rows<T, DH>(Gs, dout, b, Sq, H, h, q0, QB_Q);
  if (tid < QB_Q) {
    const int qi = q0 + tid;
    const size_t off = ((size_t)b * H + h) * Sq + qi;
    Ls[tid] = qi < Sq ? lse[off] : 0.f;
    Ds[tid] = qi < Sq ? Dd[off] : 0.f;
  }
  // accumulators: query row ir, dims part + 4 i
  const int ir = tid / 4, part = tid % 4;
  float adq[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) adq[i] = 0.f;
  // score pairs (ti + 16 a, tj + 16 c), a < 4, c < 2
  const int ti = tid / 16, tj = tid % 16;
  const int w = causal ? window : 0;
  const int k_begin = w > 0 ? max(0, q0 - w + 1) / QB_KEYS * QB_KEYS : 0;
  const int k_end = causal ? min(Sk, q0 + QB_Q) : Sk;
  for (int k0 = k_begin; k0 < k_end; k0 += QB_KEYS) {
    __syncthreads();            // the last step's tiles are no longer read
    stage_rows<T, DH>(Ks, k, b, Sk, KV, kvh, k0, QB_KEYS);
    stage_rows<T, DH>(Vs, v, b, Sk, KV, kvh, k0, QB_KEYS);
    __syncthreads();
    float s[4][2], dp[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) s[a][c] = dp[a][c] = 0.f;
    for (int d = 0; d < DH; ++d) {
      float qa[4], ga[4], kc[2], vc[2];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = Qs[(ti + 16 * a) * LD + d];
        ga[a] = Gs[(ti + 16 * a) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        kc[c] = Ks[(tj + 16 * c) * LD + d];
        vc[c] = Vs[(tj + 16 * c) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
          dp[a][c] = fmaf(ga[a], vc[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = ti + 16 * a, j = tj + 16 * c;
        const float p = kept(q0 + i, k0 + j, Sq, Sk, causal, w)
                            ? expf(s[a][c] * scale - Ls[i]) : 0.f;
        Ss[i * PL + j] = p * (dp[a][c] - Ds[i]);
      }
    __syncthreads();
    for (int j = 0; j < QB_KEYS; ++j) {
      const float ds = Ss[ir * PL + j];
#pragma unroll
      for (int e = 0; e < DP; ++e)
        adq[e] = fmaf(ds, Ks[j * LD + part + 4 * e], adq[e]);
    }
  }
  const int qi = q0 + ir;
  if (qi < Sq) {
    const size_t off = (((size_t)b * Sq + qi) * H + h) * DH + part;
#pragma unroll
    for (int e = 0; e < DP; ++e) dq[off + 4 * e] = rt::from_f<T>(adq[e] * scale);
  }
}

// ------------------------------------------- bf16 backward (mma.sync)
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct BwdCfg {
  static constexpr int NW = 4;                    // warps a block
  static constexpr int KEYS = 16 * NW;            // dK/dV: keys a block
  static constexpr int BQ = DH == 64 ? 64 : 32;   // dK/dV: rows a step
  // dK/dV blocks an SM at Dh 64: 3 caps the registers at 168, with a
  // 12-byte spill (measured faster than the 213 registers the compiler
  // picks alone, which fit 2 blocks)
  static constexpr int DKDV_MIN_BLOCKS = DH == 64 ? 3 : 1;
  static constexpr int ROWS = 16 * NW;            // dQ: rows a block
  static constexpr int TK = 64;                   // dQ: keys a step
  static constexpr int LD = DH + 8;               // padded smem row
  static constexpr int RB = LD * 2;               // its bytes
  // dK/dV: K, V [KEYS][LD]; two buffers of Q, dO [BQ][LD], LSE, D [BQ] f32
  static constexpr int QBUF = 2 * BQ * RB + 2 * BQ * 4;
  static constexpr int DKDV_SMEM = 2 * KEYS * RB + 2 * QBUF;
  // dQ: Q, dO [ROWS][LD]; two buffers of K, V [TK][LD]
  static constexpr int DQ_SMEM = 2 * ROWS * RB + 2 * 2 * TK * RB;
};

// Dd[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d], bf16: L lanes a row
// (the power of two >= Dh / 8), each lane 8 elements of O and of dO in one
// 16-byte load each, summed in f32 by xor shuffles over the row's lanes.
// ROWS_P (the wgmma route): Dd holds 2 N floats (N = B H Sq rows) in row
// order p = query G + head within each (b, kv head), [B, KV, Sq, G]: first
// each row's LSE log2(e), then its D, so that a step of rows is one run of
// each, which one TMA box loads.
template <int DH>
__host__ __device__ constexpr int dot_lanes() { return DH / 8 <= 8 ? 8 : 16; }
template <int DH, bool ROWS_P>
__global__ void __launch_bounds__(BWD_NT)
flash_bwd_dot_bf16_kernel(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ Dd, long rows, int Sq, int H,
                          int KV) {
  constexpr int CH = DH / 8, L = dot_lanes<DH>();
  const long row = ((long)blockIdx.x * BWD_NT + threadIdx.x) / L;
  const int c = threadIdx.x % L;
  float acc = 0.f;
  if (row < rows && c < CH) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * DH + 8 * c);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + row * DH + 8 * c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(a2[j]), y = __bfloat1622float2(b2[j]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) {
    const long b = row / ((long)Sq * H), i = (row / H) % Sq, h = row % H;
    if (ROWS_P) {
      const int G = H / KV;
      const long p = ((b * KV + h / G) * Sq + i) * G + h % G;
      Dd[p] = lse[((size_t)b * H + h) * Sq + i] * kLog2e;
      Dd[rows + p] = acc;
    } else {
      Dd[((size_t)b * H + h) * Sq + i] = acc;
    }
  }
}
// its grid: L lanes a row
template <int DH>
unsigned dot_blocks(long rows) {
  return (unsigned)((rows * dot_lanes<DH>() + BWD_NT - 1) / BWD_NT);
}

template <int DH>
__global__ void __launch_bounds__(BwdCfg<DH>::NW * 32,
                                  BwdCfg<DH>::DKDV_MIN_BLOCKS)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ Dd,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                          int H, int KV, float scale_log2, float scale,
                          int causal, int window) {
  using C = BwdCfg<DH>;
  constexpr int NT = C::NW * 32, LD = C::LD, CH = DH / 8, BQ = C::BQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sk = hw::smem_u32(smem_raw), sv = sk + C::KEYS * C::RB;
  auto sq = [&](int buf) { return sv + C::KEYS * C::RB + buf * C::QBUF; };
  auto sg = [&](int buf) { return sq(buf) + BQ * C::RB; };
  auto sl = [&](int buf) { return sg(buf) + BQ * C::RB; };   // LSE, then D
  auto lds = [&](int buf) {
    return reinterpret_cast<const float*>(smem_raw + (sl(buf) - sk));
  };

  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int k0 = blockIdx.x * C::KEYS;
  const int n_rows = Sq * G;
  const bool windowed = causal && window > 0;
  // rows that can see a key of the block: queries >= k0 (causal) and
  // queries < the last key + window (a window)
  const int p_begin = causal ? k0 * G : 0;
  const int p_end = windowed
      ? min(Sq, min(Sk, k0 + C::KEYS) - 1 + window) * G : n_rows;
  const int n_steps = p_end > p_begin ? (p_end - p_begin + BQ - 1) / BQ : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  auto row_off = [&](int p) {
    return (((size_t)b * Sq + p / G) * H + kvh * G + p % G) * DH;
  };
  auto stat_off = [&](int p) {
    return ((size_t)b * H + kvh * G + p % G) * Sq + p / G;
  };
  auto load_step = [&](int st, int buf) {
    const int p0 = p_begin + st * BQ;
    for (int c = tid; c < BQ * CH; c += NT) {
      const int r = c / CH, d = (c % CH) * 8, p = p0 + r;
      const bool ok = p < n_rows;
      const size_t off = (ok ? row_off(p) : 0) + d;
      hw::cp_async16(sq(buf) + (r * LD + d) * 2, q + off, ok);
      hw::cp_async16(sg(buf) + (r * LD + d) * 2, dout + off, ok);
    }
    for (int r = tid; r < BQ; r += NT) {
      const int p = p0 + r;
      const bool ok = p < n_rows;
      const size_t off = ok ? stat_off(p) : 0;
      hw::cp_async4(sl(buf) + 4 * r, lse + off, ok);
      hw::cp_async4(sl(buf) + 4 * (BQ + r), Dd + off, ok);
    }
  };

  for (int c = tid; c < C::KEYS * CH; c += NT) {
    const int r = c / CH, d = (c % CH) * 8, kj = k0 + r;
    const bool ok = kj < Sk;
    const size_t off = (((size_t)b * Sk + (ok ? kj : 0)) * KV + kvh) * DH + d;
    hw::cp_async16(sk + (r * LD + d) * 2, k + off, ok);
    hw::cp_async16(sv + (r * LD + d) * 2, v + off, ok);
  }
  if (n_steps > 0) load_step(0, 0);
  hw::cp_async_commit();              // group 0: K, V and step 0

  const int wk0 = k0 + 16 * warp;     // the warp's first key
  const int kj[2] = {wk0 + g, wk0 + g + 8};   // this thread's keys
  float adk[DH / 8][4], adv[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[i][e] = adv[i][e] = 0.f;

  for (int st = 0; st < n_steps; ++st) {
    const int buf = st & 1;
    __syncthreads();                  // step st - 1's buffer is consumed
    if (st + 1 < n_steps) load_step(st + 1, buf ^ 1);
    hw::cp_async_commit();
    hw::cp_async_wait<1>();
    __syncthreads();                  // step st landed
    const int p0 = p_begin + st * BQ;
    const int q_lo = p0 / G, q_hi = (min(p0 + BQ, n_rows) - 1) / G;
    if (wk0 >= Sk) continue;                           // no key of the warp
    if (causal && wk0 > q_hi) continue;                // above the diagonal
    if (windowed && wk0 + 15 <= q_lo - window) continue;   // below the window
    const bool need_mask = p0 + BQ > n_rows || wk0 + 16 > Sk ||
                           (causal && wk0 + 15 > q_lo) ||
                           (windowed && wk0 <= q_hi - window);

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ rows
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t ka[4], va[4];
      const uint32_t a_off = ((16 * warp + lane % 16) * LD + ks * 16
                              + (lane / 16) * 8) * 2;
      hw::ldmatrix_x4(ka, sk + a_off);
      hw::ldmatrix_x4(va, sv + a_off);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t qb[4], gb[4];
        const uint32_t b_off = ((np * 16 + lane % 8 + 8 * (lane / 16)) * LD
                                + ks * 16 + 8 * ((lane / 8) % 2)) * 2;
        hw::ldmatrix_x4(qb, sq(buf) + b_off);
        hw::ldmatrix_x4(gb, sg(buf) + b_off);
        hw::mma_bf16(s[2 * np], ka, qb[0], qb[1]);
        hw::mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
        hw::mma_bf16(dp[2 * np], va, gb[0], gb[1]);
        hw::mma_bf16(dp[2 * np + 1], va, gb[2], gb[3]);
      }
    }

    // P^T and dS^T in place: element e of tile i is key kj[e / 2], row
    // p0 + 8 i + 2 t + (e & 1)
    const float* ls = lds(buf);
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * i + 2 * t);
      const float2 d2 =
          *reinterpret_cast<const float2*>(ls + BQ + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? l2.y : l2.x, dv_ = (e & 1) ? d2.y : d2.x;
        float pe = hw::ex2(s[i][e] * scale_log2 - lv * kLog2e);
        if (need_mask) {
          const int p = p0 + 8 * i + 2 * t + (e & 1), key = kj[e / 2];
          const int qi = p / G;
          if (p >= n_rows || key >= Sk || (causal && key > qi) ||
              (windowed && key <= qi - window))
            pe = 0.f;
        }
        s[i][e] = pe;
        dp[i][e] = pe * (dp[i][e] - dv_);
      }
    }

    // dV += P^T dO, dK += dS^T Q: P^T, dS^T as A fragments in registers
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = hw::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = hw::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = hw::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = hw::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = hw::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = hw::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = hw::pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = hw::pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dpi = 0; dpi < DH / 16; ++dpi) {
        uint32_t gb[4], qb[4];
        const uint32_t b_off = ((kk * 16 + lane % 16) * LD + dpi * 16
                                + 8 * (lane / 16)) * 2;
        hw::ldmatrix_x4_trans(gb, sg(buf) + b_off);
        hw::ldmatrix_x4_trans(qb, sq(buf) + b_off);
        hw::mma_bf16(adv[2 * dpi], pa, gb[0], gb[1]);
        hw::mma_bf16(adv[2 * dpi + 1], pa, gb[2], gb[3]);
        hw::mma_bf16(adk[2 * dpi], da, qb[0], qb[1]);
        hw::mma_bf16(adk[2 * dpi + 1], da, qb[2], qb[3]);
      }
    }
  }

  // round once, stage in the warp's own K and V rows (no other warp reads
  // them), store rows of 16 bytes
  hw::cp_async_wait<0>();
  __syncthreads();                    // every copy into K and V has landed
  __nv_bfloat16* stk = reinterpret_cast<__nv_bfloat16*>(smem_raw)
                       + 16 * warp * LD;
  __nv_bfloat16* stv = stk + C::KEYS * LD;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const int col = 8 * i + 2 * t;
    *reinterpret_cast<uint32_t*>(stk + g * LD + col) =
        hw::pack_bf16(adk[i][0] * scale, adk[i][1] * scale);
    *reinterpret_cast<uint32_t*>(stk + (g + 8) * LD + col) =
        hw::pack_bf16(adk[i][2] * scale, adk[i][3] * scale);
    *reinterpret_cast<uint32_t*>(stv + g * LD + col) =
        hw::pack_bf16(adv[i][0], adv[i][1]);
    *reinterpret_cast<uint32_t*>(stv + (g + 8) * LD + col) =
        hw::pack_bf16(adv[i][2], adv[i][3]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, d = (c % CH) * 8, key = wk0 + r;
    if (key < Sk) {
      const size_t off = (((size_t)b * Sk + key) * KV + kvh) * DH + d;
      *reinterpret_cast<uint4*>(dk + off) =
          *reinterpret_cast<const uint4*>(stk + r * LD + d);
      *reinterpret_cast<uint4*>(dv + off) =
          *reinterpret_cast<const uint4*>(stv + r * LD + d);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(BwdCfg<DH>::NW * 32)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ Dd,
                        __nv_bfloat16* __restrict__ dq, int Sq, int Sk,
                        int H, int KV, float scale_log2, float scale,
                        int causal, int window) {
  using C = BwdCfg<DH>;
  constexpr int NT = C::NW * 32, LD = C::LD, CH = DH / 8, TK = C::TK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sq = hw::smem_u32(smem_raw), sg = sq + C::ROWS * C::RB;
  auto sk = [&](int buf) {
    return sg + C::ROWS * C::RB + buf * 2 * TK * C::RB;
  };
  auto sv = [&](int buf) { return sk(buf) + TK * C::RB; };

  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  // row tiles in reverse, so the tiles with the most keys start first
  const int p0 = (gridDim.y - 1 - blockIdx.y) * C::ROWS;
  const int n_rows = Sq * G;
  const int q_last = min(n_rows - 1, p0 + C::ROWS - 1) / G;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const bool windowed = causal && window > 0;
  const int j0 = windowed ? max(0, p0 / G - window + 1) / TK : 0;
  const int nt = max(0, (k_end + TK - 1) / TK - j0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  auto row_off = [&](int p) {
    return (((size_t)b * Sq + p / G) * H + kvh * G + p % G) * DH;
  };
  auto load_kv = [&](int tile, int buf) {
    for (int c = tid; c < TK * CH; c += NT) {
      const int r = c / CH, d = (c % CH) * 8, kj = tile * TK + r;
      const bool ok = kj < Sk;
      const size_t off = (((size_t)b * Sk + (ok ? kj : 0)) * KV + kvh) * DH + d;
      hw::cp_async16(sk(buf) + (r * LD + d) * 2, k + off, ok);
      hw::cp_async16(sv(buf) + (r * LD + d) * 2, v + off, ok);
    }
  };
  for (int c = tid; c < C::ROWS * CH; c += NT) {
    const int r = c / CH, d = (c % CH) * 8, p = p0 + r;
    const bool ok = p < n_rows;
    const size_t off = (ok ? row_off(p) : 0) + d;
    hw::cp_async16(sq + (r * LD + d) * 2, q + off, ok);
    hw::cp_async16(sg + (r * LD + d) * 2, dout + off, ok);
  }
  if (nt > 0) load_kv(j0, 0);
  hw::cp_async_commit();              // group 0: Q, dO and K/V tile j0

  // the warp's rows; this thread holds rows wp + g and wp + g + 8
  const int wp = p0 + 16 * warp;
  const bool w_rows = wp < n_rows;
  const int w_first = wp / G, w_last = (min(wp + 16, n_rows) - 1) / G;
  int pr[2], qi[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    pr[r] = wp + g + 8 * r;
    qi[r] = pr[r] / G;
    const bool ok = pr[r] < n_rows;
    const size_t off = ((size_t)b * H + kvh * G + pr[r] % G) * Sq + qi[r];
    lse2[r] = ok ? lse[off] * kLog2e : 0.f;
    dd[r] = ok ? Dd[off] : 0.f;
  }
  float adq[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[i][e] = 0.f;

  for (int jj = 0; jj < nt; ++jj) {
    const int buf = jj & 1;
    __syncthreads();                  // tile jj - 1's buffer is consumed
    if (jj + 1 < nt) load_kv(j0 + jj + 1, buf ^ 1);
    hw::cp_async_commit();
    hw::cp_async_wait<1>();
    __syncthreads();                  // tile jj (and Q, dO) landed
    const int kt0 = (j0 + jj) * TK;
    if (!w_rows) continue;
    if (causal && kt0 > w_last) continue;             // above the diagonal
    if (windowed && kt0 + TK - 1 <= w_first - window) continue;
    const bool need_mask = kt0 + TK > Sk || wp + 16 > n_rows ||
                           (causal && kt0 + TK - 1 > w_first) ||
                           (windowed && kt0 <= w_last - window);

    // S = Q K^T and dP = dO V^T: 16 rows x TK keys
    float s[TK / 8][4], dp[TK / 8][4];
#pragma unroll
    for (int i = 0; i < TK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t qa[4], ga[4];
      const uint32_t a_off = ((16 * warp + lane % 16) * LD + ks * 16
                              + (lane / 16) * 8) * 2;
      hw::ldmatrix_x4(qa, sq + a_off);
      hw::ldmatrix_x4(ga, sg + a_off);
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t kb[4], vb[4];
        const uint32_t b_off = ((np * 16 + lane % 8 + 8 * (lane / 16)) * LD
                                + ks * 16 + 8 * ((lane / 8) % 2)) * 2;
        hw::ldmatrix_x4(kb, sk(buf) + b_off);
        hw::ldmatrix_x4(vb, sv(buf) + b_off);
        hw::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        hw::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        hw::mma_bf16(dp[2 * np], ga, vb[0], vb[1]);
        hw::mma_bf16(dp[2 * np + 1], ga, vb[2], vb[3]);
      }
    }
    // dS in place of dP: element e of tile i is row pr[e / 2], key
    // kt0 + 8 i + 2 t + (e & 1)
#pragma unroll
    for (int i = 0; i < TK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float pe = hw::ex2(s[i][e] * scale_log2 - lse2[r]);
        if (need_mask) {
          const int key = kt0 + 8 * i + 2 * t + (e & 1);
          if (pr[r] >= n_rows || key >= Sk || (causal && key > qi[r]) ||
              (windowed && key <= qi[r] - window))
            pe = 0.f;
        }
        dp[i][e] = pe * (dp[i][e] - dd[r]);
      }
    }
    // dQ += dS K: dS as A fragments in registers, K as B through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t da[4];
      da[0] = hw::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = hw::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = hw::pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = hw::pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dpi = 0; dpi < DH / 16; ++dpi) {
        uint32_t kb[4];
        hw::ldmatrix_x4_trans(kb, sk(buf) + ((kk * 16 + lane % 16) * LD
                                             + dpi * 16 + 8 * (lane / 16)) * 2);
        hw::mma_bf16(adq[2 * dpi], da, kb[0], kb[1]);
        hw::mma_bf16(adq[2 * dpi + 1], da, kb[2], kb[3]);
      }
    }
  }

  // round once, stage in the warp's own Q rows, store rows of 16 bytes
  hw::cp_async_wait<0>();
  __syncthreads();                    // every copy into Q has landed
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(smem_raw)
                       + 16 * warp * LD;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const int col = 8 * i + 2 * t;
    *reinterpret_cast<uint32_t*>(stg + g * LD + col) =
        hw::pack_bf16(adq[i][0] * scale, adq[i][1] * scale);
    *reinterpret_cast<uint32_t*>(stg + (g + 8) * LD + col) =
        hw::pack_bf16(adq[i][2] * scale, adq[i][3] * scale);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, d = (c % CH) * 8, p = wp + r;
    if (p < n_rows)
      *reinterpret_cast<uint4*>(dq + row_off(p) + d) =
          *reinterpret_cast<const uint4*>(stg + r * LD + d);
  }
}

// ------------------------------ bf16 backward (wgmma and TMA, Hopper)
// dK/dV: NWG warpgroups of 64 keys, steps of BQ = 64 rows (whole queries:
// 64 / G of them), NS ring stages; PIPE computes a step's P^T and dS^T while
// the step before's dV and dK are on the tensor cores (registers allowing).
template <int DH, int NWG_, int NS_, bool PIPE_>
struct DkdvShape {
  static constexpr int NWG = NWG_, NS = NS_, BQ = 64;
  static constexpr bool PIPE = PIPE_;
  static constexpr int SPANS = (DH + 63) / 64;   // 64-column (128-byte) spans
  static constexpr int KEYS = 64 * NWG;          // keys a block
  static constexpr int THREADS = 128 * NWG;
  static constexpr int KV_SPAN = KEYS * 128;     // bytes of a K or V span
  static constexpr int KV_BYTES = 2 * SPANS * KV_SPAN;   // K's, then V's
  static constexpr int Q_SPAN = BQ * 128;        // a step's Q or dO span
  static constexpr int STAGE = 2 * SPANS * Q_SPAN;       // Q's, then dO's
  // its LSE log2(e), then D: each a box of BQ + 4 floats from the 16-byte
  // aligned element at or below the step's first row, in 384 bytes
  static constexpr int STAT_BOX = BQ + 4;
  static constexpr int STAT_HALF = 384;
  static constexpr int STAT = 2 * STAT_HALF;
  static constexpr int SMEM =
      1024 + KV_BYTES + NS * (STAGE + STAT) + (NS + 1) * 8 + NS * 4;
};
// dQ: NWG warpgroups of 64 rows, TK keys a K/V tile, NS ring stages, MINB
// blocks an SM
template <int DH, int NWG_, int TK_, int NS_, int MINB_>
struct DqShape {
  static constexpr int NWG = NWG_, TK = TK_, NS = NS_, MINB = MINB_;
  static constexpr int SPANS = (DH + 63) / 64;
  static constexpr int ROWS = 64 * NWG;          // rows a block, at most
  static constexpr int THREADS = 128 * NWG;
  static constexpr int Q_SPAN = ROWS * 128;      // bytes of a Q or dO span
  static constexpr int Q_BYTES = 2 * SPANS * Q_SPAN;     // Q's, then dO's
  static constexpr int KV_SPAN = TK * 128;
  static constexpr int STAGE = 2 * SPANS * KV_SPAN;      // K's, then V's
  static constexpr int SMEM = 1024 + Q_BYTES + NS * STAGE + (NS + 1) * 8 + NS * 4;
};
// Chosen by timing the three timed rows on the H100 (chip_smoke.py prints
// each kernel's registers; PERF.md): dK/dV blocks of one warpgroup at Dh
// 64 and 128 (two blocks an SM for the registers; finer blocks even out
// the causal rows' work), of two at Dh 96; at Dh 128 each step waited for
// in turn (PIPE's registers spill there).  dQ: three blocks of one
// warpgroup an SM at Dh 64, one of three at Dh 96, one of two at Dh 128.
template <int DH> struct DkdvCfg;
template <> struct DkdvCfg<64> : DkdvShape<64, 1, 4, true> {};
template <> struct DkdvCfg<96> : DkdvShape<96, 2, 4, true> {};
template <> struct DkdvCfg<128> : DkdvShape<128, 1, 2, false> {};
template <int DH> struct DqCfg;
template <> struct DqCfg<64> : DqShape<64, 1, 64, 3, 3> {};
template <> struct DqCfg<96> : DqShape<96, 3, 64, 3, 1> {};
template <> struct DqCfg<128> : DqShape<128, 2, 64, 3, 1> {};

// One block per (tile of 64 NWG keys, b, kv head); warpgroup wg owns keys
// 64 wg .. 64 wg + 63 of the tile.  Shared memory, 1024-byte aligned: K's
// spans and V's spans (KEYS rows of 128 bytes each, 128-byte swizzled, as
// TMA writes them), loaded once; NS stages of Q's and dO's spans (BQ rows);
// the stages' LSE log2(e) and D (BQ floats each, from the D kernel's
// row-ordered scratch); the stages' full barriers, K/V's barrier and the
// stages' release counts.  Thread 0 loads K, V and the first NS steps; the
// last warpgroup to release a stage loads the step NS on into it.
template <int DH>
__global__ void __launch_bounds__(DkdvCfg<DH>::THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_do,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_stat,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int n_stat,
                            int Sq, int Sk, int H, int KV, float scale_log2,
                            float scale, int causal, int window) {
  using C = DkdvCfg<DH>;
  constexpr int NS = C::NS, BQ = C::BQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  const uint32_t sv = sk + C::SPANS * C::KV_SPAN;
  auto sq = [&](int s) { return sk + C::KV_BYTES + s * C::STAGE; };
  auto sg = [&](int s) { return sq(s) + C::SPANS * C::Q_SPAN; };
  const uint32_t stat0 = sk + C::KV_BYTES + NS * C::STAGE;
  auto sl = [&](int s) { return stat0 + s * C::STAT; };
  const uint32_t bars = stat0 + NS * C::STAT;
  auto full = [&](int s) { return bars + 8 * s; };
  const uint32_t kvbar = bars + 8 * NS;
  uint32_t* released =
      reinterpret_cast<uint32_t*>(smem_raw + (bars - raw) + 8 * (NS + 1));

  const int G = H / KV;
  const int qps = BQ / G;                // queries a step
  const int rows = qps * G;              // its rows (BQ when G divides it)
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int k0 = blockIdx.x * C::KEYS;
  const bool windowed = causal && window > 0;
  // queries that can see a key of the block: >= k0 (causal) and < the last
  // key + window (a window); steps of qps of them from q_begin
  const int q_begin = causal ? k0 : 0;
  const int q_end =
      windowed ? min(Sq, min(Sk, k0 + C::KEYS) - 1 + window) : Sq;
  const int n_steps = (q_end - q_begin + qps - 1) / qps;    // >= 1
  const int stat_row0 = blockIdx.y * Sq * G;    // this head's first row

  // the step's first row in the statistics (its LSE log2(e); its D is
  // n_stat on), loaded from the 16-byte aligned element at or below it
  auto stat_at = [&](int st) { return stat_row0 + (q_begin + st * qps) * G; };
  auto load_step = [&](int st) {
    const int s = st % NS, q0 = q_begin + st * qps;
    hw::mbar_expect_tx(full(s),
                       2 * C::SPANS * rows * 128 + 2 * C::STAT_BOX * 4);
#pragma unroll
    for (int c = 0; c < C::SPANS; ++c) {
      hw::tma_load_4d(sq(s) + c * C::Q_SPAN, &map_q, full(s), 64 * c, kvh * G,
                      q0, b);
      hw::tma_load_4d(sg(s) + c * C::Q_SPAN, &map_do, full(s), 64 * c,
                      kvh * G, q0, b);
    }
    hw::tma_load_1d(sl(s), &map_stat, full(s), stat_at(st) & ~3);
    hw::tma_load_1d(sl(s) + C::STAT_HALF, &map_stat, full(s),
                    (n_stat + stat_at(st)) & ~3);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hw::mbar_init(full(s), 1);
      released[s] = 0;
    }
    hw::mbar_init(kvbar, 1);
    hw::mbar_fence_init();
  }
  // rows BQ - rows .. of every stage's spans, which no box writes, are
  // zeros: they are the K dimension of dV += P^T dO and dK += dS^T Q
  if (rows < BQ) {
    constexpr int PER_ROW = 8;                          // 16-byte chunks
    const int n = NS * 2 * C::SPANS * (BQ - rows) * PER_ROW;
    for (int i = threadIdx.x; i < n; i += C::THREADS) {
      const int j = i % PER_ROW, r = rows + (i / PER_ROW) % (BQ - rows);
      const int span = i / PER_ROW / (BQ - rows);     // over stages x 2 x SPANS
      hw::st_shared_zero16(sq(0) + (span / (2 * C::SPANS)) * C::STAGE +
                           (span % (2 * C::SPANS)) * C::Q_SPAN + r * 128 +
                           16 * j);
    }
    hw::fence_proxy_async();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hw::mbar_expect_tx(kvbar, C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::SPANS; ++c) {
      hw::tma_load_4d(sk + c * C::KV_SPAN, &map_k, kvbar, 64 * c, kvh, k0, b);
      hw::tma_load_4d(sv + c * C::KV_SPAN, &map_v, kvbar, 64 * c, kvh, k0, b);
    }
    for (int st = 0; st < min(n_steps, NS); ++st) load_step(st);
  }

  // the warpgroup, broadcast from lane 0 so that the compiler knows it is
  // warp-uniform (the wgmma after branches on it stay asynchronous)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wk0 = k0 + 64 * wg;          // the warpgroup's first key
  // this thread's keys (rows of S^T): 16 warp + g and + 8
  const int kj[2] = {wk0 + 16 * warp + g, wk0 + 16 * warp + g + 8};

  float adk[DH / 2], adv[DH / 2], sc[BQ / 2], dp[BQ / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) adk[i] = adv[i] = 0.f;
  hw::mbar_wait_uniform(kvbar, 0);

  // S^T = K Q^T (into sc) or dP^T = V dO^T (into dp) for step st: the
  // warpgroup's 64 K (V) rows against the step's BQ Q (dO) rows, both
  // K-major, k16 steps along the head dim; committed, not waited on
  auto issue_t = [&](uint32_t a_base, uint32_t b_base, float (&d)[BQ / 2]) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t dA = hw::wgmma_desc(
          a_base + (kk / 4) * C::KV_SPAN + wg * 8192 + off, 16, 1024);
      const uint64_t dB =
          hw::wgmma_desc(b_base + (kk / 4) * C::Q_SPAN + off, 16, 1024);
      hw::wgmma_ss_kmajor<BQ>(d, dA, dB, kk > 0);
    }
    hw::wgmma_commit();
    hw::fence_regs(d);
  };
  auto issue_sdp = [&](int st) {
    issue_t(sk, sq(st % NS), sc);
    issue_t(sv, sg(st % NS), dp);
  };
  // acc += A B with A (P^T or dS^T, packed) from registers, B the step's dO
  // or Q MN-major: a k16 step is 16 rows (2048 bytes) on
  auto issue_acc = [&](float (&acc)[DH / 2], uint32_t (&a)[BQ / 16][4],
                       uint32_t b_base) {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hw::wgmma_rs_mnmajor<DH>(
          acc, a[kk], hw::wgmma_desc(b_base + kk * 2048, C::Q_SPAN, 1024), 1);
    hw::wgmma_commit();
    hw::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) hw::fence_regs(a[kk]);
  };
  auto fence_all = [&]() {
    hw::fence_regs(sc);
    hw::fence_regs(dp);
    hw::fence_regs(adk);
    hw::fence_regs(adv);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hw::fence_regs(pa[kk]);
      hw::fence_regs(da[kk]);
    }
  };
  // step st's Q and dO are read: the last warpgroup to say so loads step
  // st + NS into the stage
  auto release = [&](int st) {
    if (tid == 0) {
      const int s = st % NS;
      if (atomicAdd(&released[s], 1u) % C::NWG == C::NWG - 1 &&
          st + NS < n_steps)
        load_step(st + NS);
    }
  };
  auto skipped = [&](int st) {
    const int q_lo = q_begin + st * qps, q_hi = min(q_lo + qps, Sq) - 1;
    return wk0 >= Sk || (causal && wk0 > q_hi) ||
           (windowed && wk0 + 63 <= q_lo - window);
  };
  // P^T = 2^(S^T scale log2(e) - LSE log2(e)) in place of S^T, 0 where the
  // pair is masked (element e of column group j: key kj[e / 2], step row 8
  // j + 2 t + (e & 1)), then dS^T = P^T o (dP^T - D) in place of dP^T; the
  // LSE and D by column from the stage
  auto grads = [&](int st) {
    const float* ls =
        reinterpret_cast<const float*>(smem_raw + (sl(st % NS) - raw)) +
        (stat_at(st) & 3);
    const float* ds = reinterpret_cast<const float*>(
                          smem_raw + (sl(st % NS) - raw) + C::STAT_HALF) +
                      ((n_stat + stat_at(st)) & 3);
    const int q_lo = q_begin + st * qps, q_hi = min(q_lo + qps, Sq) - 1;
    const bool edge = rows < BQ || q_lo + qps > Sq || wk0 + 64 > Sk ||
                      (causal && wk0 + 63 > q_lo) ||
                      (windowed && wk0 <= q_hi - window);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float l0 = ls[8 * j + 2 * t], l1 = ls[8 * j + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] =
            hw::ex2(fmaf(sc[4 * j + e], scale_log2, -((e & 1) ? l1 : l0)));
    }
    if (edge) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t + (e & 1), key = kj[e / 2];
          const int qi = q_lo + r / G;
          if (r >= rows || qi >= Sq || key >= Sk || (causal && key > qi) ||
              (windowed && key <= qi - window))
            sc[4 * j + e] = 0.f;
        }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float d0 = ds[8 * j + 2 * t], d1 = ds[8 * j + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d1 : d0));
    }
  };
  // P^T and dS^T packed to bf16 A fragments (the accumulator columns 16 kk
  // .. 16 kk + 15 are k16 step kk's)
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = hw::pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
        da[kk][e] = hw::pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      }
  };
  auto issue_dkdv = [&](int st) {       // dV += P^T dO, dK += dS^T Q
    issue_acc(adv, pa, sg(st % NS));
    issue_acc(adk, da, sq(st % NS));
  };

  // The warpgroup computes steps a .. z: the steps before them see none of
  // its keys (causal), those after them lie past its window; those are
  // waited for and released only.  PIPE: step st's S^T and dP^T are issued,
  // then step st - 1's dV and dK; P^T and dS^T are computed while those run
  // and packed once they are done (ptxas serializes every wgmma if S^T is
  // read while dP^T, issued with it, is in flight).  Else each step is
  // issued and waited for in turn.  At most two stages are held, so a ring
  // of two or more never waits on itself.  No wgmma is under a branch that
  // is not warp-uniform.
  int a = 0, z = n_steps - 1;
  while (a < n_steps && skipped(a)) ++a;
  while (z >= a && skipped(z)) --z;
  auto pass = [&](int st) {
    hw::mbar_wait_uniform(full(st % NS), (st / NS) & 1);
    release(st);
  };
  for (int st = 0; st < a; ++st) pass(st);
  if (a <= z) {
    hw::mbar_wait_uniform(full(a % NS), (a / NS) & 1);
    fence_all();
    hw::wgmma_fence();
    issue_sdp(a);
    hw::wgmma_wait<0>();
    fence_all();
    grads(a);
    pack();
    for (int st = a + 1; st <= z; ++st) {
      if constexpr (!C::PIPE) {
        fence_all();
        hw::wgmma_fence();
        issue_dkdv(st - 1);
        hw::wgmma_wait<0>();
        fence_all();
        release(st - 1);
      }
      hw::mbar_wait_uniform(full(st % NS), (st / NS) & 1);
      fence_all();
      hw::wgmma_fence();
      issue_sdp(st);
      if constexpr (C::PIPE) {
        issue_dkdv(st - 1);
        hw::wgmma_wait<2>();            // S^T, dP^T (dV, dK in flight)
        hw::fence_regs(sc);
        hw::fence_regs(dp);
        grads(st);
        hw::wgmma_wait<0>();
        fence_all();
        release(st - 1);
      } else {
        hw::wgmma_wait<0>();
        fence_all();
        grads(st);
      }
      pack();
    }
    fence_all();
    hw::wgmma_fence();
    issue_dkdv(z);
    hw::wgmma_wait<0>();
    fence_all();
    release(z);
  }
  for (int st = max(a, z + 1); st < n_steps; ++st) pass(st);

  // dK (scaled) and dV rounded once, staged in the warpgroup's own K and V
  // rows (its products are done) in their 128-byte swizzle, then stored in
  // 16-byte rows
  auto stg = [&](uint32_t base, int r, int j) {   // row r, 16-byte chunk j
    return base + wg * 8192 + (j / 8) * C::KV_SPAN + r * 128 +
           (((j % 8) ^ (r % 8)) << 4);
  };
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int r = 16 * warp + g;
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(stg(sk, r, j) + 4 * t),
                 "r"(hw::pack_bf16(adk[4 * j] * scale, adk[4 * j + 1] * scale))
                 : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(stg(sk, r + 8, j) + 4 * t),
                 "r"(hw::pack_bf16(adk[4 * j + 2] * scale,
                                   adk[4 * j + 3] * scale))
                 : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(stg(sv, r, j) + 4 * t),
                 "r"(hw::pack_bf16(adv[4 * j], adv[4 * j + 1]))
                 : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(stg(sv, r + 8, j) + 4 * t),
                 "r"(hw::pack_bf16(adv[4 * j + 2], adv[4 * j + 3]))
                 : "memory");
  }
  hw::named_sync(1 + wg, 128);
  for (int c = tid; c < 64 * (DH / 8); c += 128) {
    const int r = c / (DH / 8), j = c % (DH / 8), key = wk0 + r;
    if (key < Sk) {
      const size_t off = (((size_t)b * Sk + key) * KV + kvh) * DH + 8 * j;
      *reinterpret_cast<uint4*>(dk + off) = hw::ld_shared16(stg(sk, r, j));
      *reinterpret_cast<uint4*>(dv + off) = hw::ld_shared16(stg(sv, r, j));
    }
  }
}

// One block per (tile of up to 64 NWG rows, b, kv head), rows as the
// forward's (flash_wgmma_kernel, whose skeleton this is): Q's and dO's
// spans arrive once by TMA and stay; K and V tiles stream through the
// ring.  Per tile: S = Q K^T and dP = dO V^T (wgmma, K-major), P and dS in
// registers with each row's LSE log2(e) and D held in registers, dQ += dS
// K with dS packed as the A operand and K's tile MN-major.  Tile i's S and
// dP are issued before tile i - 1's dS K, so dS is computed while dQ's
// product is on the tensor cores.
template <int DH>
__global__ void __launch_bounds__(DqCfg<DH>::THREADS, DqCfg<DH>::MINB)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const float* __restrict__ stat,
                          __nv_bfloat16* __restrict__ dq, int n_stat, int Sq,
                          int Sk, int H, int KV, float scale_log2,
                          float scale, int causal, int window) {
  using C = DqCfg<DH>;
  constexpr int TK = C::TK, NS = C::NS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t sg = sq + C::SPANS * C::Q_SPAN;
  auto sk = [&](int s) { return sq + C::Q_BYTES + s * C::STAGE; };
  auto sv = [&](int s) { return sk(s) + C::SPANS * C::KV_SPAN; };
  const uint32_t bars = sq + C::Q_BYTES + NS * C::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  const uint32_t qbar = bars + 8 * NS;
  uint32_t* released =
      reinterpret_cast<uint32_t*>(smem_raw + (bars - raw) + 8 * (NS + 1));

  const int G = H / KV;
  const int qpb = C::ROWS / G;           // queries a block
  const int rows = qpb * G;              // its rows
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  // row tiles in reverse, so the tiles with the most keys start first
  const int s0 = (gridDim.x - 1 - blockIdx.x) * qpb;    // first query
  const int p0 = s0 * G;                                // first row
  const int n_rows = Sq * G;
  const int q_last = min(n_rows - 1, p0 + rows - 1) / G;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const bool windowed = causal && window > 0;
  const int j0 = windowed ? max(0, s0 - window + 1) / TK : 0;
  const int nt = (k_end + TK - 1) / TK - j0;            // >= 1 (Sk > 0)

  auto load_kv = [&](int it) {           // tile j0 + it into its stage
    const int s = it % NS, k0 = (j0 + it) * TK;
    hw::mbar_expect_tx(full(s), C::STAGE);
#pragma unroll
    for (int c = 0; c < C::SPANS; ++c) {
      hw::tma_load_4d(sk(s) + c * C::KV_SPAN, &map_k, full(s), 64 * c, kvh, k0,
                      b);
      hw::tma_load_4d(sv(s) + c * C::KV_SPAN, &map_v, full(s), 64 * c, kvh, k0,
                      b);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hw::mbar_init(full(s), 1);
      released[s] = 0;
    }
    hw::mbar_init(qbar, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hw::mbar_expect_tx(qbar, 2 * C::SPANS * rows * 128);
#pragma unroll
    for (int c = 0; c < C::SPANS; ++c) {
      hw::tma_load_4d(sq + c * C::Q_SPAN, &map_q, qbar, 64 * c, kvh * G, s0, b);
      hw::tma_load_4d(sg + c * C::Q_SPAN, &map_do, qbar, 64 * c, kvh * G, s0,
                      b);
    }
    for (int it = 0; it < min(nt, NS); ++it) load_kv(it);
  }

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wp = p0 + 64 * wg;
  const int w_first = wp / G, w_last = (wp + 63) / G;
  // this thread's rows 16 warp + g and + 8: query, LSE log2(e), D
  int qi[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = 64 * wg + 16 * warp + g + 8 * r, p = p0 + rr;
    qi[r] = p / G;
    const bool ok = rr < rows && p < n_rows;
    const int idx = blockIdx.y * n_rows + p;
    lse2[r] = ok ? stat[idx] : 0.f;
    dd[r] = ok ? stat[n_stat + idx] : 0.f;
  }

  float acc[DH / 2], sc[TK / 2], dp[TK / 2];
  uint32_t da[TK / 16][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  hw::mbar_wait_uniform(qbar, 0);

  // S = Q K^T (sc) and dP = dO V^T (dp) for tile it: the warpgroup's 64
  // rows against TK keys, k16 steps along the head dim; each committed
  auto issue_t = [&](uint32_t a_base, uint32_t b_base, float (&d)[TK / 2]) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t dA = hw::wgmma_desc(
          a_base + (kk / 4) * C::Q_SPAN + wg * 8192 + off, 16, 1024);
      const uint64_t dB =
          hw::wgmma_desc(b_base + (kk / 4) * C::KV_SPAN + off, 16, 1024);
      hw::wgmma_ss_kmajor<TK>(d, dA, dB, kk > 0);
    }
    hw::wgmma_commit();
    hw::fence_regs(d);
  };
  // dQ += dS K for tile it: dS (da) from registers, K MN-major
  auto issue_dq = [&](int it) {
    const uint32_t kb = sk(it % NS);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      hw::wgmma_rs_mnmajor<DH>(
          acc, da[kk], hw::wgmma_desc(kb + kk * 2048, C::KV_SPAN, 1024), 1);
    hw::wgmma_commit();
    hw::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) hw::fence_regs(da[kk]);
  };
  auto fence_all = [&]() {
    hw::fence_regs(sc);
    hw::fence_regs(dp);
    hw::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) hw::fence_regs(da[kk]);
  };
  auto release = [&](int it) {
    if (tid == 0) {
      const int s = it % NS;
      if (atomicAdd(&released[s], 1u) % C::NWG == C::NWG - 1 && it + NS < nt)
        load_kv(it + NS);
    }
  };
  // dS = P o (dP - D) in place of dP, P = 2^(S scale log2(e) - LSE log2(e)),
  // 0 where the pair is masked (element e of key group j: row r = e / 2,
  // key kt0 + 8 j + 2 t + (e & 1))
  auto dsoft = [&](int it) {
    const int kt0 = (j0 + it) * TK;
    const bool edge = kt0 + TK > Sk || (causal && kt0 + TK - 1 > w_first) ||
                      (windowed && kt0 <= w_last - window);
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      const int r = (i % 4) / 2;
      float pe = hw::ex2(fmaf(sc[i], scale_log2, -lse2[r]));
      if (edge) {
        const int key = kt0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (key >= Sk || (causal && key > qi[r]) ||
            (windowed && key <= qi[r] - window))
          pe = 0.f;
      }
      dp[i] = pe * (dp[i] - dd[r]);
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        da[kk][e] = hw::pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
  };

  auto skipped = [&](int it) {
    const int kt0 = (j0 + it) * TK;
    return (causal && kt0 > w_last) ||
           (windowed && kt0 + TK - 1 <= w_first - window);
  };
  int a = 0, z = nt - 1;
  while (a < nt && skipped(a)) ++a;
  while (z >= a && skipped(z)) --z;
  auto pass = [&](int it) {
    hw::mbar_wait_uniform(full(it % NS), (it / NS) & 1);
    release(it);
  };
  for (int it = 0; it < a; ++it) pass(it);
  if (a <= z) {
    hw::mbar_wait_uniform(full(a % NS), (a / NS) & 1);
    fence_all();
    hw::wgmma_fence();
    issue_t(sq, sk(a % NS), sc);
    issue_t(sg, sv(a % NS), dp);
    hw::wgmma_wait<0>();
    fence_all();
    dsoft(a);
    pack();
    for (int it = a + 1; it <= z; ++it) {
      hw::mbar_wait_uniform(full(it % NS), (it / NS) & 1);
      fence_all();
      hw::wgmma_fence();
      issue_t(sq, sk(it % NS), sc);
      issue_t(sg, sv(it % NS), dp);
      issue_dq(it - 1);
      hw::wgmma_wait<1>();
      hw::fence_regs(sc);
      hw::fence_regs(dp);
      dsoft(it);
      hw::wgmma_wait<0>();
      fence_all();
      release(it - 1);
      pack();
    }
    fence_all();
    hw::wgmma_fence();
    issue_dq(z);
    hw::wgmma_wait<0>();
    fence_all();
    release(z);
  }
  for (int it = max(a, z + 1); it < nt; ++it) pass(it);

  // dQ scaled, rounded once, staged in the warpgroup's own Q rows (its
  // products are done) in their 128-byte swizzle, then stored in 16-byte
  // rows
  const uint32_t stg = sq + wg * 8192;
  auto stg_addr = [&](int r, int j) {      // row r, 16-byte chunk j (8 cols)
    return stg + (j / 8) * C::Q_SPAN + r * 128 + (((j % 8) ^ (r % 8)) << 4);
  };
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int r = 16 * warp + g;
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(stg_addr(r, j) + 4 * t),
                 "r"(hw::pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale))
                 : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(stg_addr(r + 8, j) + 4 * t),
                 "r"(hw::pack_bf16(acc[4 * j + 2] * scale,
                                   acc[4 * j + 3] * scale))
                 : "memory");
  }
  hw::named_sync(1 + wg, 128);
  for (int c = tid; c < 64 * (DH / 8); c += 128) {
    const int r = c / (DH / 8), j = c % (DH / 8);
    const int rr = 64 * wg + r, p = p0 + rr;
    if (rr < rows && p < n_rows)
      *reinterpret_cast<uint4*>(
          dq + (((size_t)b * Sq + p / G) * H + kvh * G + p % G) * DH + 8 * j) =
          hw::ld_shared16(stg_addr(r, j));
  }
}

template <typename T, int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk,
               void* dv, float* Dd, int B, int Sq, int Sk, int H, int KV,
               float scale, int causal, int window, cudaStream_t s) {
  using S = BwdSmem<DH>;
  static bool smem_ok = false;        // set once per instantiation
  if (!smem_ok) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::DKDV);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 S::DQ);
    if (err != cudaSuccess) return (int)err;
    smem_ok = true;
  }
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  const long rows = (long)B * Sq * H;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + BWD_NT / 32 - 1) / (BWD_NT / 32)),
                            BWD_NT, 0, s>>>(static_cast<const T*>(o), gp, Dd,
                                            B, Sq, H, DH);
  if (Sk > 0) {
    flash_bwd_dkdv_kernel<T, DH>
        <<<dim3((Sk + KB_KEYS - 1) / KB_KEYS, B * KV), BWD_NT, S::DKDV, s>>>(
            qp, kp, vp, gp, lse, Dd, static_cast<T*>(dk), static_cast<T*>(dv),
            Sq, Sk, H, KV, scale, causal, window);
  }
  flash_bwd_dq_kernel<T, DH>
      <<<dim3((Sq + QB_Q - 1) / QB_Q, B * H), BWD_NT, S::DQ, s>>>(
          qp, kp, vp, gp, lse, Dd, static_cast<T*>(dq), Sq, Sk, H, KV, scale,
          causal, window);
  return 0;
}

template <int DH>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk,
                   void* dv, float* Dd, int B, int Sq, int Sk, int H, int KV,
                   float scale, int causal, int window, cudaStream_t s) {
  using C = BwdCfg<DH>;
  static bool smem_ok = false;        // set once per instantiation
  if (!smem_ok) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_mma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKDV_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 C::DQ_SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_ok = true;
  }
  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* gp = static_cast<const bf*>(dout);
  const float scale_log2 = scale * kLog2e;
  const long rows = (long)B * Sq * H;
  flash_bwd_dot_bf16_kernel<DH, false><<<dot_blocks<DH>(rows), BWD_NT, 0, s>>>(
      static_cast<const bf*>(o), gp, lse, Dd, rows, Sq, H, KV);
  if (Sk > 0) {
    flash_bwd_dkdv_mma_kernel<DH>
        <<<dim3((Sk + C::KEYS - 1) / C::KEYS, B * KV), C::NW * 32,
           C::DKDV_SMEM, s>>>(qp, kp, vp, gp, lse, Dd, static_cast<bf*>(dk),
                              static_cast<bf*>(dv), Sq, Sk, H, KV,
                              scale_log2, scale, causal, window);
  }
  const long grows = (long)Sq * (H / KV);
  flash_bwd_dq_mma_kernel<DH>
      <<<dim3(B * KV, (unsigned)((grows + C::ROWS - 1) / C::ROWS)),
         C::NW * 32, C::DQ_SMEM, s>>>(qp, kp, vp, gp, lse, Dd,
                                      static_cast<bf*>(dq), Sq, Sk, H, KV,
                                      scale_log2, scale, causal, window);
  return 0;
}

// The wgmma route: D (with each row's LSE log2(e)) in row order into Dd's 2
// N floats, then dK/dV, then dQ.  q, dO as (Dh, H, Sq, B) in boxes of 64
// columns x the group's G heads x (BQ or ROWS) / G queries, so a box lands
// as rows in order; k, v as (Dh, KV, Sk, B) in boxes of 64 columns x KEYS or
// TK keys of one kv head; the statistics as one 1-D f32 map of BQ boxes.
template <int DH>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     void* dq, void* dk, void* dv, float* Dd, int B, int Sq,
                     int Sk, int H, int KV, float scale, int causal,
                     int window, cudaStream_t s) {
  using KC = DkdvCfg<DH>;
  using QC = DqCfg<DH>;
  const uint32_t G = H / KV;
  const long n_stat = (long)B * H * Sq;
  CUtensorMap map_qs, map_gs, map_kb, map_vb, map_st, map_qr, map_gr, map_kt,
      map_vt;
  const uint64_t dims_q[4] = {(uint64_t)DH, (uint64_t)H, (uint64_t)Sq,
                              (uint64_t)B};
  const uint64_t dims_kv[4] = {(uint64_t)DH, (uint64_t)KV, (uint64_t)Sk,
                               (uint64_t)B};
  const uint32_t box_qs[4] = {64, G, KC::BQ / G, 1};
  const uint32_t box_kb[4] = {64, 1, KC::KEYS, 1};
  const uint32_t box_qr[4] = {64, G, QC::ROWS / G, 1};
  const uint32_t box_kt[4] = {64, 1, QC::TK, 1};
  if (!hw::encode_bf16(&map_qs, q, 4, dims_q, box_qs) ||
      !hw::encode_bf16(&map_gs, dout, 4, dims_q, box_qs) ||
      !hw::encode_bf16(&map_kb, k, 4, dims_kv, box_kb) ||
      !hw::encode_bf16(&map_vb, v, 4, dims_kv, box_kb) ||
      !hw::encode_f32_1d(&map_st, Dd, 2 * n_stat, KC::STAT_BOX) ||
      !hw::encode_bf16(&map_qr, q, 4, dims_q, box_qr) ||
      !hw::encode_bf16(&map_gr, dout, 4, dims_q, box_qr) ||
      !hw::encode_bf16(&map_kt, k, 4, dims_kv, box_kt) ||
      !hw::encode_bf16(&map_vt, v, 4, dims_kv, box_kt))
    return (int)cudaErrorInvalidValue;
  static bool smem_ok = false;        // set once per instantiation
  if (!smem_ok) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_wgmma_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, KC::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 QC::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_ok = true;
  }
  using bf = __nv_bfloat16;
  const float scale_log2 = scale * kLog2e;
  flash_bwd_dot_bf16_kernel<DH, true><<<dot_blocks<DH>(n_stat), BWD_NT, 0, s>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, Dd,
      n_stat, Sq, H, KV);
  flash_bwd_dkdv_wgmma_kernel<DH>
      <<<dim3((Sk + KC::KEYS - 1) / KC::KEYS, B * KV), KC::THREADS, KC::SMEM,
         s>>>(map_qs, map_gs, map_kb, map_vb, map_st, static_cast<bf*>(dk),
              static_cast<bf*>(dv), (int)n_stat, Sq, Sk, H, KV, scale_log2,
              scale, causal, window);
  const int qpb = QC::ROWS / G;
  flash_bwd_dq_wgmma_kernel<DH>
      <<<dim3((Sq + qpb - 1) / qpb, B * KV), QC::THREADS, QC::SMEM, s>>>(
          map_qr, map_gr, map_kt, map_vt, Dd, static_cast<bf*>(dq),
          (int)n_stat, Sq, Sk, H, KV, scale_log2, scale, causal, window);
  return 0;
}

// The bf16 routes (ops.attention_bwd_plan chooses one by shape and passes it
// in): the wgmma kernels need a (b, kv head) of 64 rows or more (a step's, a
// warpgroup's tile), keys to map (a tensor map has no extent 0), a group of
// at most 64 heads (a dK/dV step of 64 rows holds whole queries) and the
// statistics' 2 B H Sq floats within a TMA coordinate; mma.sync takes any
// shape.
bool bwd_wgmma_legal(int B, int Sq, int Sk, int H, int KV) {
  return (long)Sq * (H / KV) >= 64 && Sk > 0 && H / KV <= 64 &&
         2L * B * H * Sq < (1L << 31);
}

template <int DH>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const float* lse,
                    void* dq, void* dk, void* dv, float* Dd, int B, int Sq,
                    int Sk, int H, int KV, float scale, int causal,
                    int window, int route, cudaStream_t s) {
  if (route == kRouteWgmma && bwd_wgmma_legal(B, Sq, Sk, H, KV))
    return launch_bwd_wgmma<DH>(q, k, v, o, dout, lse, dq, dk, dv, Dd, B, Sq,
                                Sk, H, KV, scale, causal, window, s);
  if (route == kRouteMma)
    return launch_bwd_mma<DH>(q, k, v, o, dout, lse, dq, dk, dv, Dd, B, Sq,
                              Sk, H, KV, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch_bwd_f32(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     void* dq, void* dk, void* dv, float* Dd, int B, int Sq,
                     int Sk, int H, int KV, int Dh, float scale, int causal,
                     int window, cudaStream_t s) {
  if (Dh == 64)
    return launch_bwd<float, 64>(q, k, v, o, dout, lse, dq, dk, dv, Dd, B, Sq,
                                 Sk, H, KV, scale, causal, window, s);
  if (Dh == 96)
    return launch_bwd<float, 96>(q, k, v, o, dout, lse, dq, dk, dv, Dd, B, Sq,
                                 Sk, H, KV, scale, causal, window, s);
  if (Dh == 128)
    return launch_bwd<float, 128>(q, k, v, o, dout, lse, dq, dk, dv, Dd, B,
                                  Sq, Sk, H, KV, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

int dispatch_bwd_bf16(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      void* dq, void* dk, void* dv, float* Dd, int B, int Sq,
                      int Sk, int H, int KV, int Dh, float scale, int causal,
                      int window, int route, cudaStream_t s) {
  if (Dh == 64)
    return launch_bwd_bf16<64>(q, k, v, o, dout, lse, dq, dk, dv, Dd, B, Sq,
                               Sk, H, KV, scale, causal, window, route, s);
  if (Dh == 96)
    return launch_bwd_bf16<96>(q, k, v, o, dout, lse, dq, dk, dv, Dd, B, Sq,
                               Sk, H, KV, scale, causal, window, route, s);
  if (Dh == 128)
    return launch_bwd_bf16<128>(q, k, v, o, dout, lse, dq, dk, dv, Dd, B,
                                Sq, Sk, H, KV, scale, causal, window, route,
                                s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: [B,Sq,H,Dh]; k, v: [B,Sk,KV,Dh]; all contiguous, one dtype (code);
// window 0, or > 0 with causal.  lse: null (serving), or [B,H,Sq] f32 that
// receives each row's logsumexp of the scaled, masked scores (+inf for a
// row with no key), which the backward needs.  route: the kernel
// ops.attention_plan chose (Route; f32 takes only kRouteFma); on kRouteSplit
// the keys go in `splits` runs of `keys` (whole 64-key tiles) and part is
// f32 scratch of splits B H Sq (Dh + 2) floats, else splits, keys and part
// are not read.  A route that cannot take the shape is refused.  Returns the
// CUDA error code of the launches (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      void* part, int B, int Sq, int Sk,
                                      int H, int KV, int Dh, float scale,
                                      int causal, int window, int route,
                                      int splits, int keys, int dtype,
                                      void* stream) {
  if (KV <= 0 || H % KV != 0 || (causal && Sq != Sk) || B * H > 65535 ||
      window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == rt::kF32 && route == kRouteFma) {
    rc = dispatch_f32(q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, H, KV,
                      Dh, scale, causal, window, s);
  } else if (dtype == rt::kBF16) {
    rc = dispatch_bf16(q, k, v, o, static_cast<float*>(lse),
                       static_cast<float*>(part), B, Sq, Sk, H, KV, Dh, scale,
                       causal, window, route, splits, keys, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// Backward of flash_attention_launch.  q, o, dout, dq: [B,Sq,H,Dh]; k, v,
// dk, dv: [B,Sk,KV,Dh]; all contiguous, one dtype (code); lse: [B,H,Sq] f32
// from the forward; Dd: 2 B H Sq f32 scratch.  The same masks and scale as
// the forward.  route: the kernels ops.attention_bwd_plan chose (kRouteFma
// for f32; kRouteMma or kRouteWgmma for bf16), refused where they cannot
// take the shape.  dq, dk and dv are written, not accumulated.  Returns the
// CUDA error code of the launches (0 = launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv, void* Dd,
    int B, int Sq, int Sk, int H, int KV, int Dh, float scale, int causal,
    int window, int route, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || (causal && Sq != Sk) || B * H > 65535 ||
      window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(Dd);
  int rc;
  if (dtype == rt::kF32 && route == kRouteFma) {
    rc = dispatch_bwd_f32(q, k, v, o, dout, lp, dq, dk, dv, dp, B, Sq, Sk, H,
                          KV, Dh, scale, causal, window, s);
  } else if (dtype == rt::kBF16) {
    rc = dispatch_bwd_bf16(q, k, v, o, dout, lp, dq, dk, dv, dp, B, Sq, Sk, H,
                           KV, Dh, scale, causal, window, route, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}
