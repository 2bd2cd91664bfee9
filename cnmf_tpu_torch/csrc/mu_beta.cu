// Fused general-beta multiplicative-update terms for Hopper (sm_90a), plain
// C ABI.
//
// Replaces the Pallas TPU kernels of cnmf_tpu/ops/pallas_mu.py:
//   beta_mu_w_terms (:198, body _make_beta_w_terms_kernel :173) -> W side
//   beta_mu_h_terms (:281, body _make_beta_h_terms_kernel :239) -> H side
// for beta not in {1, 2} (0 is Itakura-Saito). The same kernels serve both
// sides: F, whose rows index the output, is W (X read by rows) or Ht (X read
// transposed), and the other factor Fo is contracted over. For each output
// row m of each restart and each contraction entry c in ascending order,
//   wh   = F[m] . Fo[c]                              (K FMAs, k ascending from 0)
//   num += X(m, c) . f(wh) . Fo[c]                   (K FMAs)
//   den += g(wh) . Fo[c]                             (K FMAs)
// with the reference's own f and g (pallas_mu.py:179-190): wh floored at
// eps only where the exponent is negative; beta = 0 uses x / (wh . wh) and
// 1 / wh, any other beta powf(wh, beta - 2) and powf(wh, beta - 1). The
// reconstruction WH is never written. The beta = 0 branch is a template
// argument, chosen per launch.
//
// Numerics: IEEE f32 FMA, division, reciprocal (__frcp_rn, the bits of
// 1.0f / w without the division's slow path) and powf (not __powf); no
// fast-math, no TF32, no tensor cores (the Pallas kernels run at HIGHEST,
// pallas_mu.py:45-56).
//
// Zeros: the numerator skips x == 0 (normalized counts are mostly zeros, and
// a zero numerator would send the division down its slow path); the
// denominator cannot: g(wh) is summed over every entry.
//
// What bounds it on an H100: the f32 pipe. Per element and restart it spends
// 3K FMAs plus one division and one reciprocal (beta = 0) or two powf; at
// the factorize shape (B=100, N=2700, G=2000, K=16) that is 6.N.G.K.B = 51.8
// GFLOP per launch against 67 TFLOP/s.
//
// Three designs, on those of mu_kl.cu:
// - The restart-tiled kernel (beta_terms_tiled_kernel), for the buckets the
//   factorize runs (K = 8 and 16) when X has a unit stride and its grid
//   fills the card (tiled_layout). A block owns TM rows of RB restarts:
//   each 16-entry X chunk is staged once for all RB restarts (a block of
//   one restart reads X from L2 B times a launch: 2.16 GB against 21.6 MB
//   at B=100), with the RB restarts' Fo chunks beside it, through a 3-slot
//   cp.async ring whose copy addresses each thread works out once. Each
//   thread owns TR rows of one restart, their rows of F and both
//   accumulator sets in registers, so it has TR independent
//   dot-terms-accumulate chains and reads each staged Fo row once for TR
//   rows.
// - One row per thread of one restart (beta_terms_kernel, 128 rows a
//   block): the other buckets, grids too small for the tiled kernel, X
//   without a unit stride, and the split contraction. Where the grid of
//   (restart, row tile) blocks is too small to fill the card (the B=1
//   consensus refits: 22 or 79 blocks for 132 SMs), the launch splits the
//   contraction into S slices of whole 32-entry chunks, one per
//   blockIdx.z; each slice writes its partial num and den to a workspace,
//   and cnmf::split_sum_kernel adds the partials in slice order. With S = 1
//   the kernel writes num and den itself.
// - K above the register buckets (beta_terms_wide, common.cuh's helpers): the
//   row read from F, the accumulators in the output buffers; never split.
//
// Every (row, restart) pair of a slice sums in the order above, so the
// tiled kernel and the one-row kernel at S = 1 give the same bits. A split
// (S > 1) sums each slice from 0 and then the slices in order: another
// order than S = 1's, the same bits on every run (no atomics).
//
// Padded rows, contraction entries and K columns are exact no-ops: rows past
// M are not stored, entries past C add 0 . g(0) to the denominator (0 for
// every beta) and 0 to the numerator, and a zero K column of Fo adds nothing
// to wh and receives 0.

#include "common.cuh"

namespace {

using cnmf::kThreads;
using cnmf::ld4;
constexpr int kChunk = 32;  // contraction entries staged per shared-memory round
constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon

// r = x . f(wh) (0 where x is 0), g = g(wh).
template <bool IS>
__device__ __forceinline__ void beta_terms(float x, float wh, float beta,
                                           float& r, float& g) {
  if (IS) {
    const float w = fmaxf(wh, kEps);
    r = x == 0.f ? 0.f : x / (w * w);
    g = __frcp_rn(w);
  } else {
    const float wn = beta < 2.f ? fmaxf(wh, kEps) : wh;
    const float wd = beta < 1.f ? fmaxf(wh, kEps) : wh;
    r = x == 0.f ? 0.f : x * powf(wn, beta - 2.f);
    g = powf(wd, beta - 1.f);
  }
}

// ---- the restart-tiled kernel of the factorize's buckets ----

// One contraction entry of one (row, restart) pair: the dot with k ascending
// from 0, the terms, then one fmaf into each accumulator of each set.
template <int K, bool IS>
__device__ __forceinline__ void beta_step(const float (&f)[K], float (&an)[K],
                                          float (&ad)[K], float x,
                                          const float (&fo)[K], float beta) {
  float wh = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) wh = fmaf(f[k], fo[k], wh);
  float r, g;
  beta_terms<IS>(x, wh, beta, r, g);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    an[k] = fmaf(r, fo[k], an[k]);
    ad[k] = fmaf(g, fo[k], ad[k]);
  }
}

// One block owns TM rows of RB restarts; each thread TR rows of one restart.
// Thread tid is restart rb = tid % RB of row group g = tid / RB, whose rows
// are g.TR + i where the X tile keeps its rows contiguous (kT: X's unit
// stride runs along the rows), else g + kGroups.i. A slot of the ring holds
// the X tile of one 16-entry chunk, [chunk][TM] (kT) or [TM][chunk + 4],
// then each restart's Fo chunk [chunk][K], 4 floats apart: the paddings put
// the reads of neighbouring row groups and restarts on other banks.
template <int K_, int TM, int RB, int TR, int MINB, int HW_IS, int HW_POW,
          bool kT>
struct BetaTile {
  static constexpr int K = K_;
  static constexpr int kTM = TM, kRB = RB, kTR = TR, kMinBlocks = MINB;
  static constexpr int kHalfWavesIS = HW_IS, kHalfWavesPow = HW_POW;
  static constexpr int kChunk = 16, kStages = 3;
  static constexpr int kGroups = kTM / TR;
  static constexpr int kThreads = kGroups * RB;
  static constexpr int kXPitch = kT ? kTM : kChunk + 4;
  static constexpr int kXFloats = kT ? kChunk * kTM : kTM * kXPitch;
  static constexpr int kFPitch = kChunk * K + 4;
  static constexpr int kSlotFloats = kXFloats + RB * kFPitch;
  static_assert(K % 8 == 0 && kTM % TR == 0 && kTM % 16 == 0, "tiling");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(kStages * kSlotFloats * 4 <= 48 * 1024, "static shared memory");
};

// The tiling of each bucket, for both layouts of X: rows a block owns,
// restarts, rows per thread, and the blocks an SM must hold at once, which
// caps a thread's registers at 65536 / (threads x blocks). A thread holds
// about 3.TR.K + K + TR live floats (F's rows, both accumulator sets, the
// staged Fo row, X): 128 threads and 4 blocks an SM leave it 128 registers.
// Then the grid the kernel needs, in half waves of the blocks the card
// holds at once, at beta = 0 and at other betas: a block owns 2-4 times a
// one-row block's (row, restart) pairs, so on a small grid the one-row
// kernel fills SMs this one leaves idle. On an H100, against the one-row
// kernel: K=8 beta=0 at 0.3 waves 0.88-0.94x, at 0.57 1.01x; K=8 beta=1.5
// at 0.57 and 1.06 waves 0.84-0.86x, at 1.52 and 2.04 1.05x and 1.01x;
// K=16 at 0.6 waves 1.10-1.30x at both betas.
template <int K, bool kT>
struct BetaCfg;
#define BETA_TILED_CFG(KK, TM, RB, TR, MINB, HW_IS, HW_POW) \
  template <bool kT>                                        \
  struct BetaCfg<KK, kT>                                    \
      : BetaTile<KK, TM, RB, TR, MINB, HW_IS, HW_POW, kT> {};
BETA_TILED_CFG(8, 64, 4, 2, 4, 1, 3)
BETA_TILED_CFG(16, 32, 4, 1, 4, 1, 1)
#undef BETA_TILED_CFG
#define BETA_TILED_BUCKETS(X) X(8) X(16)

// grid (restart groups, row tiles); X element (m, c) at X[m * sxm + c * sxc]
// with sxc = 1 or, for kT, sxm = 1. F (B, M, K) owns the rows, Fo (B, C, K)
// is contracted over. num and den (B, M, K).
template <int K, bool IS, bool kT>
__global__ void __launch_bounds__(BetaCfg<K, kT>::kThreads,
                                  BetaCfg<K, kT>::kMinBlocks)
beta_terms_tiled_kernel(const float* __restrict__ X, int M, int C,
                        long long sxm, long long sxc,
                        const float* __restrict__ Fo,
                        const float* __restrict__ F, int B, float beta,
                        float* __restrict__ num, float* __restrict__ den) {
  using T = BetaCfg<K, kT>;
  constexpr int TM = T::kTM, CH = T::kChunk, S = T::kStages, NT = T::kThreads;
  constexpr int RB = T::kRB, TR = T::kTR, NG = T::kGroups;
  __shared__ __align__(16) float smem[S * T::kSlotFloats];

  const int tid = threadIdx.x, rb = tid % RB, g = tid / RB;
  const int b0 = blockIdx.x * RB, m0 = blockIdx.y * TM;
  const int nb = min(RB, B - b0);  // the block's live restarts

  // Chunk q of the contraction into ring slot `slot`: X's tile along its
  // unit stride, and the RB Fo chunks, each CH.K contiguous floats; zero
  // past M, C and B. Copy unit j of a thread is unit tid + j * NT of the
  // tile, so every address is the thread's first one plus a step fixed for
  // the launch: the addresses are worked out once here, and a chunk only
  // moves them on. X's tile moves in 16-byte units where X's pitch is a
  // multiple of 4 floats and X is 16-byte aligned (vec); else each entry is
  // a 4-byte copy.
  constexpr int XOUT = kT ? CH : TM;          // tile rows ...
  constexpr int XU = (kT ? TM : CH) / 4;      // ... of XU 16-byte units
  constexpr int XSTEP = NT / XU;              // rows between a thread's units
  constexpr int XN = (XOUT * XU + NT - 1) / NT;  // units per thread
  constexpr int FU = CH * K / 4;              // Fo: units per restart
  constexpr int FSTEP = NT / FU;              // restarts between its units
  constexpr int FN = RB / FSTEP;              // units per thread
  static_assert(NT % XU == 0 && NT % FU == 0 && RB % FSTEP == 0, "copy units");
  const long long xpitch = kT ? sxc : sxm;    // X's stride between tile rows
  const bool vec =
      xpitch % 4 == 0 && reinterpret_cast<unsigned long long>(X) % 16 == 0;
  const int xo = tid / XU, xi = tid % XU * 4;  // the thread's first X unit
  const float* const x0 =
      X + (kT ? m0 + xi + xo * xpitch : (m0 + xo) * xpitch + xi);
  const long long xjump = XSTEP * xpitch, xchunk = kT ? CH * sxc : CH;
  // live entries of a unit along the rows of the block (kT's units run
  // along them; otherwise the tile rows are its rows)
  const int xlive = kT ? min(max(M - m0 - xi, 0), 4) : M - m0;
  const int frb = tid / FU, fw = tid % FU * 4;  // the thread's first Fo unit
  const int fc = fw / K;                        // its contraction entry
  const long long fjump = (long long)FSTEP * C * K;
  const float* const f0 = Fo + (long long)(b0 + frb) * C * K + fw;
  auto stage = [&](int slot, int q) {
    float* const xs = smem + slot * T::kSlotFloats;
    float* const fs = xs + T::kXFloats;
    const int rem = C - q * CH;  // contraction entries from this chunk on
    if (vec) {
      const float* const xq = x0 + q * xchunk;
#pragma unroll
      for (int j = 0; j < XN; ++j) {
        const int o = xo + j * XSTEP;
        if (XOUT * XU % NT != 0 && o >= XOUT) break;
        const int n = kT ? (o < rem ? xlive : 0)
                         : (o < xlive ? min(max(rem - xi, 0), 4) : 0);
        cnmf::cp_async16(xs + o * T::kXPitch + xi, n > 0 ? xq + j * xjump : X,
                         4 * n);
      }
    } else if constexpr (kT) {
      cnmf::stage_tile_async4<CH, TM, TM, NT>(
          xs, X + (C - rem) * sxc + m0, sxc, rem, M - m0);
    } else {
      cnmf::stage_tile_async4<TM, CH, T::kXPitch, NT>(
          xs, X + m0 * sxm + (C - rem), sxm, M - m0, rem);
    }
    const float* const fq = f0 + (long long)q * CH * K;
    const bool cok = fc < rem;
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int rb = frb + j * FSTEP;
      const bool ok = cok && rb < nb;
      cnmf::cp_async16(fs + rb * T::kFPitch + fw, ok ? fq + j * fjump : Fo,
                       ok ? 16 : 0);
    }
  };

  const int nq = (C + CH - 1) / CH;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nq) stage(s, s);
    cnmf::cp_async_commit();
  }

  // The thread's rows of F and its accumulators, while the first chunks
  // are in flight; rows past M and a restart past B hold 0.
  const bool live_b = rb < nb;
  float f[TR][K], an[TR][K], ad[TR][K];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int m = m0 + (kT ? g * TR + i : g + NG * i);
    const float* const src = F + ((long long)(b0 + rb) * M + m) * K;
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      if (live_b && m < M) {
        ld4(&f[i][k], src + k);
      } else {
        f[i][k] = f[i][k + 1] = f[i][k + 2] = f[i][k + 3] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) an[i][k + u] = ad[i][k + u] = 0.f;
    }
  }

  // Chunk q + S - 1 is in flight while chunk q is consumed, c ascending.
  for (int q = 0; q < nq; ++q) {
    cnmf::cp_async_wait<S - 2>();
    __syncthreads();  // chunk q has landed, and slot (q - 1) % S is consumed
    if (q + S - 1 < nq) stage((q + S - 1) % S, q + S - 1);
    cnmf::cp_async_commit();
    const float* const xs = smem + (q % S) * T::kSlotFloats;
    const float* const fs = xs + T::kXFloats + rb * T::kFPitch;
    // four entries a trip, their shared-memory offsets fixed in the body
#pragma unroll 1
    for (int c4 = 0; c4 < CH; c4 += 4) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = c4 + cc;
        float x[TR], fo[K];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          x[i] = kT ? xs[c * TM + g * TR + i]
                    : xs[(g + NG * i) * T::kXPitch + c];
#pragma unroll
        for (int k = 0; k < K; k += 4) ld4(fo + k, fs + c * K + k);
#pragma unroll
        for (int i = 0; i < TR; ++i)
          beta_step<K, IS>(f[i], an[i], ad[i], x[i], fo, beta);
      }
    }
  }
  cnmf::cp_async_wait<0>();

  if (!live_b) return;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int m = m0 + (kT ? g * TR + i : g + NG * i);
    if (m >= M) continue;
    const long long off = ((long long)(b0 + rb) * M + m) * K;
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      *reinterpret_cast<float4*>(num + off + k) =
          make_float4(an[i][k], an[i][k + 1], an[i][k + 2], an[i][k + 3]);
      *reinterpret_cast<float4*>(den + off + k) =
          make_float4(ad[i][k], ad[i][k + 1], ad[i][k + 2], ad[i][k + 3]);
    }
  }
}

// ---- one row per thread, optionally one slice of the contraction ----

// grid (B, tiles, S); X element (m, c) at X[m * sxm + c * sxc]; F (B, M, K)
// owns the rows, Fo (B, C, K) is contracted over. kSplit: block z sums the
// entries [z . per_split, min(C, (z + 1) . per_split)) (per_split a multiple
// of kChunk) into slice z of num and den, (S, B, M, K); else every entry
// into num and den, (B, M, K).
template <int K, bool IS, bool kSplit>
__global__ void __launch_bounds__(kThreads)
beta_terms_kernel(const float* __restrict__ X, int M, int C, long long sxm,
                  long long sxc, const float* __restrict__ Fo,
                  const float* __restrict__ F, float beta, int per_split,
                  float* __restrict__ num, float* __restrict__ den) {
  __shared__ float xs[kChunk][kThreads + 1];
  __shared__ __align__(16) float fs[kChunk][K];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kThreads;
  const int c_begin = kSplit ? blockIdx.z * per_split : 0;
  const int c_end = kSplit ? min(C, c_begin + per_split) : C;
  const float* fo = Fo + (size_t)b * C * K;
  const size_t off = (size_t)b * M * K;
  const size_t out_off =
      kSplit ? ((size_t)blockIdx.z * gridDim.x + b) * M * K : off;

  float f[1][K], an[1][K], ad[1][K];
  cnmf::load_rows<K, 1>(f, F + off, m0, M);
#pragma unroll
  for (int k = 0; k < K; ++k) an[0][k] = ad[0][k] = 0.f;

  for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    cnmf::stage_chunk<K, kThreads, kChunk>(xs, fs, X, M, c_end, sxm, sxc, fo,
                                           m0, c0);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kChunk; ++c) {
      float wh = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) wh = fmaf(f[0][k], fs[c][k], wh);
      float r, g;
      beta_terms<IS>(xs[c][threadIdx.x], wh, beta, r, g);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        an[0][k] = fmaf(r, fs[c][k], an[0][k]);
        ad[0][k] = fmaf(g, fs[c][k], ad[0][k]);
      }
    }
  }
  cnmf::store_rows<K, 1>(num + out_off, an, m0, M);
  cnmf::store_rows<K, 1>(den + out_off, ad, m0, M);
}

// beta_terms_kernel for K above the register buckets.
template <bool IS>
__global__ void __launch_bounds__(kThreads)
beta_terms_wide(const float* __restrict__ X, int M, int C, long long sxm,
                long long sxc, const float* __restrict__ Fo,
                const float* __restrict__ F, int K, float beta,
                float* __restrict__ num, float* __restrict__ den) {
  __shared__ float xs[kChunk][kThreads + 1];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kThreads;
  const int row = m0 + threadIdx.x;
  const bool live = row < M;
  const float* fo = Fo + (size_t)b * C * K;
  const size_t off = ((size_t)b * M + row) * K;
  const float* f = F + off;
  float* an = num + off;
  float* ad = den + off;
  if (live)
    for (int k = 0; k < K; ++k) an[k] = ad[k] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();
    cnmf::stage_x<kThreads, kChunk>(xs, X, M, C, sxm, sxc, m0, c0);
    __syncthreads();
    if (!live) continue;
    const int nc = min(kChunk, C - c0);
    float wh[kChunk], r[kChunk], g[kChunk];
    cnmf::wide_dots<kChunk>(wh, f, fo + (size_t)c0 * K, K, nc);
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      beta_terms<IS>(xs[c][threadIdx.x], wh[c], beta, r[c], g[c]);
    cnmf::wide_accumulate<kChunk>(an, r, fo + (size_t)c0 * K, K, nc);
    cnmf::wide_accumulate<kChunk>(ad, g, fo + (size_t)c0 * K, K, nc);
  }
}

// Whether the restart-tiled kernel's grid over B restarts of M rows fills
// the card as its tiling asks (BetaCfg's half waves).
template <int K, bool IS, bool kT>
bool tiled_fills(int B, int M) {
  using T = BetaCfg<K, kT>;
  static const int per_sm =
      cnmf::blocks_per_sm(beta_terms_tiled_kernel<K, IS, kT>, T::kThreads);
  const long long blocks = (long long)((B + T::kRB - 1) / T::kRB) *
                           ((M + T::kTM - 1) / T::kTM);
  const int half_waves = IS ? T::kHalfWavesIS : T::kHalfWavesPow;
  return B >= T::kRB &&
         2 * blocks >= (long long)half_waves * per_sm * cnmf::sm_count();
}

// The unsplit launch's kernel at a bucket of the restart-tiled one: 1 the
// restart-tiled one with X read along its unit stride by rows (sxc = 1), 2
// the restart-tiled one with X's unit stride along the rows (sxm = 1), 0 one
// row per thread (B below a block's restarts, a grid that does not fill the
// card, or X without a unit stride).
template <int K, bool IS>
int tiled_layout(int B, int M, long long sxm, long long sxc) {
  if (sxc == 1) return tiled_fills<K, IS, false>(B, M) ? 1 : 0;
  if (sxm == 1) return tiled_fills<K, IS, true>(B, M) ? 2 : 0;
  return 0;
}

template <int K, bool IS, bool kT>
int launch_tiled(const float* X, int M, int C, long long sxm, long long sxc,
                 const float* Fo, const float* F, int B, float beta,
                 float* num, float* den, cudaStream_t stream) {
  using T = BetaCfg<K, kT>;
  const dim3 grid((B + T::kRB - 1) / T::kRB, (M + T::kTM - 1) / T::kTM);
  beta_terms_tiled_kernel<K, IS, kT><<<grid, T::kThreads, 0, stream>>>(
      X, M, C, sxm, sxc, Fo, F, B, beta, num, den);
  return (int)cudaGetLastError();
}

// The one-row kernel over `splits` slices of per_split entries into num and
// den, (splits, B, M, K); the wide variant (splits = 1 only) above the
// register buckets.
template <bool IS>
int launch_one_row(const float* X, int M, int C, long long sxm, long long sxc,
                   const float* Fo, const float* F, int B, int K, float beta,
                   int splits, int per_split, float* num, float* den,
                   cudaStream_t stream) {
  const dim3 grid(B, (M + kThreads - 1) / kThreads, splits);
#define BETA_CASE(KK)                                                     \
  case KK:                                                                \
    if (splits > 1)                                                       \
      beta_terms_kernel<KK, IS, true><<<grid, kThreads, 0, stream>>>(     \
          X, M, C, sxm, sxc, Fo, F, beta, per_split, num, den);           \
    else                                                                  \
      beta_terms_kernel<KK, IS, false><<<grid, kThreads, 0, stream>>>(    \
          X, M, C, sxm, sxc, Fo, F, beta, per_split, num, den);           \
    return (int)cudaGetLastError();
  switch (K) { CNMF_K_BUCKETS(BETA_CASE) }
#undef BETA_CASE
  if (splits != 1 || !cnmf::is_wide_k(K)) return (int)cudaErrorInvalidValue;
  beta_terms_wide<IS><<<dim3(B, grid.y), kThreads, 0, stream>>>(
      X, M, C, sxm, sxc, Fo, F, K, beta, num, den);
  return (int)cudaGetLastError();
}

template <bool IS>
int launch(const float* X, int M, int C, long long sxm, long long sxc,
           const float* Fo, const float* F, int B, int K, float beta,
           float* num, float* den, cudaStream_t stream) {
#define BETA_TILED_CASE(KK)                                                \
  case KK:                                                                 \
    switch (tiled_layout<KK, IS>(B, M, sxm, sxc)) {                        \
      case 1:                                                              \
        return launch_tiled<KK, IS, false>(X, M, C, sxm, sxc, Fo, F, B,    \
                                           beta, num, den, stream);        \
      case 2:                                                              \
        return launch_tiled<KK, IS, true>(X, M, C, sxm, sxc, Fo, F, B,     \
                                          beta, num, den, stream);         \
    }                                                                      \
    break;
  switch (K) { BETA_TILED_BUCKETS(BETA_TILED_CASE) }
#undef BETA_TILED_CASE
  return launch_one_row<IS>(X, M, C, sxm, sxc, Fo, F, B, K, beta, 1, C, num,
                            den, stream);
}

template <int K, bool IS, bool kT>
int tiled_field(int field) {
  using T = BetaCfg<K, kT>;
  switch (field) {
    case 0:
      return T::kTM;
    case 1:
      return T::kRB;
    case 2:
      return T::kThreads;
    case 3:
      return cnmf::blocks_per_sm(beta_terms_tiled_kernel<K, IS, kT>,
                                 T::kThreads);
  }
  return 0;
}

template <bool IS>
int tiling(int K, int B, int M, long long sxm, long long sxc, int field) {
#define BETA_TILING_CASE(KK)                                      \
  case KK:                                                        \
    switch (tiled_layout<KK, IS>(B, M, sxm, sxc)) {               \
      case 1:                                                     \
        return tiled_field<KK, IS, false>(field);                 \
      case 2:                                                     \
        return tiled_field<KK, IS, true>(field);                  \
    }                                                             \
    break;
  switch (K) { BETA_TILED_BUCKETS(BETA_TILING_CASE) }
#undef BETA_TILING_CASE
  if (field == 0 || field == 2) return kThreads;
  if (field == 1) return 1;
  if (field == 4) return K <= cnmf::kRegMaxK ? kChunk : 0;
  if (field != 3) return 0;
#define BETA_OCC_CASE(KK) \
  case KK:                \
    return cnmf::blocks_per_sm(beta_terms_kernel<KK, IS, true>, kThreads);
  switch (K) { CNMF_K_BUCKETS(BETA_OCC_CASE) }
#undef BETA_OCC_CASE
  return cnmf::is_wide_k(K) ? cnmf::blocks_per_sm(beta_terms_wide<IS>, kThreads)
                            : 0;
}

}  // namespace

extern "C" {

// num (B, M, K) = sum_c X(m, c) . f(wh) . F_other[c] and den (B, M, K) =
// sum_c g(wh) . F_other[c], wh = F[m] . F_other[c], X(m, c) = X[m * sxm +
// c * sxc]; F (B, M, K), F_other (B, C, K); beta not in {1, 2}. The
// contraction is not split: the tiled kernel or one row per thread.
int mu_beta_terms(const float* X, int M, int C, long long sxm, long long sxc,
                  const float* F_other, const float* F, int B, int K,
                  float beta, float* num, float* den, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (beta == 1.f || beta == 2.f) return (int)cudaErrorInvalidValue;
  if (beta == 0.f)
    return launch<true>(X, M, C, sxm, sxc, F_other, F, B, K, beta, num, den,
                        s);
  return launch<false>(X, M, C, sxm, sxc, F_other, F, B, K, beta, num, den, s);
}

// mu_beta_terms with the contraction split into `splits` >= 2 slices of
// per_split entries (a multiple of 32; the last slice takes the rest), one
// row per thread, K a register bucket (8..64). The slices' partials go to
// `work` (2 x splits x B x M x K floats), then are summed in slice order
// into num and den; both launches go on `stream`.
int mu_beta_terms_split(const float* X, int M, int C, long long sxm,
                        long long sxc, const float* F_other, const float* F,
                        int B, int K, float beta, int splits, int per_split,
                        float* work, float* num, float* den, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (beta == 1.f || beta == 2.f || K > cnmf::kRegMaxK || splits < 2 ||
      per_split <= 0 || per_split % kChunk != 0 ||
      (long long)(splits - 1) * per_split >= C ||
      (long long)splits * per_split < C)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * M * K;
  float* const wn = work;
  float* const wd = work + splits * n;
  const int rc =
      beta == 0.f
          ? launch_one_row<true>(X, M, C, sxm, sxc, F_other, F, B, K, beta,
                                 splits, per_split, wn, wd, s)
          : launch_one_row<false>(X, M, C, sxm, sxc, F_other, F, B, K, beta,
                                  splits, per_split, wn, wd, s);
  if (rc != 0) return rc;
  const long long n4 = n / 4;
  const dim3 grid((unsigned)((n4 + kThreads - 1) / kThreads), 2);
  cnmf::split_sum_kernel<2><<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(work), splits, n4,
      reinterpret_cast<float4*>(num), reinterpret_cast<float4*>(den));
  return (int)cudaGetLastError();
}

// The tiling mu_beta_terms takes for a launch at K, B restarts of M rows,
// X's strides and beta: field 0 the rows a block owns, 1 the restarts it
// owns, 2 its threads, 3 how many of its blocks an SM holds at once (of the
// one-row kernel: its split build's), 4 the entries each slice of a split
// contraction holds a whole number of (0: the kernel does not split).
// mu_beta_terms_split runs the one-row kernel, whose tiling is that of B =
// 1. 0 for a K that has no kernel, or a field that does not exist or cannot
// be read.
int mu_beta_terms_tiling(int K, int B, int M, long long sxm, long long sxc,
                         float beta, int field) {
  return beta == 0.f ? tiling<true>(K, B, M, sxm, sxc, field)
                     : tiling<false>(K, B, M, sxm, sxc, field);
}

}  // extern "C"
