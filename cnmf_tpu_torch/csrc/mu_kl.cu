// Fused KL multiplicative-update terms for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernels of cnmf_tpu/ops/pallas_mu.py:
//   kl_mu_w_numerator (:89, body _kl_w_terms_kernel :59)        -> mu_kl_numerator, W side
//   kl_mu_h_numerator (:394, body _make_kl_h_terms_kernel :128) -> mu_kl_numerator, H side
//   kl_x_log_wh (:357, body _make_kl_xlogwh_kernel :327)        -> mu_kl_x_log_wh
// The two general-beta kernels of that file (beta_mu_w_terms,
// beta_mu_h_terms) are in mu_beta.cu, on the one-row-per-thread design below.
//
// All three contract the reconstruction WH = W . Ht^T (N x G per restart)
// against X without ever writing it to memory. For a factor F whose rows
// index the output and the other factor Fo, contracted over, each (row m,
// restart b) pair computes, for each contraction entry c in ascending order,
//   wh    = F[m] . Fo[c]                      (K FMAs, k ascending from 0)
//   ratio = X(m, c) / max(wh, eps)            (0 where X(m, c) is 0)
//   acc  += ratio * Fo[c]                     (K FMAs)
// so num[m] = sum_c X(m, c) / max(wh, eps) . Fo[c]. With F = W, Fo = Ht and X
// read by rows this is (X / max(WH, eps)) . H^T; with F = Ht, Fo = W and X
// read transposed it is W^T . (X / max(WH, eps)) in the Ht layout. X's strides
// are arguments, so the same kernels also read a transposed view of X (the
// consensus spectra refit of X^T) without a copy. The divergence term sums
// X(m, c) . log(max(wh, eps)) over X > eps instead of accumulating; each
// thread sums in double, the block reduces to one partial per (tile,
// restart), and the partials are summed outside: no atomics, the same bits
// every run.
//
// Numerics: full IEEE f32 products, division and logf (no fast-math, no TF32,
// no tensor cores): the Pallas kernels run these products at HIGHEST precision
// (pallas_mu.py:45-56), where bf16-level products drifted the factors 3.2e-3,
// outside the 1e-4 contract. eps is the float32 machine epsilon
// (pallas_mu.py:42).
//
// What bounds it on an H100: instruction throughput of the f32 pipe. Per
// element and restart a numerator spends 2K FMAs plus one IEEE division
// (about ten instructions; skipped where X is 0, which would take the
// division's slow path); at the PBMC-3k factorize shape (B=100, N=2700,
// G=2000, K=16) that is 4.N.G.K.B = 34.6 GFLOP per launch against 67 TFLOP/s
// of f32 FMA.
//
// Two designs:
// - The restart-tiled numerator (kl_numerator_tiled_kernel), for the
//   buckets the KL factorize runs (K = 8 and 16) when X has a unit stride
//   and B fills a block's restarts. One block owns 64 rows of RB restarts:
//   each X chunk is staged once for all RB restarts (a block of one restart
//   would stream X from L2 B times a launch: 2.16 GB against 21.6 MB at
//   B=100), with the RB restarts' Fo chunks beside it, through a 3-slot
//   cp.async ring whose copy addresses each thread works out once. Each
//   thread owns TR rows of one restart, their rows of F and accumulators in
//   registers, so it has TR independent dot-division-accumulate chains and
//   reads each staged Fo row once for TR rows; the block's RB restarts read
//   each staged X value from shared memory. Every sum runs in the order
//   above, so the output has the same bits as the one-row kernel's.
// - One row per thread of one restart (kl_numerator_kernel, 128 rows a
//   block): the other buckets, B below a block's restarts (the B = 1
//   consensus refits), and an X without a unit stride. The other factor's
//   chunk is read from shared memory as a broadcast; X is re-read by every
//   (tile, restart) block, the restart index fastest in the grid so that
//   co-resident blocks share an X tile in the 50 MB L2. At K = 56 and 64 the
//   compiler, caching the staged row as well, spills 24-28 bytes.
//
// The divergence term has three designs of its own:
// - The restart-tiled one (kl_x_log_wh_tiled_kernel), for the KL
//   factorize's buckets (K = 8 and 16) when X is read along its unit stride
//   and the grid fills the card: the numerator's ring and staging, with no
//   accumulators, so a block holds 32 restarts, one a lane. A warp's lanes
//   are then restarts of the same rows and see the same X(m, c): one ballot
//   a chunk gives two rows' masks of the entries with X > eps, the same in
//   every lane, and the warp walks each row's mask two entries at a time,
//   two independent dot and logf chains, with no divergence. Entries with
//   X <= eps cost nothing (the normalized counts are 27 % > eps at PBMC-3k
//   scale); a branch per entry instead would serialize those chains.
// - One row per thread (kl_x_log_wh_kernel), as the numerator's, for every
//   other launch; where its grid is under 2 waves (the B = 1 consensus
//   refits: 22 or 79 blocks for 132 SMs) the launch splits the contraction
//   into slices of whole 32-entry chunks, one per blockIdx.z, each writing
//   its own partials (ops/mu_kernels.split_plan).
// - The wide variant above the register buckets, never split.
// Every (row, restart) pair adds its terms in ascending c, in a double, in
// all three; only the grouping of those doubles into the partials differs.
// Its bound is the f32 pipe too, counted where X > eps only: 2K + 2
// operations a pair (the dot, the logf and the product).
//
// Padded rows, contraction entries and K columns are exact no-ops: rows past
// M and entries past C load as 0 (ratio 0), and a zero K column of Fo adds
// nothing to wh and receives 0.
//
// K buckets 8..64 hold the row in registers; any larger multiple of 8 runs a
// wide variant (common.cuh) with the row read from F and the accumulators in
// the output buffer, the same sums in the same order.

#include <atomic>

#include "common.cuh"

namespace {

using cnmf::kThreads;
using cnmf::ld4;
constexpr int kChunk = 32;  // contraction entries staged per shared-memory round
constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon

// ---- the restart-tiled numerator of the KL factorize's buckets ----

// One contraction entry of one (row, restart) pair: the dot with k ascending
// from 0, the ratio, then one fmaf into each accumulator.
template <int K>
__device__ __forceinline__ void kl_step(const float (&f)[K], float (&acc)[K],
                                        float x, const float (&fo)[K]) {
  float wh = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) wh = fmaf(f[k], fo[k], wh);
  // 0 / wh is 0; a zero numerator would send the IEEE division down its
  // slow path, and normalized counts are mostly zeros
  const float ratio = x == 0.f ? 0.f : x / fmaxf(wh, kEps);
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = fmaf(ratio, fo[k], acc[k]);
}

// One block owns kTM = 64 rows of RB restarts; each thread TR rows of one
// restart. Thread tid is restart rb = tid % RB of row group g = tid / RB,
// whose rows are g.TR + i where the X tile keeps its rows contiguous (kT:
// X's unit stride runs along the rows), else g + kGroups.i. A slot of the
// ring holds the X tile of one 16-entry chunk, [chunk][kTM] (kT) or
// [kTM][chunk + 4], then each restart's Fo chunk [chunk][K], 4 floats
// apart: the paddings put the reads of neighbouring row groups and
// restarts on other banks.
template <int K_, int RB, int TR, int MINB, bool kT>
struct KlTile {
  static constexpr int K = K_;
  static constexpr int kRB = RB, kTR = TR, kMinBlocks = MINB;
  static constexpr int kTM = 64, kChunk = 16, kStages = 3;
  static constexpr int kGroups = kTM / TR;
  static constexpr int kThreads = kGroups * RB;
  static constexpr int kXPitch = kT ? kTM : kChunk + 4;
  static constexpr int kXFloats = kT ? kChunk * kTM : kTM * kXPitch;
  static constexpr int kFPitch = kChunk * K + 4;
  static constexpr int kSlotFloats = kXFloats + RB * kFPitch;
  static_assert(K % 8 == 0 && kTM % TR == 0, "tiling");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(kStages * kSlotFloats * 4 <= 48 * 1024, "static shared memory");
};

// The tiling of each bucket, for both layouts of X: restarts per block, rows
// per thread, and the blocks an SM must hold at once, which caps a thread's
// registers at 65536 / (threads x blocks). Left to itself the compiler
// keeps staged values of several entries in flight and takes all 255, and 4
// blocks of 2 warps an SM are too few to hide the division chains'
// latency. Of the tilings timed on an H100 at B=100, N=2700, G=2000, 128
// threads with 4 rows (K=8) or 2 rows (K=16) each and 4 blocks an SM were
// fastest at both buckets and both layouts.
template <int K, bool kT>
struct KlCfg;
#define KL_TILED_CFG(KK, RB, TR, MINB) \
  template <bool kT>                   \
  struct KlCfg<KK, kT> : KlTile<KK, RB, TR, MINB, kT> {};
KL_TILED_CFG(8, 8, 4, 4)
KL_TILED_CFG(16, 4, 2, 4)
#undef KL_TILED_CFG
#define KL_TILED_BUCKETS(X) X(8) X(16)

// grid (restart groups, row tiles); X element (m, c) at X[m * sxm + c * sxc]
// with sxc = 1 or, for kT, sxm = 1. F (B, M, K) owns the rows, Fo (B, C, K)
// is contracted over. out (B, M, K).
template <int K, bool kT>
__global__ void __launch_bounds__(KlCfg<K, kT>::kThreads,
                                  KlCfg<K, kT>::kMinBlocks)
kl_numerator_tiled_kernel(const float* __restrict__ X, int M, int C,
                          long long sxm, long long sxc,
                          const float* __restrict__ Fo,
                          const float* __restrict__ F, int B,
                          float* __restrict__ out) {
  using T = KlCfg<K, kT>;
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
  float f[TR][K], acc[TR][K];
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
      acc[i][k] = acc[i][k + 1] = acc[i][k + 2] = acc[i][k + 3] = 0.f;
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
        for (int i = 0; i < TR; ++i) kl_step<K>(f[i], acc[i], x[i], fo);
      }
    }
  }
  cnmf::cp_async_wait<0>();

  if (!live_b) return;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int m = m0 + (kT ? g * TR + i : g + NG * i);
    if (m >= M) continue;
    float* const dst = out + ((long long)(b0 + rb) * M + m) * K;
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<float4*>(dst + k) =
          make_float4(acc[i][k], acc[i][k + 1], acc[i][k + 2], acc[i][k + 3]);
  }
}

// ---- the restart-tiled divergence term of the KL factorize's buckets ----

// One block owns TM rows of RB restarts, X read along its unit stride by
// rows; thread tid is restart rb = tid % RB of row group g = tid / RB, whose
// TR rows are g + kGroups.i. A slot of the ring holds the X tile of one
// 16-entry chunk, [TM][chunk + 4], then each restart's Fo chunk [chunk][K],
// 4 floats apart; after the loop the ring holds the threads' partials.
template <int K_, int TM, int RB, int TR, int MINB, int HALF_WAVES>
struct XlwTile {
  static constexpr int K = K_;
  static constexpr int kTM = TM, kRB = RB, kTR = TR, kMinBlocks = MINB;
  static constexpr int kHalfWaves = HALF_WAVES;
  static constexpr int kChunk = 16, kStages = 3;
  static constexpr int kGroups = TM / TR;
  static constexpr int kThreads = kGroups * RB;
  static constexpr int kXPitch = kChunk + 4;
  static constexpr int kXFloats = TM * kXPitch;
  static constexpr int kFPitch = kChunk * K + 4;
  static constexpr int kSlotFloats = kXFloats + RB * kFPitch;
  static constexpr int kSmemBytes = kStages * kSlotFloats * 4;
  static_assert(K % 8 == 0 && TM % TR == 0, "tiling");
  static_assert(RB == 32, "a restart a lane: a warp's lanes share its rows");
  static_assert(TR % 2 == 0 && kChunk == 16, "two rows' entries a ballot");
  static_assert(kThreads * 8 <= kSmemBytes, "the partials fit the ring");
};

// The tiling of each bucket: rows a block owns, restarts (32: one a lane,
// so a warp's X test is uniform), rows a thread, the blocks an SM must hold
// at once (which caps a thread's registers at 65536 / (threads x blocks):
// TR rows of F and TR doubles, two staged Fo rows, two logf chains), and
// the grid the kernel needs, in half waves of the blocks the card holds at
// once; smaller grids run the one-row kernel. The ring needs dynamic shared
// memory: 105 KB at K = 16, 57 KB at K = 8, so an SM holds two blocks. On
// an H100 at B=100, N=2700, G=2000 on the path's X, K=8 with 2 rows a
// thread and 512 threads (64 registers, 8 bytes spilled) beat 4 rows and
// 256 threads at 3 blocks an SM by 2 %; K=16 with 4 rows and 256 threads
// (128 registers, 4 bytes spilled) beat 2 rows and 512 threads at one
// block an SM by 7 %.
template <int K>
struct XlwCfg;
#define XLW_TILED_CFG(KK, TM, RB, TR, MINB, HALF_WAVES) \
  template <>                                            \
  struct XlwCfg<KK> : XlwTile<KK, TM, RB, TR, MINB, HALF_WAVES> {};
XLW_TILED_CFG(8, 32, 32, 2, 2, 1)
XLW_TILED_CFG(16, 32, 32, 4, 2, 1)
#undef XLW_TILED_CFG
#define XLW_TILED_BUCKETS(X) X(8) X(16)

// grid (restart groups, row tiles); X element (m, c) at X[m * sxm + c], F
// (B, M, K) owns the rows, Fo (B, C, K) is contracted over. part (tiles, B):
// per (row tile, restart) the sum over its rows of each row's terms, rows
// summed in a fixed order.
template <int K>
__global__ void __launch_bounds__(XlwCfg<K>::kThreads, XlwCfg<K>::kMinBlocks)
kl_x_log_wh_tiled_kernel(const float* __restrict__ X, int M, int C,
                         long long sxm, const float* __restrict__ Fo,
                         const float* __restrict__ F, int B,
                         double* __restrict__ part) {
  using T = XlwCfg<K>;
  constexpr int TM = T::kTM, CH = T::kChunk, S = T::kStages, NT = T::kThreads;
  constexpr int RB = T::kRB, TR = T::kTR, NG = T::kGroups;
  extern __shared__ __align__(16) float smem[];

  // the warp is row group g, its lane the restart rb
  const int tid = threadIdx.x, rb = tid % RB, g = tid / RB, lane = rb;
  const int b0 = blockIdx.x * RB, m0 = blockIdx.y * TM;
  const int nb = min(RB, B - b0);  // the block's live restarts

  // Chunk q of the contraction into ring slot `slot`, as the numerator's
  // tiled kernel stages it: the X tile in 16-byte units (4-byte copies where
  // X's pitch is not a multiple of 4 floats or X is not 16-byte aligned) and
  // the RB Fo chunks, each CH.K contiguous floats; zero past M, C and B. The
  // copy addresses are worked out once, a chunk only moves them on.
  constexpr int XU = CH / 4;                  // 16-byte units of a tile row
  constexpr int XSTEP = NT / XU;              // rows between a thread's units
  constexpr int XN = (TM * XU + NT - 1) / NT;  // units per thread
  constexpr int FU = CH * K / 4;              // Fo: units per restart
  constexpr int FSTEP = NT / FU;              // restarts between its units
  constexpr int FN = RB / FSTEP;              // units per thread
  static_assert(NT % XU == 0 && NT % FU == 0 && RB % FSTEP == 0, "copy units");
  const bool vec =
      sxm % 4 == 0 && reinterpret_cast<unsigned long long>(X) % 16 == 0;
  const int xo = tid / XU, xi = tid % XU * 4;  // the thread's first X unit
  const float* const x0 = X + (m0 + xo) * sxm + xi;
  const long long xjump = XSTEP * sxm;
  const int frb = tid / FU, fw = tid % FU * 4;  // the thread's first Fo unit
  const int fc = fw / K;                        // its contraction entry
  const long long fjump = (long long)FSTEP * C * K;
  const float* const f0 = Fo + (long long)(b0 + frb) * C * K + fw;
  auto stage = [&](int slot, int q) {
    float* const xs = smem + slot * T::kSlotFloats;
    float* const fs = xs + T::kXFloats;
    const int rem = C - q * CH;  // contraction entries from this chunk on
    if (vec) {
      const float* const xq = x0 + q * CH;
#pragma unroll
      for (int j = 0; j < XN; ++j) {
        const int o = xo + j * XSTEP;
        if (TM * XU % NT != 0 && o >= TM) break;
        const int n = o < M - m0 ? min(max(rem - xi, 0), 4) : 0;
        cnmf::cp_async16(xs + o * T::kXPitch + xi, n > 0 ? xq + j * xjump : X,
                         4 * n);
      }
    } else {
      cnmf::stage_tile_async4<TM, CH, T::kXPitch, NT>(
          xs, X + m0 * sxm + (C - rem), sxm, M - m0, rem);
    }
    const float* const fq = f0 + (long long)q * CH * K;
    const bool cok = fc < rem;
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int r = frb + j * FSTEP;
      const bool ok = cok && r < nb;
      cnmf::cp_async16(fs + r * T::kFPitch + fw, ok ? fq + j * fjump : Fo,
                       ok ? 16 : 0);
    }
  };

  const int nq = (C + CH - 1) / CH;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nq) stage(s, s);
    cnmf::cp_async_commit();
  }

  // The thread's rows of F and their sums, while the first chunks are in
  // flight; rows past M and a restart past B hold 0 (their X loads as 0, or
  // their sums are never stored).
  const bool live_b = rb < nb;
  float f[TR][K];
  double sum[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int m = m0 + g + NG * i;
    const float* const src = F + ((long long)(b0 + rb) * M + m) * K;
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      if (live_b && m < M) {
        ld4(&f[i][k], src + k);
      } else {
        f[i][k] = f[i][k + 1] = f[i][k + 2] = f[i][k + 3] = 0.f;
      }
    }
    sum[i] = 0.0;
  }

  // Chunk q + S - 1 is in flight while chunk q is consumed, c ascending.
  for (int q = 0; q < nq; ++q) {
    cnmf::cp_async_wait<S - 2>();
    __syncthreads();  // chunk q has landed, and slot (q - 1) % S is consumed
    if (q + S - 1 < nq) stage((q + S - 1) % S, q + S - 1);
    cnmf::cp_async_commit();
    const float* const xs = smem + (q % S) * T::kSlotFloats;
    const float* const fs = xs + T::kXFloats + rb * T::kFPitch;
    // The entries of the chunk each row of the warp needs (X > eps), two
    // rows a ballot: lane l tests entry l % 16 of row l / 16 of the pair.
    // Every lane of the warp sees the same X, so all get the same masks
    // and run the loops below alike.
    unsigned need[TR / 2];
#pragma unroll
    for (int p = 0; p < TR / 2; ++p)
      need[p] = __ballot_sync(
          0xffffffffu,
          xs[(g + NG * (2 * p + lane / CH)) * T::kXPitch + lane % CH] > kEps);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float* const xrow = xs + (g + NG * i) * T::kXPitch;
      unsigned m = need[i / 2] >> (i % 2 * CH) & 0xffffu;
      // two needed entries a trip, c ascending: two independent dot and
      // logf chains; an odd last entry is computed twice and added once
      // (adding 0.0 leaves a sum that starts at +0.0 as it is)
      while (m != 0) {
        const int c1 = __ffs(m) - 1;
        m &= m - 1;
        const bool two = m != 0;
        const int c2 = two ? __ffs(m) - 1 : c1;
        m &= m - 1;
        float fo1[K], fo2[K];
#pragma unroll
        for (int k = 0; k < K; k += 4) {
          ld4(fo1 + k, fs + c1 * K + k);
          ld4(fo2 + k, fs + c2 * K + k);
        }
        float w1 = 0.f, w2 = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          w1 = fmaf(f[i][k], fo1[k], w1);
          w2 = fmaf(f[i][k], fo2[k], w2);
        }
        const float t1 = xrow[c1] * logf(fmaxf(w1, kEps));
        const float t2 = xrow[c2] * logf(fmaxf(w2, kEps));
        sum[i] += (double)t1;
        sum[i] += two ? (double)t2 : 0.0;
      }
    }
  }
  cnmf::cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring

  // The thread's rows in order, then the row groups in order: no atomics.
  double* const red = reinterpret_cast<double*>(smem);
  double t = sum[0];
#pragma unroll
  for (int i = 1; i < TR; ++i) t += sum[i];
  red[tid] = t;
  __syncthreads();
  if (g != 0 || !live_b) return;
  for (int h = 1; h < NG; ++h) t += red[h * RB + rb];
  part[(long long)blockIdx.y * B + b0 + rb] = t;
}

// ---- one row per thread ----

// grid (B, tiles); X element (m, c) at X[m * sxm + c * sxc]; F (B, M, K) owns
// the rows, Fo (B, C, K) is contracted over. out (B, M, K).
template <int K>
__global__ void __launch_bounds__(kThreads)
kl_numerator_kernel(const float* __restrict__ X, int M, int C, long long sxm,
                    long long sxc, const float* __restrict__ Fo,
                    const float* __restrict__ F, float* __restrict__ out) {
  __shared__ float xs[kChunk][kThreads + 1];
  __shared__ __align__(16) float fs[kChunk][K];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kThreads;
  const float* fo = Fo + (size_t)b * C * K;
  const size_t off = (size_t)b * M * K;

  float f[1][K], acc[1][K];
  cnmf::load_rows<K, 1>(f, F + off, m0, M);
#pragma unroll
  for (int k = 0; k < K; ++k) acc[0][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    cnmf::stage_chunk<K, kThreads, kChunk>(xs, fs, X, M, C, sxm, sxc, fo, m0,
                                           c0);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kChunk; ++c) {
      float wh = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) wh = fmaf(f[0][k], fs[c][k], wh);
      // 0 / wh is 0; a zero numerator would send the IEEE division down its
      // slow path, and normalized counts are mostly zeros
      const float x = xs[c][threadIdx.x];
      const float ratio = x == 0.f ? 0.f : x / fmaxf(wh, kEps);
#pragma unroll
      for (int k = 0; k < K; ++k) acc[0][k] = fmaf(ratio, fs[c][k], acc[0][k]);
    }
  }
  cnmf::store_rows<K, 1>(out + off, acc, m0, M);
}

// The same loop without accumulators: part[z, tile, b] = sum over the
// tile's rows and every c of slice z with X(m, c) > eps of X(m, c) .
// log(max(wh, eps)). grid (B, tiles, S); kSplit: block z takes the entries
// [z . per_split, min(C, (z + 1) . per_split)) (per_split a multiple of
// kChunk), else every entry (S = 1).
template <int K, bool kSplit>
__global__ void __launch_bounds__(kThreads)
kl_x_log_wh_kernel(const float* __restrict__ X, int M, int C, long long sxm,
                   long long sxc, const float* __restrict__ Fo,
                   const float* __restrict__ F, int per_split,
                   double* __restrict__ part) {
  __shared__ float xs[kChunk][kThreads + 1];
  __shared__ __align__(16) float fs[kChunk][K];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kThreads;
  const int c_begin = kSplit ? blockIdx.z * per_split : 0;
  const int c_end = kSplit ? min(C, c_begin + per_split) : C;
  const float* fo = Fo + (size_t)b * C * K;

  float f[1][K];
  cnmf::load_rows<K, 1>(f, F + (size_t)b * M * K, m0, M);
  double sum = 0.0;
  for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
    __syncthreads();
    cnmf::stage_chunk<K, kThreads, kChunk>(xs, fs, X, M, c_end, sxm, sxc, fo,
                                           m0, c0);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kChunk; ++c) {
      float wh = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) wh = fmaf(f[0][k], fs[c][k], wh);
      const float x = xs[c][threadIdx.x];
      if (x > kEps) sum += (double)(x * logf(fmaxf(wh, kEps)));
    }
  }
  cnmf::block_sum_to(
      sum, part + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + b);
}

// kl_numerator_kernel for K above the register buckets.
__global__ void __launch_bounds__(kThreads)
kl_numerator_wide(const float* __restrict__ X, int M, int C, long long sxm,
                  long long sxc, const float* __restrict__ Fo,
                  const float* __restrict__ F, int K, float* __restrict__ out) {
  __shared__ float xs[kChunk][kThreads + 1];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kThreads;
  const int row = m0 + threadIdx.x;
  const bool live = row < M;
  const float* fo = Fo + (size_t)b * C * K;
  const float* f = F + ((size_t)b * M + row) * K;
  float* acc = out + ((size_t)b * M + row) * K;
  if (live)
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();
    cnmf::stage_x<kThreads, kChunk>(xs, X, M, C, sxm, sxc, m0, c0);
    __syncthreads();
    if (!live) continue;
    const int nc = min(kChunk, C - c0);
    float wh[kChunk], ratio[kChunk];
    cnmf::wide_dots<kChunk>(wh, f, fo + (size_t)c0 * K, K, nc);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float x = xs[c][threadIdx.x];
      ratio[c] = x == 0.f ? 0.f : x / fmaxf(wh[c], kEps);
    }
    cnmf::wide_accumulate<kChunk>(acc, ratio, fo + (size_t)c0 * K, K, nc);
  }
}

// kl_x_log_wh_kernel for K above the register buckets.
__global__ void __launch_bounds__(kThreads)
kl_x_log_wh_wide(const float* __restrict__ X, int M, int C, long long sxm,
                 long long sxc, const float* __restrict__ Fo,
                 const float* __restrict__ F, int K, double* __restrict__ part) {
  __shared__ float xs[kChunk][kThreads + 1];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kThreads;
  const int row = m0 + threadIdx.x;
  const bool live = row < M;
  const float* fo = Fo + (size_t)b * C * K;
  const float* f = F + ((size_t)b * M + row) * K;
  double sum = 0.0;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();
    cnmf::stage_x<kThreads, kChunk>(xs, X, M, C, sxm, sxc, m0, c0);
    __syncthreads();
    if (!live) continue;
    const int nc = min(kChunk, C - c0);
    float wh[kChunk];
    cnmf::wide_dots<kChunk>(wh, f, fo + (size_t)c0 * K, K, nc);
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float x = xs[c][threadIdx.x];
      if (c < nc && x > kEps) sum += (double)(x * logf(fmaxf(wh[c], kEps)));
    }
  }
  cnmf::block_sum_to(sum, part + (size_t)blockIdx.y * gridDim.x + b);
}

dim3 grid_of(int B, int M) { return dim3(B, (M + kThreads - 1) / kThreads); }

// The numerator kernel a launch at bucket K takes: 1 the restart-tiled one
// with X read along its unit stride by rows (sxc = 1), 2 the restart-tiled
// one with X's unit stride along the rows (sxm = 1), 0 one row per thread
// (another bucket, B below a block's restarts, or X without a unit stride).
int tiled_layout(int K, int B, long long sxm, long long sxc) {
  int rb = 0;
#define KL_RB(KK) \
  if (K == KK) rb = KlCfg<KK, false>::kRB;
  KL_TILED_BUCKETS(KL_RB)
#undef KL_RB
  if (rb == 0 || B < rb) return 0;
  return sxc == 1 ? 1 : sxm == 1 ? 2 : 0;
}

template <int K, bool kT>
int launch_tiled(const float* X, int M, int C, long long sxm, long long sxc,
                 const float* Fo, const float* F, int B, float* out,
                 cudaStream_t stream) {
  using T = KlCfg<K, kT>;
  const dim3 grid((B + T::kRB - 1) / T::kRB, (M + T::kTM - 1) / T::kTM);
  kl_numerator_tiled_kernel<K, kT><<<grid, T::kThreads, 0, stream>>>(
      X, M, C, sxm, sxc, Fo, F, B, out);
  return (int)cudaGetLastError();
}

// How many blocks of `threads` threads of `kernel`, with `smem` bytes of
// dynamic shared memory, an SM holds at once; 0 where that cannot be read.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, int smem = 0) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch to report
    return 0;
  }
  return n;
}

// The SMs of the current device; 0 where that cannot be read.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

template <int K, bool kT>
int tiled_field(int field) {
  using T = KlCfg<K, kT>;
  switch (field) {
    case 0:
      return T::kTM;
    case 1:
      return T::kRB;
    case 2:
      return T::kThreads;
    case 3:
      return blocks_per_sm(kl_numerator_tiled_kernel<K, kT>, T::kThreads);
  }
  return 0;
}

// Lifts the tiled divergence kernel's dynamic shared memory limit to its
// ring's need (above the default 48 KB), once per device; returns the CUDA
// error of that call, at every launch.
template <int K>
int xlw_prepare() {
  constexpr int kDevices = 64;
  static std::atomic<int> done[kDevices];  // 0: not yet set, else error + 1
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  int rc = done[dev].load(std::memory_order_acquire);
  if (rc == 0) {
    rc = 1 + (int)cudaFuncSetAttribute(
                 kl_x_log_wh_tiled_kernel<K>,
                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                 XlwCfg<K>::kSmemBytes);
    done[dev].store(rc, std::memory_order_release);
  }
  return rc - 1;
}

// The tiled divergence kernel's field 0 rows a block owns, 1 restarts, 2
// threads, 3 blocks an SM holds at once (0 where that cannot be read).
template <int K>
int xlw_tiled_field(int field) {
  using T = XlwCfg<K>;
  switch (field) {
    case 0:
      return T::kTM;
    case 1:
      return T::kRB;
    case 2:
      return T::kThreads;
    case 3:
      return xlw_prepare<K>() != 0
                 ? 0
                 : blocks_per_sm(kl_x_log_wh_tiled_kernel<K>, T::kThreads,
                                 T::kSmemBytes);
  }
  return 0;
}

// Whether an unsplit divergence launch at bucket K takes the tiled kernel:
// X read along its unit stride (sxc = 1), at least 3/4 of its lanes live
// restarts (a lane past B costs what a live one does: at B = 33, about
// half of them live, it took 1.19x the one-row kernel's time on an H100,
// at B = 97 and 100 0.5-0.7x), and its grid over B restarts of M rows
// fills the half waves of the card's blocks its tiling asks for.
template <int K>
bool xlw_tiled(int B, int M, long long sxc) {
  using T = XlwCfg<K>;
  static const int per_sm = xlw_tiled_field<K>(3);
  const int groups = (B + T::kRB - 1) / T::kRB;
  const long long blocks = (long long)groups * ((M + T::kTM - 1) / T::kTM);
  return sxc == 1 && 4 * B >= 3 * T::kRB * groups &&
         2 * blocks >= (long long)T::kHalfWaves * per_sm * sm_count();
}

template <int K>
int launch_xlw_tiled(const float* X, int M, int C, long long sxm,
                     const float* Fo, const float* F, int B, double* part,
                     cudaStream_t stream) {
  using T = XlwCfg<K>;
  if (const int rc = xlw_prepare<K>()) return rc;
  const dim3 grid((B + T::kRB - 1) / T::kRB, (M + T::kTM - 1) / T::kTM);
  kl_x_log_wh_tiled_kernel<K><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      X, M, C, sxm, Fo, F, B, part);
  return (int)cudaGetLastError();
}

// The one-row divergence kernel over `splits` slices of per_split entries
// into part (splits, tiles, B); the wide variant (splits = 1 only) above the
// register buckets.
int launch_xlw_one_row(const float* X, int M, int C, long long sxm,
                       long long sxc, const float* Fo, const float* F, int B,
                       int K, int splits, int per_split, double* part,
                       cudaStream_t stream) {
  const dim3 grid(B, (M + kThreads - 1) / kThreads, splits);
#define XLW_CASE(KK)                                                       \
  case KK:                                                                 \
    if (splits > 1)                                                        \
      kl_x_log_wh_kernel<KK, true><<<grid, kThreads, 0, stream>>>(         \
          X, M, C, sxm, sxc, Fo, F, per_split, part);                      \
    else                                                                   \
      kl_x_log_wh_kernel<KK, false><<<grid, kThreads, 0, stream>>>(        \
          X, M, C, sxm, sxc, Fo, F, per_split, part);                      \
    return (int)cudaGetLastError();
  switch (K) { CNMF_K_BUCKETS(XLW_CASE) }
#undef XLW_CASE
  if (splits != 1 || !cnmf::is_wide_k(K)) return (int)cudaErrorInvalidValue;
  kl_x_log_wh_wide<<<grid, kThreads, 0, stream>>>(X, M, C, sxm, sxc, Fo, F, K,
                                                  part);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiling mu_kl_numerator takes for a launch at K, B and X's strides:
// field 0 the rows a block owns, 1 the restarts it owns, 2 its threads, 3
// how many of its blocks an SM holds at once. 0 for a K that has no kernel,
// or a field that does not exist or cannot be read.
int mu_kl_numerator_tiling(int K, int B, long long sxm, long long sxc,
                           int field) {
  const int layout = tiled_layout(K, B, sxm, sxc);
#define KL_TILING_CASE(KK)                                        \
  case KK:                                                        \
    if (layout != 0)                                              \
      return layout == 1 ? tiled_field<KK, false>(field)          \
                         : tiled_field<KK, true>(field);          \
    break;
  switch (K) { KL_TILED_BUCKETS(KL_TILING_CASE) }
#undef KL_TILING_CASE
  if (field == 0 || field == 2) return kThreads;
  if (field == 1) return 1;
  if (field != 3) return 0;
#define KL_OCC_CASE(KK) \
  case KK:              \
    return blocks_per_sm(kl_numerator_kernel<KK>, kThreads);
  switch (K) { CNMF_K_BUCKETS(KL_OCC_CASE) }
#undef KL_OCC_CASE
  return cnmf::is_wide_k(K) ? blocks_per_sm(kl_numerator_wide, kThreads) : 0;
}

// out (B, M, K) = sum_c X(m, c) / max(F[m] . F_other[c], eps) . F_other[c],
// X(m, c) = X[m * sxm + c * sxc]; F (B, M, K), F_other (B, C, K).
int mu_kl_numerator(const float* X, int M, int C, long long sxm, long long sxc,
                    const float* F_other, const float* F, int B, int K,
                    float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int layout = tiled_layout(K, B, sxm, sxc);
#define KL_TILED_CASE(KK)                                                  \
  case KK:                                                                 \
    if (layout == 1)                                                       \
      return launch_tiled<KK, false>(X, M, C, sxm, sxc, F_other, F, B, out, \
                                     s);                                   \
    if (layout == 2)                                                       \
      return launch_tiled<KK, true>(X, M, C, sxm, sxc, F_other, F, B, out,  \
                                    s);                                    \
    break;
  switch (K) { KL_TILED_BUCKETS(KL_TILED_CASE) }
#undef KL_TILED_CASE
#define MU_CASE(KK)                                                       \
  case KK:                                                                \
    kl_numerator_kernel<KK><<<grid_of(B, M), kThreads, 0, s>>>(           \
        X, M, C, sxm, sxc, F_other, F, out);                              \
    return (int)cudaGetLastError();
  switch (K) { CNMF_K_BUCKETS(MU_CASE) }
#undef MU_CASE
  if (!cnmf::is_wide_k(K)) return (int)cudaErrorInvalidValue;
  kl_numerator_wide<<<grid_of(B, M), kThreads, 0, s>>>(X, M, C, sxm, sxc,
                                                       F_other, F, K, out);
  return (int)cudaGetLastError();
}

// The grid mu_kl_x_log_wh takes for a launch at K, B restarts of M rows and
// X's stride along the contraction: field 0 the rows a block owns (sizing
// the (tiles, B) partials), 1 the restarts it owns, 2 its threads, 3 how
// many of its blocks an SM holds at once (of the one-row kernel: its split
// build's), 4 the entries each slice of a split contraction holds a whole
// number of (0: the kernel does not split). mu_kl_x_log_wh_split runs the
// one-row kernel, whose tiling is that of B = 1. 0 for a K that has no
// kernel, or a field that does not exist or cannot be read.
int mu_kl_x_log_wh_tiling(int K, int B, int M, long long sxc, int field) {
#define XLW_TILING_CASE(KK)                                            \
  case KK:                                                             \
    if (xlw_tiled<KK>(B, M, sxc)) return xlw_tiled_field<KK>(field);   \
    break;
  switch (K) { XLW_TILED_BUCKETS(XLW_TILING_CASE) }
#undef XLW_TILING_CASE
  if (field == 0 || field == 2) return kThreads;
  if (field == 1) return 1;
  if (field == 4) return K <= cnmf::kRegMaxK ? kChunk : 0;
  if (field != 3) return 0;
#define XLW_OCC_CASE(KK) \
  case KK:               \
    return blocks_per_sm(kl_x_log_wh_kernel<KK, true>, kThreads);
  switch (K) { CNMF_K_BUCKETS(XLW_OCC_CASE) }
#undef XLW_OCC_CASE
  return cnmf::is_wide_k(K) ? blocks_per_sm(kl_x_log_wh_wide, kThreads) : 0;
}

// part (tiles, B): per (row tile, restart) the sum over X(m, c) > eps of
// X(m, c) . log(max(F[m] . F_other[c], eps)), rows of a tile and tiles as
// mu_kl_x_log_wh_tiling reports them. The contraction is not split: the
// restart-tiled kernel or one row per thread.
int mu_kl_x_log_wh(const float* X, int M, int C, long long sxm, long long sxc,
                   const float* F_other, const float* F, int B, int K,
                   double* part, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define XLW_TILED_CASE(KK)                                                \
  case KK:                                                                \
    if (xlw_tiled<KK>(B, M, sxc))                                         \
      return launch_xlw_tiled<KK>(X, M, C, sxm, F_other, F, B, part, s);  \
    break;
  switch (K) { XLW_TILED_BUCKETS(XLW_TILED_CASE) }
#undef XLW_TILED_CASE
  return launch_xlw_one_row(X, M, C, sxm, sxc, F_other, F, B, K, 1, C, part,
                            s);
}

// mu_kl_x_log_wh with the contraction split into `splits` >= 2 slices of
// per_split entries (a multiple of 32; the last slice takes the rest), one
// row per thread, K a register bucket (8..64): part (splits, tiles, B).
int mu_kl_x_log_wh_split(const float* X, int M, int C, long long sxm,
                         long long sxc, const float* F_other, const float* F,
                         int B, int K, int splits, int per_split, double* part,
                         void* stream) {
  if (K > cnmf::kRegMaxK || splits < 2 || per_split <= 0 ||
      per_split % kChunk != 0 || (long long)(splits - 1) * per_split >= C ||
      (long long)splits * per_split < C)
    return (int)cudaErrorInvalidValue;
  return launch_xlw_one_row(X, M, C, sxm, sxc, F_other, F, B, K, splits,
                            per_split, part, (cudaStream_t)stream);
}

}  // extern "C"
