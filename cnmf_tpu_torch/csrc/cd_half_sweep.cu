// Fused HALS coordinate-descent half-sweeps for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernels of cnmf_tpu/ops/pallas_cd.py:
//   cd_w_half_sweep (:118, kernel body _make_w_kernel :84)  -> fused kernel, W half
//   cd_h_half_sweep (:162, kernel body _make_h_kernel :97)  -> fused kernel, H half
// Both are built on _column_sweep (:58), which is column_sweep() below. The
// products-given entry point runs the same sweep on a precomputed data product
// (the consensus refits of cnmf_tpu/ops/nmf.py:nnls_cd_from_products).
//
// The fused kernel of the register buckets (K = 8..64) is a tiled f32 GEMM
// with the sweep as its epilogue. For B restarts the data product is one
// GEMM: P (M x B.K) = X (M x C) . [F_other(0) | ... | F_other(B-1)]. One block
// owns a tile of rows (cells for W, genes for Ht) x RB restarts (RB.K product
// columns):
//   1. P = X . F_other - l1 for its tile, in the block's own body, in plain
//      f32 FMA (no tensor cores, no TF32: sklearn parity needs full f32).
//      Each thread keeps an 8-row micro-tile of accumulators; the X and
//      F_other tiles of each 16-entry contraction chunk are staged in a ring
//      of shared-memory slots by cp.async, so the next chunks are in flight
//      while one is multiplied. Every accumulator takes one fmaf per
//      contraction entry, c ascending from 0 and never split, so P has the
//      same bits as a one-row-per-thread loop would give.
//   2. The product tile goes to shared memory; each (row, restart) pair then
//      runs the K sequential column updates on its factor row in registers,
//      with the restart's (K, K) gram in shared memory.
//   3. The new rows, and one violation partial per (row tile, restart),
//      summed in a fixed order. The partials are summed outside with a plain
//      reduction: no atomics, so every run gives the same bits.
// X's strides are arguments: the W half reads X row-major (contraction
// contiguous), the H half transposed (rows contiguous); each stages its tile
// with X's unit stride innermost, 16 bytes a copy where X's pitch is a
// multiple of 4 floats and 4 bytes where it is not.
//
// What bounds it on an H100: the product's f32 FMA rate (2.M.C.K flops per
// restart per half-sweep against 67 TFLOP/s); the sweep is K / C of that.
// A block of one restart would stream every X tile B times and feed each
// staged X value to only K FMAs (at K = 8 such a kernel ran slower than the
// plain PyTorch version). A block of RB restarts feeds each staged X value
// to RB.K FMAs and each staged F_other value to a whole row tile, the
// asynchronous ring keeps the staging's latency off the FMA pipes, and each
// thread works its copy addresses out once, so the main loop is mostly
// FMAs.
//
// The products-given kernel (cd_products_kernel) does no product and keeps
// one restart a block. It is called once a sweep of every CD refit (the
// consensus and k-selection refits, B = 1, M = 1,350-10,000; the cell
// axis's H half, B = 100), so what bounds it is latency, not bytes (3 x
// M x K floats, 0.6 us at M = 10,000, K = 16): each row's K column updates
// are K chained dots and divisions. One launch does the whole call: the
// l2 term goes onto the gram's diagonal as the block stages it, and the
// violation is summed in the launch (sweep_violation: partials of 32 rows,
// then each restart's last block adds them in a fixed order), so the
// wrapper makes no other launch. Where the bucket's tile of rows would leave SMs idle (B = 1:
// 40 blocks at M = 10,000, K = 16) the launch takes one row a thread and,
// if that is still under a wave, one warp a block (products_tiling). A
// row's arithmetic is the same in every tiling.

// Padded rows, contraction columns and K columns are exact no-ops: rows past M
// and contraction entries past C load as 0, and a zero K column has a zero
// gram diagonal and is skipped, as in the Pallas kernel.
//
// K buckets 8..64 (common.cuh). The column loop is unrolled up to K = 32 and
// rolled above it, where a fully unrolled K x K sweep costs minutes of build
// for a loop that is a small share of the run (K / C of the product's work).
//
// Any larger multiple of 8 runs the wide variants (one row per thread, K a
// runtime argument): the fused kernel accumulates P in a (B, M, K) scratch
// that the caller allocates, sweeps the row in the output buffer itself, and
// reads the gram from device memory ((K, K) would not fit beside the staged
// chunks in shared memory at large K: 160 KB at K = 200). The column order
// 0..K-1 and every sum's order are the register kernels', so the results are
// the same bits.

#include <atomic>

#include "common.cuh"

namespace {

using cnmf::kThreads;
using cnmf::ld4;
constexpr int kChunk = 16;  // contraction entries staged per shared-memory round

template <int K>
struct Tile {
  static_assert(K % 8 == 0 && K <= cnmf::kRegMaxK, "K bucket");
  static constexpr int kRows = K >= 32 ? 1 : 32 / K;  // rows owned by a thread
  static constexpr int kTileM = kRows * kThreads;      // rows owned by a block
  static constexpr int kSweepUnroll = K <= 32 ? K : 1;
};

// All K sequential HALS column updates of the thread's R rows, in column order
// 0..K-1 (cnmf_tpu/ops/pallas_cd.py:_column_sweep). gram carries l2 on its
// diagonal, p has l1 subtracted. viol[r]: row r's summed |projected
// gradient| over live columns, column by column. f and p are indexed only by
// the unrolled j, so they stay in registers when the column loop over t is
// rolled; the compares against t fold away where it is unrolled.
template <int K, int R>
__device__ __forceinline__ void column_sweep(float (&f)[R][K],
                                             const float (&p)[R][K],
                                             const float* __restrict__ gram,
                                             float (&viol)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) viol[r] = 0.f;
#pragma unroll(Tile<K>::kSweepUnroll)
  for (int t = 0; t < K; ++t) {
    const float hess = gram[t * K + t];
    const bool live = hess != 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float grad = 0.f, ft = 0.f, pt = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        grad = fmaf(f[r][j], gram[j * K + t], grad);
        if (j == t) {
          ft = f[r][j];
          pt = p[r][j];
        }
      }
      grad -= pt;
      const float pgrad = ft == 0.f ? fminf(grad, 0.f) : grad;
      if (live) {
        viol[r] += fabsf(pgrad);
        const float fnew = fmaxf(ft - grad / hess, 0.f);
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (j == t) f[r][j] = fnew;
      }
    }
  }
}

// gs = gram (K x K, 16-byte aligned), l2 added to its diagonal, staged by
// the block's NT threads.
template <int K, int NT>
__device__ __forceinline__ void load_gram(float* gs,
                                          const float* __restrict__ gram,
                                          float l2) {
  for (int i = threadIdx.x; i < K * K / 4; i += NT) {
    float v[4];
    ld4(v, gram + 4 * i);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((4 * i + e) % (K + 1) == 0) v[e] += l2;
    *reinterpret_cast<float4*>(gs + 4 * i) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// ---- the fused half-sweep of the register buckets ----

// One block owns kTM = 64 rows of RB restarts: a kTM x kTN tile of the data
// product P = X . [F_other(b0) | ... | F_other(b0 + RB - 1)], kTN = RB * K
// columns, so every staged X value feeds RB * K FMAs. Each of its kThreads =
// kTX * kTY threads owns 8 rows x TNT columns of that tile: rows
// 4 * (ty + kTY * i) + {0..3} and columns 4 * (tx + kTX * j) + {0..3}, read
// as float4 from shared memory. The contraction streams through a ring of
// kStages chunk slots.
template <int K_, int RB, int TNT, bool kT>
struct FusedTile {
  static constexpr int K = K_;
  static constexpr int kRB = RB, kTNt = TNT, kTY = 8, kStages = 3;
  static constexpr int kTMt = 8;
  static constexpr int kTM = kTY * kTMt;
  static constexpr int kTN = RB * K;
  static constexpr int kTX = kTN / TNT;
  static constexpr int kThreads = kTX * kTY;
  // Shared memory, in floats: a ring of kStages slots, each an X tile and an
  // F_other tile [chunk][kTN]. The X tile keeps X's unit-stride axis
  // innermost: [chunk][kTM] for the H half (kT), [kTM][chunk + 4] for the W
  // half, padded so that the float4 reads of neighbouring row groups fall on
  // other banks. Once the ring is drained, the product tile [kTM][kTN + 4]
  // takes its place. Then the RB grams and the violation of every row.
  static constexpr int kXPitch = kT ? kTM : kChunk + 4;
  static constexpr int kXFloats = kT ? kChunk * kTM : kTM * kXPitch;
  static constexpr int kSlotFloats = kXFloats + kChunk * kTN;
  static constexpr int kPPitch = kTN + 4;
  static constexpr int kRingFloats = kStages * kSlotFloats > kTM * kPPitch
                                         ? kStages * kSlotFloats
                                         : kTM * kPPitch;
  static constexpr int kSmemBytes =
      sizeof(float) * (kRingFloats + RB * K * K + RB * kTM);
  static_assert(K % 8 == 0 && K <= cnmf::kRegMaxK, "K bucket");
  static_assert(kTN % TNT == 0 && TNT % 4 == 0, "float4 columns");
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
};

// The tiling of each K bucket, for both halves: restarts per block and
// product columns per thread. Each bucket takes the tiling that was fastest
// for its two halves together among those timed on an H100 at B = 100,
// N = 2700, G = 2000: 64 product columns at K = 8 and 16; 2 restarts with
// 8 x 4 accumulators a thread at 24..40; 8 x 8 at 48..64.
template <int K, bool kT>
struct FusedCfg;
#define CD_FUSED_CFG(KK, RB, TNT) \
  template <bool kT>              \
  struct FusedCfg<KK, kT> : FusedTile<KK, RB, TNT, kT> {};
CD_FUSED_CFG(8, 8, 4)
CD_FUSED_CFG(16, 4, 4)
CD_FUSED_CFG(24, 2, 4)
CD_FUSED_CFG(32, 2, 4)
CD_FUSED_CFG(40, 2, 4)
CD_FUSED_CFG(48, 2, 8)
CD_FUSED_CFG(56, 4, 8)
CD_FUSED_CFG(64, 2, 8)
#undef CD_FUSED_CFG

// grid (restart groups, row tiles); X element (m, c) at X[m * sxm + c * sxc]
// with sxc = 1 (the W half) or, for kT, sxm = 1 (the H half).
template <int K, bool kT>
__global__ void __launch_bounds__(FusedCfg<K, kT>::kThreads)
cd_fused_kernel(const float* __restrict__ X, int M, int C, long long sxm,
                long long sxc, const float* __restrict__ Fo,
                const float* __restrict__ F, const float* __restrict__ gram,
                float l1, int B, float* __restrict__ Fout,
                float* __restrict__ viol_part) {
  using T = FusedCfg<K, kT>;
  constexpr int TM = T::kTM, TN = T::kTN, RB = T::kRB, NT = T::kThreads;
  constexpr int TMt = T::kTMt, TNt = T::kTNt, TX = T::kTX, TY = T::kTY;
  constexpr int S = T::kStages;
  extern __shared__ __align__(16) float smem[];
  float* const gs = smem + T::kRingFloats;
  float* const vs = gs + RB * K * K;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int b0 = blockIdx.x * RB, m0 = blockIdx.y * TM;
  const int nb = min(RB, B - b0);  // the block's live restarts
  for (int i = tid; i < nb * K * K; i += NT)
    gs[i] = gram[(size_t)b0 * K * K + i];

  // Chunk q of the contraction into ring slot `slot`: X's tile along its
  // unit stride, and the RB F_other tiles, rows of K floats; zero past M, C
  // and B. Copy unit j of a thread is unit tid + j * NT of the tile, so every
  // address is the thread's first one plus a step fixed for the launch: the
  // addresses are worked out once here, and a chunk only moves them on.
  // X's tile moves in 16-byte units where X's pitch is a multiple of 4
  // floats (vec); else each entry is a 4-byte copy.
  constexpr int XOUT = kT ? kChunk : TM;          // tile rows ...
  constexpr int XU = (kT ? TM : kChunk) / 4;      // ... of XU 16-byte units
  constexpr int XSTEP = NT / XU;                  // rows between a thread's units
  constexpr int XN = (XOUT * XU + NT - 1) / NT;   // units per thread
  constexpr int FU = TN / 4;                      // F_other: units per entry
  constexpr int FSTEP = NT / FU;                  // entries between a thread's units
  constexpr int FN = kChunk * FU / NT;            // units per thread
  static_assert(NT % XU == 0 && NT % FU == 0 && kChunk * FU % NT == 0,
                "copy units");
  const long long xpitch = kT ? sxc : sxm;        // X's stride between tile rows
  const bool vec = xpitch % 4 == 0;
  const int xo = tid / XU, xi = tid % XU * 4;     // the thread's first X unit
  const float* const x0 =
      X + (kT ? m0 + xi + xo * xpitch : (m0 + xo) * xpitch + xi);
  const long long xjump = XSTEP * xpitch, xchunk = kT ? kChunk * sxc : kChunk;
  // live entries of a unit along the rows of the block (the H half's units
  // run along them; the W half's tile rows are its rows)
  const int xlive = kT ? min(max(M - m0 - xi, 0), 4) : M - m0;
  const int fc = tid / FU, fn = tid % FU * 4;     // the thread's first F_other unit
  const bool flive = fn / K < nb;
  const float* const f0 =
      flive ? Fo + ((size_t)(b0 + fn / K) * C + fc) * K + fn % K : Fo;
  auto stage = [&](int slot, int q) {
    float* const xs = smem + slot * T::kSlotFloats;
    float* const fs = xs + T::kXFloats;
    const int rem = C - q * kChunk;  // contraction entries from this chunk on
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
      cnmf::stage_tile_async4<kChunk, TM, TM, NT>(
          xs, X + (C - rem) * sxc + m0, sxc, rem, M - m0);
    } else {
      cnmf::stage_tile_async4<TM, kChunk, T::kXPitch, NT>(
          xs, X + m0 * sxm + (C - rem), sxm, M - m0, rem);
    }
    const float* const fq = f0 + (size_t)q * kChunk * K;
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int c = fc + j * FSTEP;
      const bool ok = flive && c < rem;
      cnmf::cp_async16(fs + c * TN + fn, ok ? fq + j * FSTEP * K : Fo,
                       ok ? 16 : 0);
    }
  };

  // P = X . F_other: one fmaf per contraction entry and accumulator, c
  // ascending from 0 and never split, so P has the same bits whatever the
  // tiling. Chunk q + S - 1 is in flight while chunk q is multiplied.
  float acc[TMt][TNt];
#pragma unroll
  for (int i = 0; i < TMt; ++i)
#pragma unroll
    for (int j = 0; j < TNt; ++j) acc[i][j] = 0.f;

  const int nq = (C + kChunk - 1) / kChunk;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nq) stage(s, s);
    cnmf::cp_async_commit();
  }
  for (int q = 0; q < nq; ++q) {
    cnmf::cp_async_wait<S - 2>();
    __syncthreads();  // chunk q has landed, and slot (q - 1) % S is consumed
    if (q + S - 1 < nq) stage((q + S - 1) % S, q + S - 1);
    cnmf::cp_async_commit();
    const float* xs = smem + (q % S) * T::kSlotFloats;
    const float* fs = xs + T::kXFloats;
    if constexpr (kT) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float a[TMt], f[TNt];
#pragma unroll
        for (int i = 0; i < TMt; i += 4)
          ld4(a + i, xs + c * TM + 4 * (ty + TY * (i / 4)));
#pragma unroll
        for (int j = 0; j < TNt; j += 4)
          ld4(f + j, fs + c * TN + 4 * (tx + TX * (j / 4)));
#pragma unroll
        for (int i = 0; i < TMt; ++i)
#pragma unroll
          for (int j = 0; j < TNt; ++j) acc[i][j] = fmaf(a[i], f[j], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int c4 = 0; c4 < kChunk; c4 += 4) {
        float a[TMt][4];
#pragma unroll
        for (int i = 0; i < TMt; ++i)
          ld4(a[i], xs + (4 * (ty + TY * (i / 4)) + i % 4) * T::kXPitch + c4);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float f[TNt];
#pragma unroll
          for (int j = 0; j < TNt; j += 4)
            ld4(f + j, fs + (c4 + cc) * TN + 4 * (tx + TX * (j / 4)));
#pragma unroll
          for (int i = 0; i < TMt; ++i)
#pragma unroll
            for (int j = 0; j < TNt; ++j)
              acc[i][j] = fmaf(a[i][cc], f[j], acc[i][j]);
        }
      }
    }
  }
  cnmf::cp_async_wait<0>();
  __syncthreads();  // the ring is drained: it becomes the product tile

  float* const ps = smem;
#pragma unroll
  for (int i = 0; i < TMt; ++i) {
    const int r = 4 * (ty + TY * (i / 4)) + i % 4;
#pragma unroll
    for (int j = 0; j < TNt; j += 4)
      *reinterpret_cast<float4*>(ps + r * T::kPPitch + 4 * (tx + TX * (j / 4))) =
          make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  }
  __syncthreads();

  // The sweep, one (row, restart) pair at a time, each row by column_sweep
  // as the products-given kernel runs it.
  for (int pr = tid; pr < nb * TM; pr += NT) {
    const int rb = pr / TM, r = pr % TM, m = m0 + r;
    if (m >= M) {
      vs[pr] = 0.f;
      continue;
    }
    float p[1][K], f[1][K];
    const size_t off = ((size_t)(b0 + rb) * M + m) * K;
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      ld4(&p[0][k], ps + r * T::kPPitch + rb * K + k);
      ld4(&f[0][k], F + off + k);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) p[0][k] -= l1;
    float v[1];
    column_sweep<K, 1>(f, p, gs + rb * K * K, v);
    vs[pr] = v[0];
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<float4*>(Fout + off + k) =
          make_float4(f[0][k], f[0][k + 1], f[0][k + 2], f[0][k + 3]);
  }
  __syncthreads();

  // One violation partial per (row tile, restart): the rows' violations
  // summed in a fixed order by one warp.
  for (int rb = tid / 32; rb < nb; rb += NT / 32) {
    float s = 0.f;
    for (int r = tid % 32; r < TM; r += 32) s += vs[rb * TM + r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (tid % 32 == 0) viol_part[(size_t)blockIdx.y * B + b0 + rb] = s;
  }
}

// ---- the products-given sweep ----

// Rows of one violation partial: a warp's, summed by warp_tree.
constexpr int kSegRows = 32;

// The sum of x over the warp's 32 lanes, lane i adding lane i + o for o =
// 16, 8, 4, 2, 1 (a shuffle-down tree), in lane 0.
__device__ __forceinline__ float warp_tree(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// The violation of a products-given launch, in one pass of its blocks. vs
// holds the violations of the block's TM rows m0.. (0 past M). Warp w sums
// the block's segments w, w + NT / 32, ... of kSegRows rows, each by
// warp_tree, into seg_part (B, nseg), nseg = ceil(M / kSegRows). The block
// then takes its restart's ticket; the last of the restart's blocks sums
// its nseg partials (lane l adds the partials l, l + 32, ... in order, then
// warp_tree adds the lanes) into viol[b], and sets the ticket back to 0 for
// the next launch on its stream, so the restarts' sums run in parallel.
// The order depends on M alone, not on the tiling or on which block
// finishes last: no float atomics, the same bits every run and at every B.
template <int TM, int NT>
__device__ __forceinline__ void sweep_violation(const float* vs, int m0, int M,
                                                float* __restrict__ seg_part,
                                                unsigned* __restrict__ tickets,
                                                float* __restrict__ viol) {
  __shared__ bool last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x;
  const int nseg = (M + kSegRows - 1) / kSegRows;
  for (int s = warp; s < TM / kSegRows; s += NT / 32) {
    const float x = warp_tree(vs[s * kSegRows + lane]);
    const int seg = m0 / kSegRows + s;
    if (lane == 0 && seg < nseg) seg_part[(size_t)b * nseg + seg] = x;
  }
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + b, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last || warp != 0) return;
  __threadfence();
  const float* part = seg_part + (size_t)b * nseg;
  float x = 0.f;
  int i = lane;
  // eight loads in flight (3,125 partials at M = 100,000), added in order
  for (; i + 7 * 32 < nseg; i += 8 * 32) {
    float p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) p[u] = __ldcg(part + i + u * 32);
#pragma unroll
    for (int u = 0; u < 8; ++u) x += p[u];
  }
  for (; i < nseg; i += 32) x += __ldcg(part + i);
  x = warp_tree(x);
  if (lane == 0) {
    viol[b] = x;
    tickets[b] = 0u;
  }
}

// The sweep on a precomputed product P (B, M, K): R rows a thread (row m0 +
// threadIdx.x + r * NT), NT threads a block; gram (B, K, K) without l2,
// which is added as the block stages it. grid (B, ceil(M / (R * NT))).
template <int K, int R, int NT>
__global__ void __launch_bounds__(NT)
cd_products_kernel(const float* __restrict__ P, int M,
                   const float* __restrict__ F, const float* __restrict__ gram,
                   float l1, float l2, float* __restrict__ Fout,
                   float* __restrict__ seg_part, unsigned* __restrict__ tickets,
                   float* __restrict__ viol) {
  static_assert(R == 1 || NT == kThreads, "load_rows: rows kThreads apart");
  constexpr int TM = R * NT;
  __shared__ __align__(16) float gs[K * K];
  __shared__ float vs[TM];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * TM;
  load_gram<K, NT>(gs, gram + (size_t)b * K * K, l2);

  const size_t off = (size_t)b * M * K;
  float p[R][K];
  cnmf::load_rows<K, R>(p, P + off, m0, M);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool valid = m0 + threadIdx.x + r * NT < M;
#pragma unroll
    for (int k = 0; k < K; ++k) p[r][k] = valid ? p[r][k] - l1 : 0.f;
  }
  float f[R][K];
  cnmf::load_rows<K, R>(f, F + off, m0, M);
  __syncthreads();
  float v[R];
  column_sweep<K, R>(f, p, gs, v);
  cnmf::store_rows<K, R>(Fout + off, f, m0, M);
#pragma unroll
  for (int r = 0; r < R; ++r) vs[threadIdx.x + r * NT] = v[r];
  __syncthreads();
  sweep_violation<TM, NT>(vs, m0, M, seg_part, tickets, viol);
}

// column_sweep() on a row f (updated in place) and its product p (l1 not yet
// subtracted), both in device memory, with the gram read from device memory
// and l2 added to its diagonal.
__device__ __forceinline__ float column_sweep_wide(float* __restrict__ f,
                                                   const float* __restrict__ p,
                                                   const float* __restrict__ gram,
                                                   float l1, float l2, int K) {
  float viol = 0.f;
  for (int t = 0; t < K; ++t) {
    const float hess = __ldg(gram + t * K + t) + l2;
    float grad = 0.f;
    for (int j = 0; j < K; ++j)
      grad = fmaf(f[j], j == t ? hess : __ldg(gram + j * K + t), grad);
    const float ft = f[t];
    grad -= p[t] - l1;
    const float pgrad = ft == 0.f ? fminf(grad, 0.f) : grad;
    if (hess != 0.f) {
      viol += fabsf(pgrad);
      f[t] = fmaxf(ft - grad / hess, 0.f);
    }
  }
  return viol;
}

// cd_fused_kernel for K above the register buckets: P accumulates in
// P_scratch (B, M, K), the row is swept in Fout.
__global__ void __launch_bounds__(kThreads)
cd_fused_wide(const float* __restrict__ X, int M, int C, long long sxm,
              long long sxc, const float* __restrict__ Fo,
              const float* __restrict__ F, const float* __restrict__ gram,
              float l1, int K, float* __restrict__ Fout,
              float* __restrict__ P_scratch, float* __restrict__ viol_part) {
  __shared__ float xs[kChunk][kThreads + 1];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kThreads;
  const int row = m0 + threadIdx.x;
  const bool live = row < M;
  const float* fo = Fo + (size_t)b * C * K;
  const size_t off = ((size_t)b * M + row) * K;
  float* p = P_scratch + off;
  if (live)
    for (int k = 0; k < K; ++k) p[k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    cnmf::stage_x<kThreads, kChunk>(xs, X, M, C, sxm, sxc, m0, c0);
    __syncthreads();
    if (!live) continue;
    float xv[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) xv[c] = xs[c][threadIdx.x];
    cnmf::wide_accumulate<kChunk>(p, xv, fo + (size_t)c0 * K, K,
                                  min(kChunk, C - c0));
  }
  float v = 0.f;
  if (live) {
    float* f = Fout + off;
    for (int k = 0; k < K; ++k) f[k] = F[off + k];
    v = column_sweep_wide(f, p, gram + (size_t)b * K * K, l1, 0.f, K);
  }
  cnmf::block_sum_to(v, viol_part + (size_t)blockIdx.y * gridDim.x + b);
}

// cd_products_kernel for K above the register buckets, one row a thread.
__global__ void __launch_bounds__(kThreads)
cd_products_wide(const float* __restrict__ P, int M,
                 const float* __restrict__ F, const float* __restrict__ gram,
                 float l1, float l2, int K, float* __restrict__ Fout,
                 float* __restrict__ seg_part, unsigned* __restrict__ tickets,
                 float* __restrict__ viol) {
  __shared__ float vs[kThreads];
  const int b = blockIdx.x;
  const int m0 = blockIdx.y * kThreads;
  const int row = m0 + threadIdx.x;
  float v = 0.f;
  if (row < M) {
    const size_t off = ((size_t)b * M + row) * K;
    float* f = Fout + off;
    for (int k = 0; k < K; ++k) f[k] = F[off + k];
    v = column_sweep_wide(f, P + off, gram + (size_t)b * K * K, l1, l2, K);
  }
  vs[threadIdx.x] = v;
  __syncthreads();
  sweep_violation<kThreads, kThreads>(vs, m0, M, seg_part, tickets,
                                      viol);
}

dim3 wide_grid(int B, int M) { return dim3(B, (M + kThreads - 1) / kThreads); }

// Lifts the fused kernel's dynamic shared memory limit to its tile's need
// (above the default 48 KB at the larger buckets), once per device; returns
// the CUDA error of that call, at every launch.
template <int K, bool kT>
int fused_prepare() {
  constexpr int kDevices = 64;
  static std::atomic<int> done[kDevices];  // 0: not yet set, else error + 1
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  int rc = done[dev].load(std::memory_order_acquire);
  if (rc == 0) {
    rc = 1 + (int)cudaFuncSetAttribute(
                 cd_fused_kernel<K, kT>,
                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                 FusedCfg<K, kT>::kSmemBytes);
    done[dev].store(rc, std::memory_order_release);
  }
  return rc - 1;
}

template <int K, bool kT>
int launch_fused(const float* X, int M, int C, long long sxm, long long sxc,
                 const float* Fo, const float* F, const float* gram, float l1,
                 int B, float* Fout, float* viol_part, cudaStream_t stream) {
  using T = FusedCfg<K, kT>;
  if (const int rc = fused_prepare<K, kT>()) return rc;
  const dim3 grid((B + T::kRB - 1) / T::kRB, (M + T::kTM - 1) / T::kTM);
  cd_fused_kernel<K, kT><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      X, M, C, sxm, sxc, Fo, F, gram, l1, B, Fout, viol_part);
  return (int)cudaGetLastError();
}

// Field 0 rows a block owns, 1 restarts, 2 threads, 3 blocks an SM holds at
// once (0 where that cannot be read).
template <int K, bool kT>
int fused_tiling(int field) {
  using T = FusedCfg<K, kT>;
  int n = 0;
  switch (field) {
    case 0:
      return T::kTM;
    case 1:
      return T::kRB;
    case 2:
      return T::kThreads;
    case 3:
      if (fused_prepare<K, kT>() != 0 ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, cd_fused_kernel<K, kT>, T::kThreads, T::kSmemBytes) !=
              cudaSuccess) {
        cudaGetLastError();  // leave no error for the next launch to report
        return 0;
      }
      return n;
  }
  return 0;
}

// The tiling of a products-given launch at bucket K for B restarts of M
// rows: 0 the bucket's Tile rows a thread and kThreads threads where that
// grid fills a wave (a block on each SM), else 1 row a thread of kThreads
// where that does, else 1 row a thread of 32. Each row's sweep runs the same
// arithmetic in every tiling, so the factor keeps its bits; fewer rows a
// block put the refits' B = 1 grids on more SMs (K = 16: 40 blocks at
// M = 10,000 with the bucket's tile, 313 with one warp's rows).
template <int K>
int products_tiling(int B, int M) {
  constexpr int R = Tile<K>::kRows;
  const long long sms = cnmf::sm_count();
  const auto blocks = [&](int rows) {
    return (long long)B * ((M + rows - 1) / rows);
  };
  if (blocks(R * kThreads) >= sms) return 0;
  return blocks(kThreads) >= sms ? 1 : 2;
}

// Rows a block owns in tiling t of products_tiling.
template <int K>
int products_rows(int t) {
  return t == 0 ? Tile<K>::kRows * kThreads : t == 1 ? kThreads : 32;
}

// Blocks of tiling t an SM holds at once; 0 where that cannot be read.
template <int K>
int products_per_sm(int t) {
  if (t == 0)
    return cnmf::blocks_per_sm(cd_products_kernel<K, Tile<K>::kRows, kThreads>,
                               kThreads);
  if (t == 1)
    return cnmf::blocks_per_sm(cd_products_kernel<K, 1, kThreads>, kThreads);
  return cnmf::blocks_per_sm(cd_products_kernel<K, 1, 32>, 32);
}

template <int K>
int launch_products(const float* P, int M, const float* F, const float* gram,
                    float l1, float l2, int B, float* Fout, float* seg_part,
                    unsigned* tickets, float* viol, cudaStream_t stream) {
  constexpr int R = Tile<K>::kRows;
  const int t = products_tiling<K>(B, M);
  const int rows = products_rows<K>(t);
  const dim3 grid(B, (M + rows - 1) / rows);
  if (t == 0)
    cd_products_kernel<K, R, kThreads><<<grid, kThreads, 0, stream>>>(
        P, M, F, gram, l1, l2, Fout, seg_part, tickets, viol);
  else if (t == 1)
    cd_products_kernel<K, 1, kThreads><<<grid, kThreads, 0, stream>>>(
        P, M, F, gram, l1, l2, Fout, seg_part, tickets, viol);
  else
    cd_products_kernel<K, 1, 32><<<grid, 32, 0, stream>>>(
        P, M, F, gram, l1, l2, Fout, seg_part, tickets, viol);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tiling of a products-given launch at K for B restarts of M rows: field
// 0 the rows a block owns, 1 the restarts it owns (1), 2 its threads, 3 how
// many of its blocks an SM holds at once. 0 for a K that has no kernel, or
// a field that does not exist or cannot be read.
int cd_products_tiling(int K, int B, int M, int field) {
  int t = -1, rows = kThreads, threads = kThreads, per_sm = 0;
#define CD_CASE(KK)                                              \
  case KK:                                                       \
    t = products_tiling<KK>(B, M);                               \
    rows = products_rows<KK>(t);                                 \
    threads = t == 2 ? 32 : kThreads;                            \
    if (field == 3) per_sm = products_per_sm<KK>(t);             \
    break;
  switch (K) { CNMF_K_BUCKETS(CD_CASE) }
#undef CD_CASE
  if (t < 0) {
    if (!cnmf::is_wide_k(K)) return 0;
    if (field == 3) per_sm = cnmf::blocks_per_sm(cd_products_wide, kThreads);
  }
  switch (field) {
    case 0:
      return rows;
    case 1:
      return 1;
    case 2:
      return threads;
    case 3:
      return per_sm;
  }
  return 0;
}

// The fused half-sweep's tiling at K, for X read row-major (transposed = 0,
// the W half) or transposed (1, the H half): field 0 the rows a block owns
// (sizes the (tiles, B) violation partials), 1 the restarts it owns, 2 its
// threads, 3 how many of its blocks an SM holds at once. A wide K: one row
// per thread of one restart. 0 for a K that has no kernel, or a field that
// does not exist or cannot be read.
int cd_fused_tiling(int K, int transposed, int field) {
#define CD_CASE(KK)                                 \
  case KK:                                          \
    return transposed ? fused_tiling<KK, true>(field) \
                      : fused_tiling<KK, false>(field);
  switch (K) { CNMF_K_BUCKETS(CD_CASE) }
#undef CD_CASE
  if (!cnmf::is_wide_k(K)) return 0;
  int n = 0;
  switch (field) {
    case 0:
    case 2:
      return kThreads;
    case 1:
      return 1;
    case 3:
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, cd_fused_wide,
                                                        kThreads, 0) !=
          cudaSuccess) {
        cudaGetLastError();
        return 0;
      }
      return n;
  }
  return 0;
}

// One fused half-sweep. F (B, M, K) is updated against F_other (B, C, K) and
// X (M x C in element (m, c) = X[m * sxm + c * sxc]); gram (B, K, K) carries
// l2 on its diagonal. Writes Fout (B, M, K) and viol_part (tiles, B), tiles
// = ceil(M / rows of cd_fused_tiling). The register buckets read X along a
// unit stride: sxc = 1 (the W half) or sxm = 1 (the H half). P_scratch
// (B, M, K) is used for a wide K only (may be null otherwise).
int cd_half_sweep_fused(const float* X, int M, int C, long long sxm,
                        long long sxc, const float* F_other, const float* F,
                        const float* gram, float l1, int B, int K, float* Fout,
                        float* viol_part, float* P_scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define CD_CASE(KK)                                                        \
  case KK:                                                                 \
    if (sxc == 1)                                                          \
      return launch_fused<KK, false>(X, M, C, sxm, sxc, F_other, F, gram,  \
                                     l1, B, Fout, viol_part, s);           \
    if (sxm == 1)                                                          \
      return launch_fused<KK, true>(X, M, C, sxm, sxc, F_other, F, gram,   \
                                    l1, B, Fout, viol_part, s);            \
    return (int)cudaErrorInvalidValue;
  switch (K) { CNMF_K_BUCKETS(CD_CASE) }
#undef CD_CASE
  if (!cnmf::is_wide_k(K) || P_scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cd_fused_wide<<<wide_grid(B, M), kThreads, 0, s>>>(
      X, M, C, sxm, sxc, F_other, F, gram, l1, K, Fout, P_scratch, viol_part);
  return (int)cudaGetLastError();
}

// One half-sweep from a precomputed product P (B, M, K) in one launch: gram
// (B, K, K) without l2 (added to its diagonal in the kernel), Fout (B, M, K),
// viol (B,) the summed |projected gradient| of each restart. seg_part: B x
// ceil(M / 32) floats of scratch; tickets: B counters that are 0 before the
// launch and after it (the caller zeroes them once; launches that share
// them go on one stream).
int cd_half_sweep_products(const float* P, int M, const float* F,
                           const float* gram, float l1, float l2, int B, int K,
                           float* Fout, float* seg_part, unsigned* tickets,
                           float* viol, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define CD_CASE(KK)                                                         \
  case KK:                                                                  \
    return launch_products<KK>(P, M, F, gram, l1, l2, B, Fout, seg_part,    \
                               tickets, viol, s);
  switch (K) { CNMF_K_BUCKETS(CD_CASE) }
#undef CD_CASE
  if (!cnmf::is_wide_k(K)) return (int)cudaErrorInvalidValue;
  cd_products_wide<<<wide_grid(B, M), kThreads, 0, s>>>(
      P, M, F, gram, l1, l2, K, Fout, seg_part, tickets, viol);
  return (int)cudaGetLastError();
}

}  // extern "C"
